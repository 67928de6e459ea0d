"""Checkpoint save/restore and the weight carry-across between the packages.

Port of ``nvfi_tpu/train/checkpoint.py`` in numpy + json: arrays go into
``path.npz`` (the pytree flattened to path-keyed entries under ``params/``,
``opt/`` and ``alpha/``) and the static ``KPlaneMeta`` into a ``path.json``
sidecar.  The layouts are the JAX package's (channels-last planes under
``planes_space`` / ``planes_time``, ``{'w': (in, out), 'b'}`` linears), so
either package reads the other's checkpoints.

``params_from_numpy`` turns a param tree of numpy arrays (a JAX param pytree
after ``np.asarray``, or a loaded checkpoint) into the port's params on a
device (``static_params_from_numpy``: the same for a static TensoRF tree,
VM or CP, whose layout it checks); ``params_to_numpy`` is the way back.
``alpha_state_from_numpy`` and
``alpha_state_to_numpy`` do the same for an alpha mask (``volume``, ``aabb``,
``dilated``), so a mask built by either package prunes the other's renders
(the port's cell ``bits`` and ``occupied`` bits are rebuilt on the way in
and never saved);
``opt_state_from_numpy`` and ``opt_state_to_numpy`` for the Adam state
(``m``, ``v``, ``step``), so a run started in either package resumes in the
other.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

import numpy as np
import torch

from ..device import resolve_device
from ..fields.kplane import KPlaneMeta, map_params
from ..fields.velocity import VelGate
from ..ops import occupancy


def params_from_numpy(tree, device):
    """Param tree of arrays -> the same tree of float tensors on ``device``."""
    dev = resolve_device(device)
    return map_params(lambda x: torch.as_tensor(np.array(x)).to(dev), tree)


STATIC_KEYS = {"VM": {"density_plane", "density_line", "app_plane", "app_line", "basis_mat",
                      "shader"},
               "CP": {"density_line", "app_line", "basis_mat", "shader"}}


def static_params_from_numpy(tree, device):
    """A static TensoRF param tree of arrays (a JAX ``tensorf_vm`` tree after
    ``np.asarray``, VM or CP) -> the port's tree on ``device``
    (:func:`params_from_numpy`); a tree of another layout is refused."""
    if set(tree) not in STATIC_KEYS.values():
        raise ValueError(f"static_params_from_numpy: keys {sorted(tree)} are neither the VM "
                         f"nor the CP layout")
    return params_from_numpy(tree, device)


def params_to_numpy(params):
    """Port params -> the same tree of numpy arrays (on the host)."""
    return map_params(lambda x: x.detach().cpu().numpy(), params)


DERIVED_ALPHA_KEYS = ("bits", "occupied")  # built on the way in, never saved


def alpha_state_from_numpy(state, device):
    """Alpha mask of arrays -> contiguous float32 tensors on ``device``, with
    the volume's cell bits (``ops.occupancy.occupancy_bits``) and, where the
    mask has a ``dilated`` volume, its occupied bits
    (``ops.occupancy.occupied_bits``) built anew."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev).contiguous()
           for k, v in state.items() if k not in DERIVED_ALPHA_KEYS}
    out["bits"] = occupancy.occupancy_bits(out["volume"])
    if "dilated" in out:
        out["occupied"] = occupancy.occupied_bits(out["dilated"])
    return out


def alpha_state_to_numpy(alpha_state):
    """Alpha mask of tensors -> numpy arrays (on the host), without the
    derived bits."""
    return {k: v.detach().cpu().numpy() for k, v in alpha_state.items()
            if k not in DERIVED_ALPHA_KEYS}


def opt_state_from_numpy(state, device):
    """Adam state of arrays (``m`` and ``v`` mirror the params, ``step`` a
    scalar) -> ``train.optim``'s state on ``device``."""
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device), "step": int(state["step"])}


def opt_state_to_numpy(opt_state):
    """Adam state -> numpy arrays in the JAX package's layout (int32 step)."""
    return {"m": params_to_numpy(opt_state["m"]), "v": params_to_numpy(opt_state["v"]),
            "step": np.asarray(opt_state["step"], np.int32)}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "__none"] = np.zeros((0,))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root = {}
    for key, value in flat.items():
        if key.endswith("__none"):
            parts = key[: -len("__none")].rstrip("/").split("/") if key != "__none" else []
            node_val = None
        else:
            parts = key.split("/")
            node_val = value
        if not parts:
            return node_val
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = node_val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def meta_to_json(meta: KPlaneMeta) -> dict:
    d = dataclasses.asdict(meta)
    d["vel_gate"] = {"mode": meta.vel_gate.mode, "eps": meta.vel_gate.eps,
                     "bounds": meta.vel_gate.bounds, "world": meta.vel_gate.world}
    return d


def meta_from_json(d: dict) -> KPlaneMeta:
    d = dict(d)
    g = d.pop("vel_gate")
    gate = VelGate(
        g["mode"], g["eps"],
        tuple(tuple(b) for b in g["bounds"]) if g["bounds"] else (),
        tuple(tuple(b) for b in g.get("world", ())) if g.get("world") else (),
    )

    def tupleize(x):
        if isinstance(x, list):
            return tuple(tupleize(v) for v in x)
        return x

    d = {k: tupleize(v) for k, v in d.items()}
    return KPlaneMeta(vel_gate=gate, **d)


def save(path: str, params, meta: KPlaneMeta, opt_state=None, alpha_state=None,
         extra: dict | None = None):
    """Write ``path.npz`` (arrays) + ``path.json`` (static metadata)."""
    arrays = {"params/" + k: v for k, v in _flatten(params_to_numpy(params)).items()}
    if opt_state is not None:
        arrays.update({"opt/" + k: v
                       for k, v in _flatten(opt_state_to_numpy(opt_state)).items()})
    if alpha_state is not None:
        arrays.update({"alpha/" + k: v
                       for k, v in _flatten(alpha_state_to_numpy(alpha_state)).items()})
    np.savez(path + ".npz", **arrays)
    sidecar = {"meta": meta_to_json(meta), "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)


def load(path: str, device="cuda"):
    """Returns (params on ``device``, meta, opt_state|None, alpha_state|None,
    extra); the alpha mask and the optimizer state come as tensors on
    ``device``."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    meta = meta_from_json(sidecar["meta"])
    groups = {"params": {}, "opt": {}, "alpha": {}}
    with np.load(path + ".npz") as data:
        for k in data.files:
            head, _, rest = k.partition("/")
            groups[head][rest] = data[k]
    params = params_from_numpy(_unflatten(groups["params"]), device)
    opt_state = (opt_state_from_numpy(_unflatten(groups["opt"]), device)
                 if groups["opt"] else None)
    alpha_state = (alpha_state_from_numpy(_unflatten(groups["alpha"]), device)
                   if groups["alpha"] else None)
    return params, meta, opt_state, alpha_state, sidecar.get("extra", {})


def find_checkpoint(logdir: str, step: int = -1) -> str | None:
    """Pick a numbered checkpoint of ``logdir``, or its latest when ``step``
    is negative or missing (then with a warning)."""
    ckpts = sorted(glob.glob(os.path.join(logdir, "model_*.json")))
    if not ckpts:
        return None
    if step >= 0:
        want = os.path.join(logdir, f"model_{step:05d}.json")
        if want in ckpts:
            return want[: -len(".json")]
        print(f"[checkpoint] step {step} not found, using latest")
    return ckpts[-1][: -len(".json")]

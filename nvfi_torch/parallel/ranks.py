"""Rank functions for :func:`parallel.launch.launch`: a trainer on a mesh,
stepped one iteration at a time, and what a caller compares of it.

Each takes a picklable description (a config as a plain dict, a dataset
tuple of numpy arrays, numpy params, recorded draws) and returns host
values, so that a caller in another process (a test that holds the port
against JAX, ``chip_smoke.py`` that holds ranks on one card against one
process) can check the run.  Only rank 0 returns params and gradients, which
every rank holds alike (with channel-sharded planes gathered whole first);
every rank returns the fingerprints of its own params after each step
(``parallel.mesh.digest``: its plane slice on a model axis) and its own draws.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import CfgNode
from ..fields import kplane
from ..ops import counters
from ..render.renderer import render_image
from ..train import checkpoint
from ..train.trainer import Trainer, TrainDraws
from . import mesh as parallel_mesh
from .launch import to_host
from .multi_scene import MultiSceneTrainer


def draws_to_host(draws: TrainDraws) -> dict:
    return {f.name: to_host(getattr(draws, f.name)) for f in dataclasses.fields(draws)}


def draws_from_host(d: dict, device) -> TrainDraws:
    return TrainDraws(**{k: (torch.as_tensor(v).to(device) if isinstance(v, np.ndarray) else v)
                         for k, v in d.items()})


class ReplayDraws:
    """``draws(step, meta, hp[, scene])`` from recorded draws: ``steps[step]``
    (a draws dict), ``steps[step][rank]`` given a ``rank``, or
    ``steps[step][scene]`` for a multi-scene trainer."""

    def __init__(self, steps: list, device, rank: int | None = None):
        self.steps, self.device, self.rank = steps, device, rank

    def __call__(self, step, meta, hp, scene=None):
        d = self.steps[step]
        if self.rank is not None:
            d = d[self.rank]
        if scene is not None:
            d = d[scene]
        return draws_from_host(d, self.device)


def host_copy(tree):
    """A numpy copy of a param tree (the port updates its params in place,
    and a CPU tensor's ``numpy()`` shares its memory)."""
    return kplane.map_params(lambda x: x.detach().cpu().numpy().copy(), tree)


def train_trainer(mesh, cfg: dict, dataset, spec: dict) -> dict:
    """A :class:`train.trainer.Trainer` on ``mesh`` (or one process with
    ``mesh`` None, on ``spec["device"]``), stepped ``spec["iters"]`` times
    one iteration at a time.

    Each iteration is timed, the device synchronized on both sides
    (``step_seconds``, its stage events included).

    ``spec``: ``mode`` (static_dynamic), ``spmd`` (auto), ``seed`` (the
    config's), ``params`` (a numpy param tree to start from, whole planes),
    ``draws`` (recorded draws by step, by rank for ``shard_map``),
    ``record`` (the steps whose params before the step, draws, frames and
    reduced gradients come back), ``all_grads`` (every step's reduced
    gradients), ``save`` (a path: every rank calls ``Trainer.save`` after
    the steps, rank 0 writes), ``val`` (``rays_o``, ``rays_d`` (H, W, 3),
    ``t``, ``white_bg``: a ``val_fn`` that renders them every
    ``validate_every``).  Returns ``losses`` and ``metrics`` by step,
    ``digests`` (the params' fingerprint after each step), ``recorded``
    {step: ...}, ``grads``, the final ``params`` and ``meta``, the
    ``events``, the ``val`` renders (it, rgb) this rank made, this rank's
    channel ``shard`` (lo, hi) or None, the
    fingerprint of its params but the planes (``replicated_digest``), and
    its ``peak_memory`` on a card (bytes)."""
    device = mesh.device if mesh is not None else torch.device(spec["device"])
    tr = Trainer(CfgNode(cfg), dataset, mode=spec.get("mode", "static_dynamic"), mesh=mesh,
                 seed=spec.get("seed"), spmd=spec.get("spmd", "auto"), device=device)
    if spec.get("params") is not None:
        tr.place_params(checkpoint.params_from_numpy(spec["params"], device))
    if spec.get("draws") is not None:
        tr._draws = ReplayDraws(spec["draws"], device,
                                mesh.rank if spec.get("spmd") == "shard_map" else None)
    heavy = mesh is None or mesh.is_main
    record = spec.get("record", ())
    grads = []

    def keep(tree):  # whole planes: a collective on every rank of the model axis
        tree = tr.whole(tree)
        return host_copy(tree) if heavy else None

    tr.grad_hook = lambda g: grads.append(keep(g))
    val_fn, renders = None, []
    if spec.get("val") is not None:
        v = spec["val"]

        def val_fn(trainer, it):
            out = render_image(trainer.params, trainer.meta, v["t"], v["rays_o"], v["rays_d"],
                               white_bg=v["white_bg"], chunk=v["rays_o"].shape[0]
                               * v["rays_o"].shape[1], device=device)
            renders.append((it, out["rgb"]))
    out = {"losses": [], "metrics": [], "digests": [], "recorded": {}, "step_seconds": []}
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda _: None
    for it in range(spec["iters"]):
        before = keep(tr.params) if it in record else None
        sync(device)
        t0 = time.perf_counter()
        metrics = tr.train(iters=it + 1, val_fn=val_fn)
        sync(device)
        out["step_seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(metrics["loss"]))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["digests"].append(parallel_mesh.digest(tr.params))
        if it in record:
            out["recorded"][it] = {"before": before, "grads": grads[-1],
                                   "draws": draws_to_host(tr.last_draws),
                                   "frames": tr.last_frames}
    if spec.get("save"):
        tr.save(spec["save"], tr.opt_state)
    out["grads"] = grads if heavy and spec.get("all_grads") else None
    out["params"] = keep(tr.params)
    out["meta"] = dataclasses.asdict(tr.meta)
    out["events"] = tr.events
    out["val"] = renders
    out["shard"] = None if tr.shard is None else (tr.shard.lo, tr.shard.hi)
    out["replicated_digest"] = parallel_mesh.digest(
        {k: v for k, v in tr.params.items() if k not in parallel_mesh.PLANE_KEYS})
    out["peak_memory"] = (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None)
    return out


def train_multi_scene(mesh, cfg: dict, datasets: list, spec: dict) -> dict:
    """A :class:`parallel.multi_scene.MultiSceneTrainer` on ``mesh`` (or one
    process with ``mesh`` None), stepped ``spec["iters"]`` times one
    iteration at a time.

    ``spec``: ``mode``, ``seed`` (0), ``aabbs``, ``state`` (JAX-layout
    stacked params and Adam state to start from, numpy), ``draws``
    (recorded draws by step and scene).  Returns ``losses`` (S,) by step,
    the final ``meta``, ``events``, ``counters`` (S,) each, and this rank's
    ``scenes``, their ``params`` (numpy, stacked) and ``alpha`` masks, and
    every read of the exactness counters (``counter_reads``)."""
    device = mesh.device if mesh is not None else spec["device"]
    tr = MultiSceneTrainer(CfgNode(cfg), datasets, mesh=mesh, mode=spec.get("mode",
                                                                            "static_dynamic"),
                           seed=spec.get("seed", 0), aabbs=spec.get("aabbs"), device=device)
    if spec.get("state") is not None:
        tr.assign_state(*checkpoint.multi_scene_state_from_numpy(*spec["state"], device))
    if spec.get("draws") is not None:
        tr._draws = ReplayDraws(spec["draws"], device)
    losses, metrics = [], []
    for it in range(spec["iters"]):
        m = tr.train(iters=it + 1)
        losses.append(m["loss"])
        metrics.append(m)
    alpha = None
    if tr.alpha_states is not None:
        alpha = [checkpoint.alpha_state_to_numpy(tr.scene_alpha_state(i)) for i in tr.scenes]
    counters = tr.check_counters("end")
    return {"losses": np.stack(losses), "metrics": metrics,
            "meta": dataclasses.asdict(tr.meta), "events": tr.events, "counters": counters,
            "counter_reads": tr.counter_reads, "scenes": list(tr.scenes),
            "params": host_copy(tr.params), "alpha": alpha}


JOBS = {"trainer": train_trainer, "multi_scene": train_multi_scene}


def run_jobs(mesh, jobs: list) -> dict:
    """Several runs in one launch (each rank process reaches its device once):
    ``jobs`` = [(name, kind, args[, "data"])], kind a key of ``JOBS``; a job
    marked "data" runs on the data axis alone, on the ranks of model index 0
    (``mesh.sub("data")``: the ``('data',)`` mesh of a launch without a model
    axis), and the other ranks skip it (result None).  The launch counters
    are set to 0 before each run and read after it.  Returns {name:
    {"result", "launches", "seconds"}}."""
    out = {}
    for name, kind, args, *axis in jobs:
        job_mesh = mesh.sub("data") if axis == ["data"] else mesh
        # every rank starts the run together (a skipped run ends at once)
        parallel_mesh.all_reduce(mesh, [torch.zeros(1, device=mesh.device)])
        counters.reset_counts()
        if axis == ["data"] and mesh.model_size > 1 and mesh.index("model") != 0:
            out[name] = {"result": None, "launches": counters.read_counts(), "seconds": 0.0}
            continue
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        result = JOBS[kind](job_mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out[name] = {"result": result, "launches": counters.read_counts(),
                     "seconds": time.perf_counter() - t0}
    return out

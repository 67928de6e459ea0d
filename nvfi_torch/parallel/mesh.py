"""The data axis over ``torch.distributed`` ranks (port of
``nvfi_tpu/parallel/mesh.py``).

JAX drives every chip from one process and places arrays on a ``Mesh``; here
each rank is a process of its own (``parallel.launch`` starts them) and a
:class:`Mesh` names this rank's place on the one ``('data',)`` axis: the
process group, the rank, the world size and the rank's device.  Params are
replicated (:func:`replicate` broadcasts rank 0's), ray batches split on the
leading axis (:func:`shard_rays`), and the gradient sum that XLA inserts is an
explicit ``all_reduce`` (:func:`all_reduce`).  The collectives used are
``all_reduce`` and ``broadcast`` only, the two that a ``gloo`` group also
runs on CUDA tensors.

The ``('data', 'model')`` mesh of the JAX package (channel-sharded planes,
``shard_scene_params`` with a model axis > 1) is not ported: it needs
collectives inside the field lookup and its backward; :func:`make_mesh` and
the trainers refuse it, naming ROADMAP.md A10.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS_REFUSAL = ("the mesh's 'model' axis (tensor parallelism: channel-sharded planes, "
                      "collectives in the field lookup and its backward) is not ported yet "
                      "(ROADMAP.md A10)")


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh.  ``group`` None is the default group."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = ("data",)
    axis_sizes: tuple | None = None  # None: (size,)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes or (self.size,)))

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs and checkpoints."""
        return self.rank == 0


def refuse_model_axis(mesh: Mesh | None, where: str):
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(f"{where}: {MODEL_AXIS_REFUSAL}")


def make_mesh(n_devices: int | None = None, model_axis: int = 1, device=None) -> Mesh:
    """The ``('data',)`` mesh over the initialized default process group.

    ``n_devices`` must be the world size (or None): one rank a device.
    ``device`` is this rank's device: by default ``cuda:<rank>`` in an
    ``nccl`` group, the CPU in a ``gloo`` group."""
    if model_axis > 1:
        raise NotImplementedError(f"make_mesh(model_axis={model_axis}): {MODEL_AXIS_REFUSAL}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (start the ranks with "
                           "nvfi_torch.parallel.launch)")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, {size} ranks in the group")
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(None, rank, size, torch.device(device))


def tree_tensors(tree) -> list:
    """The tensor leaves of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _in_one_buffer(tensors, collective):
    """``collective(buffer)`` on the tensors flattened into one buffer a
    dtype, in place, the result copied back into each."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce(mesh: Mesh, tensors: list, op: str = "sum") -> list:
    """Reduce every tensor over the ranks, in place, in one collective a
    dtype.  ``op``: sum, max or min."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                 "min": dist.ReduceOp.MIN}[op]
    _in_one_buffer([t for t in tensors if t is not None],
                   lambda flat: dist.all_reduce(flat, op=reduce_op, group=mesh.group))
    return tensors


def reduce_values(mesh: Mesh | None, values, op: str) -> np.ndarray:
    """Host numbers reduced over the ranks (float64; exact for min and max)."""
    arr = np.asarray(values, dtype=np.float64)
    if mesh is None:
        return arr
    t = torch.as_tensor(arr, device=mesh.device).reshape(-1).clone()
    all_reduce(mesh, [t], op)
    return t.cpu().numpy().reshape(arr.shape)


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every tensor leaf of ``tree`` on every rank (in
    place; one broadcast a dtype).  Returns ``tree``."""
    _in_one_buffer(tree_tensors(tree),
                   lambda flat: dist.broadcast(flat, src=0, group=mesh.group))
    return tree


def shard_rays(mesh: Mesh, tree):
    """This rank's slice of the leading (ray) axis of every tensor leaf:
    rows ``[rank * n / D, (rank + 1) * n / D)``; n must divide by D."""
    def cut(x):
        if not isinstance(x, torch.Tensor):
            return x
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"shard_rays: {n} rows do not divide over {mesh.size} ranks")
        k = n // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    if isinstance(tree, dict):
        return {k: shard_rays(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_rays(mesh, v) for v in tree]
    return cut(tree)


def shard_scene_params(mesh: Mesh, params: dict) -> dict:
    """Placement of a scene's params: replicated on a ``('data',)`` mesh, as
    in JAX; a model axis (channel-sharded planes) is refused."""
    refuse_model_axis(mesh, "shard_scene_params")
    return replicate(mesh, params)


def digest(tree) -> int:
    """A fingerprint of every bit of a tree's tensor leaves: their bytes' CRC."""
    crc = 0
    for t in tree_tensors(tree):
        crc = zlib.crc32(t.detach().contiguous().cpu().numpy().tobytes(), crc)
    return crc


def check_replicated(mesh: Mesh | None, tree, what: str, extra=()):
    """Raise unless every rank holds the same bits in every tensor leaf of
    ``tree`` (and the same host values ``extra``, e.g. a meta's repr): the
    fingerprints' min and max over the ranks must agree."""
    if mesh is None or mesh.size == 1:
        return
    prints = [digest(t) for t in tree_tensors(tree)]
    prints += [zlib.crc32(repr(v).encode()) for v in extra]
    lo, hi = reduce_values(mesh, prints, "min"), reduce_values(mesh, prints, "max")
    differ = np.nonzero(lo != hi)[0]
    if len(differ):
        raise RuntimeError(f"{what}: the ranks hold different values in {len(differ)} of "
                           f"{len(prints)} entries (first at {int(differ[0])})")

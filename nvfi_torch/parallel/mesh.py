"""The ``('data',)`` and ``('data', 'model')`` meshes over
``torch.distributed`` ranks (port of ``nvfi_tpu/parallel/mesh.py``).

JAX drives every chip from one process and places arrays on a ``Mesh``; here
each rank is a process of its own (``parallel.launch`` starts them) and a
:class:`Mesh` names this rank's place on the mesh: the process group, the
rank, the world size, the rank's device and, on a 2-D mesh, the process group
of each axis.  Params are replicated (:func:`replicate` broadcasts rank 0's),
ray batches split on the leading axis (:func:`shard_rays`), and the sums that
XLA inserts are explicit ``all_reduce`` calls (:func:`all_reduce`, over the
whole mesh or over one named axis).

A ``('data', 'model')`` mesh (:func:`make_mesh` with ``model_axis`` M > 1:
rank r at data index ``r // M`` and model index ``r % M``, as JAX reshapes
its devices) shards the merged planes' channels over the model axis
(:func:`shard_scene_params`: model rank m holds channels
``[m C / M, (m + 1) C / M)`` of every plane where M divides C, the whole
plane where it does not); the field lookup sums its channel partials over
the model axis (``fields.kplane.ChannelShard``).  :func:`gather_planes` puts
the whole planes back together for saves and checks.  The collectives used
are ``all_reduce`` and ``broadcast`` only, the two that a ``gloo`` group also
runs on CUDA tensors.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

PLANE_KEYS = ("planes_space", "planes_time")


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh.  ``group`` None is the default group;
    on a 2-D mesh ``axis_groups`` holds this rank's line along each axis (its
    column of the data axis, its row of the model axis)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = ("data",)
    axis_sizes: tuple | None = None  # None: (size,)
    axis_groups: tuple | None = None  # None: the whole group is the one axis

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes or (self.size,)))

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs and checkpoints."""
        return self.rank == 0

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis``: on a (D, M) mesh data ``rank // M``,
        model ``rank % M``."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r}: {self.axis_names}")
        return self.rank % self.model_size if axis == "model" else self.rank // self.model_size

    def sub(self, axis: str) -> "Mesh":
        """The 1-D mesh of this rank's line along ``axis``: that line's group,
        this rank's index on it as the rank, the axis size as the size."""
        if self.axis_names == (axis,):
            return self
        i = self.axis_names.index(axis)
        return Mesh(self.axis_groups[i], self.index(axis), self.axis_sizes[i], self.device,
                    (axis,))


def make_mesh(n_devices: int | None = None, model_axis: int = 1, device=None) -> Mesh:
    """The ``('data',)`` mesh or, with ``model_axis`` M > 1, the ``('data',
    'model')`` mesh of shape (n / M, M) over the initialized default process
    group.

    ``n_devices`` must be the world size (or None): one rank a device.
    ``device`` is this rank's device: by default ``cuda:<rank>`` in an
    ``nccl`` group, the CPU in a ``gloo`` group.  Every rank calls this
    alike: the axis groups are made with ``dist.new_group``, each group on
    every rank and in one order (a rank that skipped one would hang the
    others)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (start the ranks with "
                           "nvfi_torch.parallel.launch)")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, {size} ranks in the group")
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if model_axis <= 1:
        return Mesh(None, rank, size, device)
    assert size % model_axis == 0, f"{size} ranks do not divide by model_axis {model_axis}"
    n_data = size // model_axis
    data_group = model_group = None
    for m in range(model_axis):  # the data axis: a column a model index
        group = dist.new_group([d * model_axis + m for d in range(n_data)])
        if m == rank % model_axis:
            data_group = group
    for d in range(n_data):  # the model axis: a row a data index
        group = dist.new_group([d * model_axis + m for m in range(model_axis)])
        if d == rank // model_axis:
            model_group = group
    return Mesh(None, rank, size, device, ("data", "model"), (n_data, model_axis),
                (data_group, model_group))


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


def all_reduce(mesh: Mesh, tensors: list, op: str = "sum", axis: str | None = None) -> list:
    """Reduce every tensor over the ranks (``axis``: over this rank's line
    along that axis only), in place, in one collective a dtype.  ``op``:
    sum, max or min."""
    if axis is not None:
        mesh = mesh.sub(axis)
    if mesh.size == 1:
        return tensors
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                 "min": dist.ReduceOp.MIN}[op]
    _in_one_buffer([t for t in tensors if t is not None],
                   lambda flat: dist.all_reduce(flat, op=reduce_op, group=mesh.group))
    return tensors


def reduce_values(mesh: Mesh | None, values, op: str, axis: str | None = None) -> np.ndarray:
    """Host numbers reduced over the ranks (or one axis; float64, exact for
    min and max)."""
    arr = np.asarray(values, dtype=np.float64)
    if mesh is None:
        return arr
    t = torch.as_tensor(arr, device=mesh.device).reshape(-1).clone()
    all_reduce(mesh, [t], op, axis)
    return t.cpu().numpy().reshape(arr.shape)


def replicate(mesh: Mesh, tree):
    """Rank 0's values (of the mesh's group) in every tensor leaf of ``tree``
    on every rank (in place; one broadcast a dtype).  Returns ``tree``."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    _in_one_buffer(tree_tensors(tree),
                   lambda flat: dist.broadcast(flat, src=src, group=mesh.group))
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


def channel_slice(mesh: Mesh | None, channels: int) -> tuple | None:
    """(lo, hi): the channels of the merged planes that this rank holds on the
    model axis, or None where the planes are whole (no model axis, or one
    that does not divide ``channels``: JAX then replicates them)."""
    m = 1 if mesh is None else mesh.model_size
    if m == 1 or channels % m:
        return None
    width = channels // m
    i = mesh.index("model")
    return i * width, (i + 1) * width


def slice_planes(tree: dict, lo: int, hi: int) -> dict:
    """A param-shaped tree with channels ``[lo, hi)`` of each (whole) plane,
    as fresh contiguous tensors; the other leaves are the same objects."""
    def cut(p):
        return p[..., lo:hi].detach().clone(memory_format=torch.contiguous_format)

    return {k: [cut(p) for p in v] if k in PLANE_KEYS else v for k, v in tree.items()}


def shard_scene_params(mesh: Mesh, params: dict) -> dict:
    """Placement of a scene's params (JAX ``shard_scene_params``): rank 0's
    values replicated, then on a model axis each rank keeps its channel
    slice of every merged plane (:func:`channel_slice`); the other leaves,
    and planes whose channels do not divide the axis, stay whole."""
    params = replicate(mesh, params)
    cut = channel_slice(mesh, params["planes_space"][0].shape[-1])
    return params if cut is None else slice_planes(params, *cut)


def gather_planes(mesh: Mesh, tree: dict, channels: int) -> dict:
    """A param-shaped tree (params, grads or Adam moments) with whole planes
    on every rank of the model axis: each rank writes its slice into a
    zero-filled (..., ``channels``) buffer and one sum over the model axis
    fills the rest (exact: every channel has one non-zero term).  The other
    leaves are the same objects.  Without channel-sharded planes the tree
    itself."""
    cut = channel_slice(mesh, channels)
    if cut is None:
        return tree
    lo, hi = cut
    whole = {}
    for key in PLANE_KEYS:
        planes = []
        for p in tree[key]:
            buf = p.new_zeros(*p.shape[:-1], channels)
            buf[..., lo:hi] = p.detach()
            planes.append(buf)
        whole[key] = planes
    all_reduce(mesh, [p for key in PLANE_KEYS for p in whole[key]], axis="model")
    return {k: whole.get(k, v) for k, v in tree.items()}


def digest(tree) -> int:
    """A fingerprint of every bit of a tree's tensor leaves: their bytes' CRC."""
    crc = 0
    for t in tree_tensors(tree):
        crc = zlib.crc32(t.detach().contiguous().cpu().numpy().tobytes(), crc)
    return crc


def check_replicated(mesh: Mesh | None, tree, what: str, extra=(), axis: str | None = None):
    """Raise unless every rank (or every rank of this rank's line along
    ``axis``) holds the same bits in every tensor leaf of ``tree`` (and the
    same host values ``extra``, e.g. a meta's repr): the fingerprints' min
    and max over the ranks must agree."""
    if mesh is None or mesh.size == 1:
        return
    prints = [digest(t) for t in tree_tensors(tree)]
    prints += [zlib.crc32(repr(v).encode()) for v in extra]
    lo = reduce_values(mesh, prints, "min", axis)
    hi = reduce_values(mesh, prints, "max", axis)
    differ = np.nonzero(lo != hi)[0]
    if len(differ):
        raise RuntimeError(f"{what}: the ranks hold different values in {len(differ)} of "
                           f"{len(prints)} entries (first at {int(differ[0])})")

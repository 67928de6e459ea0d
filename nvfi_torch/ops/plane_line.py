"""The static TensoRF lookup: plane x line (VM) and line x line x line (CP)
features (kernels K6, K6d and K6b).

Port of the lookup in ``nvfi_tpu/fields/tensorf_vm.py``: ``density_feature``
(:119-134) and ``app_feature`` (:137-151) before the basis matmul, on
``grid_sample_2d`` / ``grid_sample_1d`` (corner-validity zeros padding).
For mode i, (m0, m1) = ``MAT_SPACE[i]`` and ``VEC_MODE[i]`` = 2 - i:

* VM: ``f_i = grid_sample_2d(plane_i, (x[m0], x[m1])) * grid_sample_1d(line_i,
  x[VEC_MODE[i]])``; the density feature is the sum of f_i over the three
  modes and the Cd density channels, the app features the three Ca-channel
  products concatenated, (P, 3 Ca);
* CP: ``f = s_0 * s_1 * s_2``, ``s_i = grid_sample_1d(line_i, x[VEC_MODE[i]])``;
  density the channel sum of the density lines' f, app the app lines' f,
  (P, Ca).

Planes are (gs[m1], gs[m0], C), lines (gs[VEC_MODE[i]], C), channels last.
``plane_line`` (K6, both outputs) and ``plane_line_density`` (K6d, the
density alone: the mask build) are the wrappers of ``csrc/plane_line.cu``;
the gradient of ``plane_line`` with respect to the planes and lines is K6b
(``csrc/plane_line_bwd.cu``, wrapper ``plane_line_backward``), reached
through a ``torch.autograd.Function``.  The coords take no gradient there.
``plane_line_reference`` and ``plane_line_backward_reference`` are the plain
PyTorch versions, which the wrappers run for CPU tensors only.  Each wrapper
counts the launches of its two arms apart: ``launches`` (VM) and
``launches_cp``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import kernels
from .grid_sample import MAT_SPACE, grid_sample_1d, grid_sample_2d

VEC_MODE = (2, 1, 0)  # the line of mode i lies along axis VEC_MODE[i]
PLANE_LINE_THREADS = 256  # csrc/plane_line.cuh kFwdThreads / kBwdThreads
PLANE_LINE_RUN = 64  # samples a block of K6 / K6d
PLANE_LINE_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block, without opting in
PLANE_LINE_BWD_CHUNK = 24  # the most channels a block of K6b sums line grads for
PLANE_LINE_BWD_BLOCKS_PER_SM = 4  # K6b's blocks: about this many a multiprocessor
PLANE_LINE_BWD_MIN_RUN = 256


def plane_line_reference(density_planes, density_lines, app_planes, app_lines,
                         xyz: torch.Tensor, density_only: bool = False):
    """Plain version of K6 (and, with ``density_only``, of K6d).

    Args:
      density_planes, app_planes: three planes each (VM), or None (CP).
      density_lines, app_lines: three lines each; the app ones may be None
        with ``density_only``.
      xyz: (P, 3) normalized coords.
    Returns:
      density feature (P,) and app features (P, 3 Ca) (VM) or (P, Ca) (CP);
      with ``density_only`` the density alone.
    """
    def field(planes, lines):
        if planes is None:
            prod = None
            for i in range(3):
                s = grid_sample_1d(lines[i], xyz[..., VEC_MODE[i]])
                prod = s if prod is None else prod * s
            return [prod]
        feats = []
        for i in range(3):
            m0, m1 = MAT_SPACE[i]
            p = grid_sample_2d(planes[i], torch.stack([xyz[..., m0], xyz[..., m1]], -1))
            feats.append(p * grid_sample_1d(lines[i], xyz[..., VEC_MODE[i]]))
        return feats

    total = None
    for f in field(density_planes, density_lines):
        contrib = torch.sum(f, dim=-1)
        total = contrib if total is None else total + contrib
    if density_only:
        return total
    return total, torch.cat(field(app_planes, app_lines), dim=-1)


def plane_line_backward_reference(density_planes, density_lines, app_planes, app_lines,
                                  xyz: torch.Tensor, g_density, g_app):
    """Plain version of K6b: ``torch.autograd.grad`` through
    :func:`plane_line_reference`.  Returns the grads in the order of the
    inputs: density planes, density lines, app planes, app lines (three
    each; the planes' None in the CP arm)."""
    with torch.enable_grad():
        leaves = [[p.detach().requires_grad_(True) for p in group] if group is not None
                  else None for group in (density_planes, density_lines, app_planes, app_lines)]
        density, app = plane_line_reference(*leaves, xyz.detach())
        flat = [p for group in leaves if group is not None for p in group]
        grads = torch.autograd.grad([density, app], flat, [g_density, g_app])
    out, i = [], 0
    for group in leaves:
        if group is None:
            out.append(None)
        else:
            out.append(list(grads[i:i + 3]))
            i += 3
    return out


# ---------------------------------------------------------------------------
# checks and launch plans
# ---------------------------------------------------------------------------

def grid_of(density_planes, density_lines) -> tuple:
    """The grid (gs[0], gs[1], gs[2]) of a field from its lines: line i lies
    along axis VEC_MODE[i]."""
    return tuple(int(density_lines[VEC_MODE.index(a)].shape[0]) for a in range(3))


def _check_tensor(name, x, dev, ndim):
    if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != ndim:
        raise ValueError(f"plane_line: {name} must be a contiguous float32 {ndim}-d tensor on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_args(density_planes, density_lines, app_planes, app_lines, xyz, density_only):
    """Shapes, dtype, device and layout of the inputs; returns (Cd, Ca) (Ca 0
    with ``density_only``)."""
    dev = xyz.device
    if xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError(f"plane_line: xyz must be (P, 3), got {tuple(xyz.shape)}")
    _check_tensor("xyz", xyz, dev, 2)
    if len(density_lines) != 3 or (density_planes is not None and len(density_planes) != 3):
        raise ValueError("plane_line: three planes (VM) and three lines a kind")
    gs = grid_of(density_planes, density_lines)
    kinds = [("density", density_planes, density_lines)]
    if not density_only:
        if (app_planes is None) != (density_planes is None) or app_lines is None:
            raise ValueError("plane_line: the app planes and lines must match the arm of the "
                             "density ones")
        kinds.append(("app", app_planes, app_lines))
    channels = []
    for kind, planes, lines in kinds:
        C = int(lines[0].shape[-1])
        for i in range(3):
            _check_tensor(f"{kind} line {i}", lines[i], dev, 2)
            if tuple(lines[i].shape) != (gs[VEC_MODE[i]], C):
                raise ValueError(f"plane_line: {kind} line {i} is {tuple(lines[i].shape)}, want "
                                 f"{(gs[VEC_MODE[i]], C)}")
            if planes is not None:
                m0, m1 = MAT_SPACE[i]
                _check_tensor(f"{kind} plane {i}", planes[i], dev, 3)
                if tuple(planes[i].shape) != (gs[m1], gs[m0], C):
                    raise ValueError(f"plane_line: {kind} plane {i} is "
                                     f"{tuple(planes[i].shape)}, want {(gs[m1], gs[m0], C)}")
        if C < 1 or any(x.numel() >= 2**31 for x in list(lines) + list(planes or [])):
            raise ValueError("plane_line: every plane and line must hold fewer than 2^31 values "
                             "and C >= 1")
        channels.append(C)
    return channels[0], channels[1] if len(channels) > 1 else 0


@dataclass(frozen=True)
class PlaneLinePlan:
    """How K6 / K6d are launched: ``vec`` channels a work item (4: the
    16-byte path; else 1), ``run`` samples a block, ``smem_bytes`` of dynamic
    shared memory a block."""
    vec: int
    run: int
    smem_bytes: int


def _vec(channels, ptrs) -> int:
    return 4 if all(c % 4 == 0 for c in channels) and all(int(p) % 16 == 0 for p in ptrs) \
        else 1


def plane_line_plan(Cd: int, Ca: int, cp: bool, density_only: bool, ptrs) -> PlaneLinePlan:
    """The launch plan of K6 (or K6d with ``density_only``) from the shapes
    and addresses alone.  ``ptrs``: the addresses read or written 16 bytes at
    a time (the planes and lines read, the app output).  Shared memory a
    block: the run's coords (12 B a sample) and each density slot's channel
    sum (4 B a mode and group); ``run`` halves from 64 until it fits."""
    vec = _vec([Cd] + ([] if density_only else [Ca]), ptrs)
    per_sample = 12 + 4 * (1 if cp else 3) * (Cd // vec)
    run = PLANE_LINE_RUN
    while run * per_sample > PLANE_LINE_SMEM_LIMIT and run > 1:
        run //= 2
    if run * per_sample > PLANE_LINE_SMEM_LIMIT:
        raise ValueError(f"plane_line: Cd = {Cd} needs more than {PLANE_LINE_SMEM_LIMIT} B of "
                         "shared memory a sample")
    return PlaneLinePlan(vec=vec, run=run, smem_bytes=run * per_sample)


@dataclass(frozen=True)
class PlaneLineBwdPlan:
    """How K6b is launched: ``vec`` channels a work item, ``run`` samples a
    block, ``chunk`` channels of one kind a block (``d_chunks`` density and
    ``a_chunks`` app chunks: the grid's second axis), ``smem_bytes`` of
    dynamic shared memory a block (the three lines' rows x ``chunk``)."""
    vec: int
    run: int
    chunk: int
    d_chunks: int
    a_chunks: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def multiprocessors(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plane_line_bwd_plan(P: int, Cd: int, Ca: int, line_rows: int, ptrs,
                        n_sm: int) -> PlaneLineBwdPlan:
    """The launch plan of K6b from the shapes, the addresses (``ptrs``: the
    planes, lines, grads and g_app the 16-byte path touches) and the card's
    ``n_sm`` multiprocessors.  ``line_rows``: the rows of the three lines
    together.  ``chunk`` is the widest multiple of ``vec`` up to 24 channels
    whose line sums fit in 48 KB; the samples are cut into runs so that the
    grid holds about four blocks a multiprocessor."""
    vec = _vec([Cd, Ca], ptrs)
    chunk = PLANE_LINE_BWD_CHUNK // vec * vec
    while chunk > vec and line_rows * chunk * 4 > PLANE_LINE_SMEM_LIMIT:
        chunk -= vec
    if line_rows * chunk * 4 > PLANE_LINE_SMEM_LIMIT:
        raise ValueError(f"plane_line_backward: lines of {line_rows} rows together need more "
                         f"than {PLANE_LINE_SMEM_LIMIT} B of shared memory")
    d_chunks, a_chunks = -(-Cd // chunk), -(-Ca // chunk)
    runs = max(1, -(-PLANE_LINE_BWD_BLOCKS_PER_SM * n_sm // (d_chunks + a_chunks)))
    run = max(PLANE_LINE_BWD_MIN_RUN, -(-P // runs))
    return PlaneLineBwdPlan(vec=vec, run=run, chunk=chunk, d_chunks=d_chunks, a_chunks=a_chunks,
                            smem_bytes=line_rows * chunk * 4)


def _flat_inputs(density_planes, density_lines, app_planes, app_lines):
    """The 12 pointers (null where absent) and the 9 dims of the C entries."""
    groups = (density_planes, density_lines, app_planes, app_lines)
    ptrs = [(t.data_ptr() if group is not None and t is not None else 0)
            for group in groups for t in (group if group is not None else [None] * 3)]
    gs = grid_of(density_planes, density_lines)
    if density_planes is None:
        hw = [0] * 6
    else:
        hw = [gs[m1] for _, m1 in MAT_SPACE] + [gs[m0] for m0, _ in MAT_SPACE]
    dims = hw + [gs[VEC_MODE[i]] for i in range(3)]
    return (ctypes.c_void_p * 12)(*ptrs), (ctypes.c_int * 9)(*dims)


def _count(wrapper, cp: bool):
    if cp:
        wrapper.launches_cp += 1
    else:
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# K6 / K6d
# ---------------------------------------------------------------------------

def launch_plane_line(density_planes, density_lines, app_planes, app_lines, xyz, density,
                      app, density_only):
    """Launch K6 (K6d with ``density_only``) into ``density`` (and ``app``) on
    arguments :func:`_check_args` has checked, and count the launch on its
    wrapper.  No host read-back: the kernel alone, as a CUDA graph captures
    it."""
    P = xyz.shape[0]
    if P == 0:
        return
    cp = density_planes is None
    Cd = int(density_lines[0].shape[-1])
    Ca = 0 if density_only else int(app_lines[0].shape[-1])
    read = [t for group in (density_planes, density_lines) + (
        () if density_only else (app_planes, app_lines)) if group is not None for t in group]
    plan = plane_line_plan(Cd, Ca, cp, density_only,
                           [t.data_ptr() for t in read] + ([] if density_only
                                                           else [app.data_ptr()]))
    ptrs, dims = _flat_inputs(density_planes, density_lines,
                              None if density_only else app_planes,
                              None if density_only else app_lines)
    lib = kernels.load()
    with torch.cuda.device(xyz.device):
        err = lib.nvfi_plane_line_fwd(ptrs, dims, xyz.data_ptr(), P, Cd, Ca, plan.vec, plan.run,
                                      plan.smem_bytes, int(cp), int(density_only),
                                      density.data_ptr(), 0 if density_only else app.data_ptr(),
                                      kernels.stream_ptr(xyz.device))
    kernels.check(err, "plane_line_fwd")
    _count(plane_line_density if density_only else plane_line, cp)


def _forward(density_planes, density_lines, app_planes, app_lines, xyz, density_only):
    if xyz.device.type != "cuda":
        raise ValueError(f"plane_line: unsupported device {xyz.device}")
    _, Ca = _check_args(density_planes, density_lines, app_planes, app_lines, xyz,
                        density_only)
    P = xyz.shape[0]
    density = torch.empty(P, dtype=torch.float32, device=xyz.device)
    app = None
    if not density_only:
        width = Ca if density_planes is None else 3 * Ca
        app = torch.empty(P, width, dtype=torch.float32, device=xyz.device)
    launch_plane_line(density_planes, density_lines, app_planes, app_lines, xyz, density, app,
                      density_only)
    return density, app


def _groups(cp, tensors):
    """(density planes, density lines, app planes, app lines) from the flat
    tensor list of :class:`_PlaneLine`."""
    if cp:
        return None, list(tensors[:3]), None, list(tensors[3:6])
    return list(tensors[:3]), list(tensors[3:6]), list(tensors[6:9]), list(tensors[9:12])


class _PlaneLine(torch.autograd.Function):
    """K6 forward, K6b backward.  The backward recomputes the lookup from
    ``xyz`` and the inputs, so the forward saves only those."""

    @staticmethod
    def forward(ctx, xyz, cp, *tensors):
        groups = _groups(cp, tensors)
        density, app = _forward(*groups, xyz, density_only=False)
        ctx.save_for_backward(xyz, *tensors)
        ctx.cp = cp
        ctx.set_materialize_grads(False)
        return density, app

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_density, g_app):
        xyz, *tensors = ctx.saved_tensors
        groups = _groups(ctx.cp, tensors)
        P = xyz.shape[0]
        if g_density is None:
            g_density = xyz.new_zeros(P)
        if g_app is None:
            width = groups[3][0].shape[-1] * (1 if ctx.cp else 3)
            g_app = xyz.new_zeros(P, width)
        grads = plane_line_backward(*groups, xyz, g_density.contiguous(), g_app.contiguous())
        flat = [g for group in grads if group is not None for g in group]
        return (None, None, *flat)


def plane_line(density_planes, density_lines, app_planes, app_lines, xyz: torch.Tensor):
    """K6: density feature (P,) and app features ((P, 3 Ca) VM, (P, Ca) CP)
    of the static field at (P, 3) normalized coords.  CP: planes None.

    For CPU tensors this runs :func:`plane_line_reference` under ordinary
    autograd.  For CUDA tensors it launches ``nvfi_plane_line_fwd``
    (csrc/plane_line.cu) or raises, and its gradient with respect to the
    planes and lines is :func:`plane_line_backward` (K6b); an ``xyz`` that
    requires grad is refused.  ``plane_line.launches`` and ``.launches_cp``
    count the forward launches of the two arms.
    """
    if xyz.device.type == "cpu":
        return plane_line_reference(density_planes, density_lines, app_planes, app_lines, xyz)
    if xyz.requires_grad:
        raise ValueError("plane_line: the coords take no gradient on the card (K6b computes "
                         "the planes' and lines' only); detach xyz")
    cp = density_planes is None
    tensors = (list(density_lines) + list(app_lines)) if cp else (
        list(density_planes) + list(density_lines) + list(app_planes) + list(app_lines))
    return _PlaneLine.apply(xyz, cp, *tensors)


plane_line.launches = 0
plane_line.launches_cp = 0


def plane_line_density(density_planes, density_lines, xyz: torch.Tensor) -> torch.Tensor:
    """K6d: the density feature (P,) alone (the mask build's lookup), from
    the density planes (None: CP) and lines.  No gradient.

    For CPU tensors this runs :func:`plane_line_reference` with
    ``density_only``; for CUDA tensors it launches ``nvfi_plane_line_fwd``
    with its density-only flag or raises.  ``plane_line_density.launches``
    and ``.launches_cp`` count the launches of the two arms."""
    if xyz.device.type == "cpu":
        return plane_line_reference(density_planes, density_lines, None, None, xyz,
                                    density_only=True)
    with torch.no_grad():
        return _forward(density_planes, density_lines, None, None, xyz, density_only=True)[0]


plane_line_density.launches = 0
plane_line_density.launches_cp = 0


# ---------------------------------------------------------------------------
# K6b
# ---------------------------------------------------------------------------

def launch_plane_line_backward(density_planes, density_lines, app_planes, app_lines, xyz,
                               g_density, g_app, grads):
    """Launch K6b, adding into ``grads`` (the four groups of
    :func:`plane_line_backward`'s result, zeroed by the caller) on checked
    arguments, and count the launch.  No host read-back."""
    P = xyz.shape[0]
    if P == 0:
        return
    cp = density_planes is None
    Cd, Ca = int(density_lines[0].shape[-1]), int(app_lines[0].shape[-1])
    inputs = [t for group in (density_planes, density_lines, app_planes, app_lines)
              if group is not None for t in group]
    outputs = [t for group in grads if group is not None for t in group]
    line_rows = sum(int(t.shape[0]) for t in density_lines)
    plan = plane_line_bwd_plan(P, Cd, Ca, line_rows,
                               [t.data_ptr() for t in inputs + outputs] + [g_app.data_ptr()],
                               multiprocessors(xyz.device.index or 0))
    ptrs, dims = _flat_inputs(density_planes, density_lines, app_planes, app_lines)
    gptrs, _ = _flat_inputs(*grads)
    lib = kernels.load()
    with torch.cuda.device(xyz.device):
        err = lib.nvfi_plane_line_bwd(ptrs, gptrs, dims, xyz.data_ptr(), P, Cd, Ca, plan.vec,
                                      plan.run, plan.chunk, plan.d_chunks, plan.a_chunks,
                                      plan.smem_bytes, int(cp), g_density.data_ptr(),
                                      g_app.data_ptr(), kernels.stream_ptr(xyz.device))
    kernels.check(err, "plane_line_bwd")
    _count(plane_line_backward, cp)


def plane_line_backward(density_planes, density_lines, app_planes, app_lines,
                        xyz: torch.Tensor, g_density: torch.Tensor, g_app: torch.Tensor):
    """K6b: the gradient of :func:`plane_line` with respect to its planes and
    lines.

    Args:
      density_planes ... xyz: the forward's inputs; ``xyz`` must not require
        grad (the coords get none).
      g_density (P,), g_app ((P, 3 Ca) VM, (P, Ca) CP): the incoming grads.
    Returns:
      [density plane grads, density line grads, app plane grads, app line
      grads], three float32 tensors each shaped like its input (the planes'
      None in the CP arm).  Summed with f32 atomics on the card, so their
      last bits change from run to run.
    For CPU tensors this runs :func:`plane_line_backward_reference`.  For
    CUDA tensors it launches ``nvfi_plane_line_bwd`` (csrc/plane_line_bwd.cu)
    or raises; ``plane_line_backward.launches`` and ``.launches_cp`` count
    the launches of the two arms.
    """
    if xyz.requires_grad:
        raise ValueError("plane_line_backward: the coords take no gradient here (K6b computes "
                         "the planes' and lines' only); detach xyz")
    if xyz.device.type == "cpu":
        return plane_line_backward_reference(density_planes, density_lines, app_planes,
                                             app_lines, xyz, g_density, g_app)
    if xyz.device.type != "cuda":
        raise ValueError(f"plane_line_backward: unsupported device {xyz.device}")
    _, Ca = _check_args(density_planes, density_lines, app_planes, app_lines, xyz, False)
    P = xyz.shape[0]
    width = Ca if density_planes is None else 3 * Ca
    _check_tensor("g_density", g_density, xyz.device, 1)
    _check_tensor("g_app", g_app, xyz.device, 2)
    if tuple(g_density.shape) != (P,) or tuple(g_app.shape) != (P, width):
        raise ValueError(f"plane_line_backward: g_density {tuple(g_density.shape)} and g_app "
                         f"{tuple(g_app.shape)}, want ({P},) and ({P}, {width})")
    grads = [None if group is None else [torch.zeros_like(t) for t in group]
             for group in (density_planes, density_lines, app_planes, app_lines)]
    launch_plane_line_backward(density_planes, density_lines, app_planes, app_lines, xyz,
                               g_density, g_app, grads)
    return grads


plane_line_backward.launches = 0
plane_line_backward.launches_cp = 0

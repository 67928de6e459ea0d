"""Bilinear plane sampling, the K-plane feature lookup (kernels K1 and K1d)
and the plain trilinear volume lookup.

Port of ``nvfi_tpu/ops/grid_sample.py:69-129`` (``make_quad_plane``,
``grid_sample_2d_block``) and ``:22-66, 209-260`` (``_corner_weights``,
``grid_sample_2d``, ``grid_sample_1d``, ``grid_sample_3d``: each corner with
its own validity; the first two are the static field's plain lookups,
``ops.plane_line``) with the JAX package's conventions: planes are
channels-last ``(H, W, C)``; normalized coord u in [-1, 1] maps to the pixel
coordinate ``(u+1)/2 * (S-1)`` (``F.grid_sample`` with align_corners=True),
and corners outside the grid weigh zero (padding_mode='zeros').

``plane_product`` and ``plane_product_density`` are the wrappers of the
hand-written CUDA kernel ``csrc/plane_product.cu`` (all channels, or the
density channels only); the gradient of ``plane_product`` is kernel K1b
(``csrc/plane_product_bwd.cu``, wrapper ``plane_product_backward``), reached
through a ``torch.autograd.Function``.  ``plane_product_reference`` and
``plane_product_backward_reference`` are the plain PyTorch versions, which
the wrappers run for CPU tensors only.

Each takes ``compute_dtype``: float32, or bfloat16, the JAX package's mixed
precision (``grid_sample_2d_block(compute_dtype=bf16)`` under
``kplane._plane_product``): the planes and coords stay float32, the gathered
rows and the tent products are rounded to bf16, every product and sum of the
lookup and of the cross-plane chain is rounded to bf16 in JAX's order, the
density sum is taken in float32 and the app channels come out in bf16.  The
density-only lookup (K1d, JAX ``density_feature``) takes the chain's last
product in float32, as XLA does where the f32 sum is its only consumer.  The
bf16 arms of K1, K1d and K1b read bf16 copies of the planes
(:func:`bf16_planes`), made once per plane version.  Each arm of a kernel
counts its launches apart: ``launches`` (float32) and ``launches_bf16``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import kernels

# plane index pairs (the JAX package's kplane.MAT_SPACE / MAT_TIME): space
# plane i is (gs[m1], gs[m0], C) indexed by (xyz[m0], xyz[m1]); time plane i
# is (K, gs[m0], C) indexed by (xyz[m0], t).  csrc/plane_product.cu hardcodes
# the same pairs.
MAT_SPACE = ((0, 1), (0, 2), (1, 2))
MAT_TIME = ((2, 3), (1, 3), (0, 3))
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def make_quad_plane(plane: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H-1, W-1, 4C) cell-quad view: channels ordered
    [y0x0, y0x1, y1x0, y1x1] (the TPU's one-row-per-cell gather table)."""
    return torch.cat(
        [plane[:-1, :-1], plane[:-1, 1:], plane[1:, :-1], plane[1:, 1:]], dim=-1
    )


class _Bf16Corners(torch.autograd.Function):
    """The corner sum of the bf16 lookup and its VJP, as XLA computes them.

    Forward: the rows (P, 4C) and the four tent products (P, 4) are rounded
    to bf16, and ``r0 w0 + r1 w1 + r2 w2 + r3 w3`` is taken left to right in
    bf16, each product and each sum rounded.  Backward: a row's cotangent is
    ``g * w_i`` in bf16 (widened to float32 for the float32 scatter-add); a
    tent product's cotangent is the sum over the channels of ``g * r_i``,
    which XLA reduces in channel order, adding in float32 and rounding to
    bf16 after every add.  Torch's own bf16 sum would round once at the end,
    and the coordinate gradient would then miss JAX's by ~4e-3 of its
    largest value.
    """

    @staticmethod
    def forward(ctx, rows, weights):
        C = rows.shape[-1] // 4
        r, w = rows.to(torch.bfloat16), weights.to(torch.bfloat16)
        ctx.save_for_backward(r, w)
        out = r[:, :C] * w[:, :1]
        for i in range(1, 4):
            out = out + r[:, i * C:(i + 1) * C] * w[:, i:i + 1]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r, w = ctx.saved_tensors
        C = g.shape[-1]
        g_rows = torch.cat([g * w[:, i:i + 1] for i in range(4)], -1).float()
        g_w = []
        for i in range(4):
            prod = g * r[:, i * C:(i + 1) * C]
            acc = prod[:, 0]
            for c in range(1, C):
                acc = acc + prod[:, c]
            g_w.append(acc)
        return g_rows, torch.stack(g_w, -1).float()


def grid_sample_2d_block(plane: torch.Tensor, coords: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bilinear plane sampling, one quad-row gather per point (plain version).

    The cell is clamped to [0, S-2] and every corner is weighted with the tent
    ``clip(1 - |x - col|, 0, 1)`` of the clamped cell, which reproduces the
    interior weights, the boundary cases and the zero weight of out-of-range
    corners in one formula.  With ``compute_dtype`` bfloat16 the corner sum
    runs in bf16 as the JAX package runs it (:class:`_Bf16Corners`).

    Args:
      plane:  (H, W, C) float32.
      coords: (..., 2) normalized (x, y), x indexing W and y indexing H.
    Returns:
      (..., C) in ``compute_dtype``.
    """
    H, W, C = plane.shape
    quad = make_quad_plane(plane).reshape((H - 1) * (W - 1), 4 * C)

    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    batch_shape = x.shape
    xf = x.reshape(-1)
    yf = y.reshape(-1)

    x0 = torch.clamp(torch.floor(xf).to(torch.int64), 0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(yf).to(torch.int64), 0, max(H - 2, 0))
    rows = quad[y0 * (W - 1) + x0]  # (P, 4C)

    x0f = x0.to(xf.dtype)
    y0f = y0.to(yf.dtype)
    wx0 = torch.clamp(1.0 - torch.abs(xf - x0f), 0.0, 1.0)
    wx1 = torch.clamp(1.0 - torch.abs(xf - (x0f + 1.0)), 0.0, 1.0)
    wy0 = torch.clamp(1.0 - torch.abs(yf - y0f), 0.0, 1.0)
    wy1 = torch.clamp(1.0 - torch.abs(yf - (y0f + 1.0)), 0.0, 1.0)

    if compute_dtype == torch.bfloat16:
        weights = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1)
        return _Bf16Corners.apply(rows, weights).reshape(*batch_shape, C)
    out = (
        rows[:, 0 * C : 1 * C] * (wy0 * wx0)[:, None]
        + rows[:, 1 * C : 2 * C] * (wy0 * wx1)[:, None]
        + rows[:, 2 * C : 3 * C] * (wy1 * wx0)[:, None]
        + rows[:, 3 * C : 4 * C] * (wy1 * wx1)[:, None]
    )
    return out.reshape(*batch_shape, C)


def _corner_weights(u: torch.Tensor, size: int):
    """Normalized coords -> (lo index, hi index), (lo weight, hi weight) and
    the per-corner validity ``0 <= i <= size - 1``; indices clipped."""
    x = (u + 1.0) * 0.5 * (size - 1)
    x0 = torch.floor(x)
    w1 = x - x0
    i0 = x0.to(torch.int64)
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i1 >= 0) & (i1 <= size - 1)
    return ((torch.clamp(i0, 0, size - 1), torch.clamp(i1, 0, size - 1)),
            (1.0 - w1, w1), (v0, v1))


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a channels-last plane, each corner with its own
    validity (port of ``nvfi_tpu/ops/grid_sample.py:36-66``; the plain
    lookup of the static TensoRF planes, ``ops.plane_line``).

    Args:
      plane: (H, W, C).
      coords: (..., 2) normalized (x, y), x indexing W and y indexing H.
    Returns:
      (..., C): the four corner terms summed in the JAX order.
    """
    H, W, C = plane.shape
    (ix0, ix1), (wx0, wx1), (vx0, vx1) = _corner_weights(coords[..., 0], W)
    (iy0, iy1), (wy0, wy1), (vy0, vy1) = _corner_weights(coords[..., 1], H)
    flat = plane.reshape(H * W, C)

    def corner(iy, ix, wy, wx, vy, vx):
        w = wy * wx * (vy & vx)
        return flat[iy * W + ix] * w[..., None]

    return (corner(iy0, ix0, wy0, wx0, vy0, vx0) + corner(iy0, ix1, wy0, wx1, vy0, vx1)
            + corner(iy1, ix0, wy1, wx0, vy1, vx0) + corner(iy1, ix1, wy1, wx1, vy1, vx1))


def grid_sample_1d(line: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear sample of a channels-last line (L, C) at normalized coords
    (...,) -> (..., C), zeros padding per corner (port of
    ``nvfi_tpu/ops/grid_sample.py:209-224``)."""
    L, _ = line.shape
    (i0, i1), (w0, w1), (v0, v1) = _corner_weights(coords, L)
    return line[i0] * (w0 * v0)[..., None] + line[i1] * (w1 * v1)[..., None]


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a single-channel volume (plain version of K3's
    lookup).  Not the clamped-cell tent form of ``grid_sample_2d_block``:
    each corner carries its own validity, and the eight terms are summed in
    the JAX order (z outermost, x innermost).

    Args:
      volume: (D, H, W).
      coords: (..., 3) normalized (x, y, z), x indexing W, y H and z D.
    Returns:
      (...,) interpolated values.
    """
    D, H, W = volume.shape
    ix, wx, vx = _corner_weights(coords[..., 0], W)
    iy, wy, vy = _corner_weights(coords[..., 1], H)
    iz, wz, vz = _corner_weights(coords[..., 2], D)
    flat = volume.reshape(-1)
    out = None
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                w = wz[cz] * wy[cy] * wx[cx] * (vz[cz] & vy[cy] & vx[cx])
                term = flat[(iz[cz] * H + iy[cy]) * W + ix[cx]] * w
                out = term if out is None else out + term
    return out


def plane_product_reference(planes_space, planes_time, xyzt: torch.Tensor,
                            density_n_comp: int, density_only: bool = False,
                            compute_dtype: torch.dtype = torch.float32):
    """Plain version of K1: JAX ``kplane._plane_product`` + the Density sum.
    With ``density_only`` the plain version of K1d: the density channels are
    sliced out of the planes before the lookup (JAX ``density_feature``) and
    only the density feature (P,) is returned; in bf16 its last product,
    s-chain x t-chain, is taken in float32 (exact for two bf16 values), as
    XLA keeps it for the float32 sum that is its only consumer, where the
    full lookup rounds it to bf16 as JAX's ``field_features`` does.

    Args:
      planes_space: 3 planes (gs[m1], gs[m0], C); planes_time: 3 planes
        (K, gs[m0], C); C = Cd + Ca, density channels first.
      xyzt: (P, 4) normalized coords, time already through normalize_time.
      compute_dtype: float32, or bfloat16 for the JAX package's mixed
        precision (the lookups and the product chain in bf16).
    Returns:
      density feature (P,) float32 = sum of the first Cd product channels,
      and app features (P, Ca) in ``compute_dtype`` = the remaining channels.
    """
    if density_only:
        planes_space = [p[..., :density_n_comp] for p in planes_space]
        planes_time = [p[..., :density_n_comp] for p in planes_time]
    feat_space = None
    feat_time = None
    for i in range(3):
        m0, m1 = MAT_SPACE[i]
        s = grid_sample_2d_block(planes_space[i], torch.stack([xyzt[:, m0], xyzt[:, m1]], -1),
                                 compute_dtype)
        feat_space = s if feat_space is None else feat_space * s
        mt0, mt1 = MAT_TIME[i]
        tf = grid_sample_2d_block(planes_time[i], torch.stack([xyzt[:, mt0], xyzt[:, mt1]], -1),
                                  compute_dtype)
        feat_time = tf if feat_time is None else feat_time * tf
    if density_only:  # summed in float32, as JAX's _decode_density
        return (feat_space.float() * feat_time.float()).sum(-1)
    fused = feat_space * feat_time
    return fused[:, :density_n_comp].float().sum(-1), fused[:, density_n_comp:]


def _check_plane_product_args(planes, xyzt, density_n_comp):
    if len(planes) != 6:
        raise ValueError("plane_product needs 3 space and 3 time planes")
    C = planes[0].shape[-1]
    for p in planes:
        if p.device != xyzt.device or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("plane_product: planes must be contiguous float32 on "
                             f"{xyzt.device}, got {p.dtype} on {p.device}")
        if p.dim() != 3 or p.shape[-1] != C or p.shape[0] < 2 or p.shape[1] < 2:
            raise ValueError(f"plane_product: plane shape {tuple(p.shape)} is not (H>=2, W>=2, {C})")
        if p.numel() >= 2**31:
            raise ValueError("plane_product: a plane must hold fewer than 2^31 values")
    if xyzt.dtype != torch.float32 or xyzt.dim() != 2 or xyzt.shape[1] != 4 \
            or not xyzt.is_contiguous():
        raise ValueError(f"plane_product: xyzt must be contiguous float32 (P, 4), "
                         f"got {xyzt.dtype} {tuple(xyzt.shape)}")
    if not 0 <= density_n_comp <= C:
        raise ValueError(f"plane_product: density_n_comp {density_n_comp} not in [0, {C}]")


def _check_compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"plane_product: compute_dtype {compute_dtype} is not one of "
                         f"{COMPUTE_DTYPES}")


def _check_plane_grad_args(xyzt, app_n_comp, g_density, g_app, compute_dtype=torch.float32):
    """g_density is float32 (the density sum's), g_app in the compute dtype
    (the app channels')."""
    P = xyzt.shape[0]
    for name, g, shape, dtype in (("g_density", g_density, (P,), torch.float32),
                                  ("g_app", g_app, (P, app_n_comp), compute_dtype)):
        if tuple(g.shape) != shape or g.device != xyzt.device or g.dtype != dtype \
                or not g.is_contiguous():
            raise ValueError(f"plane_product_backward: {name} must be contiguous {dtype} "
                             f"{shape} on {xyzt.device}, got {g.dtype} {tuple(g.shape)} "
                             f"on {g.device}")


PLANE_PRODUCT_RUN = 128  # K1/K1d samples a block, where the shared memory allows
PLANE_PRODUCT_RUN_BF16 = 256  # the bf16 arm's: 9 (K1) or 3 (K1d) groups a sample at bat's widths
PLANE_PRODUCT_SMEM_LIMIT = 48 * 1024  # without the opt-in of larger dynamic shared memory


@dataclass(frozen=True)
class PlaneProductPlan:
    """How K1 and K1d are launched: ``vec`` channels a work item (float32: 4,
    the 16-byte path, or 1; bf16: 8, the 16-byte path, or 1), ``run``
    samples a block, ``smem_bytes`` of dynamic shared memory a block."""
    vec: int
    run: int
    smem_bytes: int


def plane_product_plan(C: int, density_n_comp: int, plane_ptrs,
                       compute_dtype: torch.dtype = torch.float32) -> PlaneProductPlan:
    """The launch plan of K1 and K1d in the arm of ``compute_dtype``, from
    the shapes and the addresses alone.  ``C`` is the row stride of the
    planes the kernel reads: the float32 planes' C, or the channels of the
    bf16 copies (:func:`bf16_planes`: C for K1, density_n_comp for K1d).

    float32: the 16-byte path (4 channels a group) needs C and
    density_n_comp multiples of 4 (no group straddles the density/app split
    or a row's end) and 16-byte aligned planes; K1 and K1d take the same plan
    for the same planes, which keeps K1d's density equal to K1's bit for bit.
    Shared memory per block: the (sample, plane) cell offsets and corner
    weights (24 B + 96 B a sample) and the density partials (4 B a sample and
    density group); ``run`` halves from 128 until it fits.

    bfloat16: the 16-byte path takes 8 channels a group, so it needs
    multiples of 8; other shapes take one channel a group.  The corner
    weights are four bf16 (48 B a sample), and ``run`` halves from 256.
    """
    bf16 = compute_dtype == torch.bfloat16
    width = 8 if bf16 else 4  # channels in 16 bytes
    vec = width if C % width == 0 and density_n_comp % width == 0 \
        and all(int(p) % 16 == 0 for p in plane_ptrs) else 1
    per_sample = 6 * ((8 if bf16 else 16) + 4) + density_n_comp // vec * 4
    run = PLANE_PRODUCT_RUN_BF16 if bf16 else PLANE_PRODUCT_RUN
    while run * per_sample > PLANE_PRODUCT_SMEM_LIMIT and run > 1:
        run //= 2
    if run * per_sample > PLANE_PRODUCT_SMEM_LIMIT:
        raise ValueError(f"plane_product: density_n_comp {density_n_comp} needs more than "
                         f"{PLANE_PRODUCT_SMEM_LIMIT} B of shared memory a sample")
    return PlaneProductPlan(vec=vec, run=run, smem_bytes=run * per_sample)


PLANE_PRODUCT_BWD_CHUNK = 24  # csrc/plane_product_bwd.cu kChunkChannels (the f32 arm)


@dataclass(frozen=True)
class PlaneProductBwdPlan:
    """How K1b is launched: ``vec`` channels a step (float32: 4, the 16-byte
    path with float4 loads and float4 atomics; bf16: 8, the 16-byte path with
    8 bf16 a load; else 1), ``run`` samples a block, ``smem_bytes`` of
    dynamic shared memory a block."""
    vec: int
    run: int
    smem_bytes: int


def plane_product_bwd_plan(C: int, density_n_comp: int, ptrs,
                           compute_dtype: torch.dtype = torch.float32) -> PlaneProductBwdPlan:
    """The launch plan of K1b in the arm of ``compute_dtype``, from the shapes
    and the addresses alone.

    ``ptrs``: the addresses the 16-byte path reads or adds to with 128-bit
    accesses (the six planes the kernel reads, g_app, the six grads).  That
    path needs C and density_n_comp multiples of the channels in 16 bytes
    (float32: 4; bf16, whose kernel reads the bf16 copies: 8), so that no
    step straddles the density/app split or a row's end, and every pointer
    16-byte aligned; other shapes take one channel a step.  Shared memory
    per block, for each sample of the run: the (sample, plane) tents and
    their derivatives (2 x 96 B), the cell offsets (24 B), the compacted
    index and g_density (8 B), and in float32 three grad_xyz partials for
    each chunk of ``PLANE_PRODUCT_BWD_CHUNK`` channels (the bf16 arm walks
    all C channels in one lane and keeps none); ``run`` halves from 128
    until it fits.
    """
    bf16 = compute_dtype == torch.bfloat16
    width = 8 if bf16 else 4  # channels in 16 bytes
    vec = width if C % width == 0 and density_n_comp % width == 0 \
        and all(int(p) % 16 == 0 for p in ptrs) else 1
    chunks = 0 if bf16 else -(-C // PLANE_PRODUCT_BWD_CHUNK)
    per_sample = 6 * (16 + 16 + 4) + 4 + 4 + chunks * 12
    run = PLANE_PRODUCT_RUN
    while run * per_sample > PLANE_PRODUCT_SMEM_LIMIT and run > 1:
        run //= 2
    if run * per_sample > PLANE_PRODUCT_SMEM_LIMIT:
        raise ValueError(f"plane_product_backward: C = {C} needs more than "
                         f"{PLANE_PRODUCT_SMEM_LIMIT} B of shared memory a sample")
    return PlaneProductBwdPlan(vec=vec, run=run, smem_bytes=run * per_sample)


def _count(wrapper, compute_dtype, launched=True):
    """Add one to the launch counter of the arm that ran."""
    if launched:
        if compute_dtype == torch.bfloat16:
            wrapper.launches_bf16 += 1
        else:
            wrapper.launches += 1


# the bf16 copies of planes, kept beside each plane while it lives:
# {plane: {channels: ((plane._version, plane.data_ptr()), copy)}}
_BF16_COPIES = WeakIdKeyDictionary()


def bf16_planes(planes, channels: int) -> list:
    """bf16 copies ``(H, W, channels)`` of channels ``[0, channels)`` of each
    float32 plane: what the bf16 arms of K1 and K1b (all C channels) and K1d
    (the density channels) read.

    JAX rounds each gathered row to bf16 before any arithmetic
    (``rows.astype(cd)``), so a plane rounded once (to nearest, ties to even)
    holds the very corner values.  A copy is made once per plane version and
    kept beside the plane (weakly: it goes with the plane); an in-place
    update, such as the optimizer's, moves ``plane._version``, and the next
    call makes the copy anew, as it does when the plane is given other
    storage (``plane.data = ...``).  So the mask build's 1860 chunks share
    one copy, and a train step makes one at its first lookup, which its
    backward (K1b.bf16) reads again.  An inference
    tensor has no version counter: its copy is made on every call.

    The limit: an in-place write must go through the plane itself (as
    ``optim.apply_updates``'s ``p.sub_`` does), not through ``plane.data``,
    whose writes do not move the plane's version and would leave the copy
    stale.
    """
    out = []
    for p in planes:
        if p.is_inference():
            out.append(_bf16_copy(p, channels))
            continue
        kept = _BF16_COPIES.setdefault(p, {})
        key = (p._version, p.data_ptr())
        made, copy = kept.get(channels, (None, None))
        if made != key:
            copy = _bf16_copy(p, channels)
            kept[channels] = (key, copy)
        out.append(copy)
    return out


def _bf16_copy(plane, channels):
    with torch.no_grad():
        return plane[..., :channels].to(torch.bfloat16, memory_format=torch.contiguous_format)


def plane_product_inputs(planes, density_n_comp, density_only, compute_dtype):
    """The six planes K1 or K1d reads in the arm of ``compute_dtype`` (the
    float32 planes, or their bf16 copies), their row stride and the launch
    plan, for checked CUDA tensors."""
    C = planes[0].shape[-1]
    if compute_dtype == torch.bfloat16:
        C = density_n_comp if density_only else C
        planes = bf16_planes(planes, C)
    return planes, C, plane_product_plan(C, density_n_comp, [p.data_ptr() for p in planes],
                                         compute_dtype)


def _launch_plane_product(planes_space, planes_time, xyzt, density_n_comp, density_only,
                          compute_dtype):
    """Check the arguments, allocate the outputs and launch K1 or K1d in the
    arm of ``compute_dtype``."""
    if xyzt.device.type != "cuda":
        raise ValueError(f"plane_product: unsupported device {xyzt.device}")
    _check_compute_dtype(compute_dtype)
    planes = list(planes_space) + list(planes_time)
    _check_plane_product_args(planes, xyzt, density_n_comp)
    P = xyzt.shape[0]
    density = torch.empty(P, dtype=torch.float32, device=xyzt.device)
    app = None if density_only else torch.empty(P, planes[0].shape[-1] - density_n_comp,
                                                dtype=compute_dtype, device=xyzt.device)
    if P == 0:
        return density, app, False
    read, C, plan = plane_product_inputs(planes, density_n_comp, density_only, compute_dtype)
    lib = kernels.load()
    hw = (ctypes.c_int * 12)(*[int(d) for p in planes for d in p.shape[:2]])
    head = (*[p.data_ptr() for p in read], hw, xyzt.data_ptr(), P, C, density_n_comp,
            plan.vec, plan.run, plan.smem_bytes, int(compute_dtype == torch.bfloat16),
            density.data_ptr())
    with torch.cuda.device(xyzt.device):
        if density_only:
            err = lib.nvfi_plane_product_density_fwd(*head, kernels.stream_ptr(xyzt.device))
        else:
            err = lib.nvfi_plane_product_fwd(*head, app.data_ptr(),
                                             kernels.stream_ptr(xyzt.device))
    kernels.check(err, "plane_product_density_fwd" if density_only else "plane_product_fwd")
    return density, app, True


class _PlaneProduct(torch.autograd.Function):
    """K1 forward, K1b backward, in one arm.  The backward recomputes the
    lookup from ``xyzt`` and the planes, so the forward saves only those (and
    nothing without a graph: ``no_grad`` / ``inference_mode``)."""

    @staticmethod
    def forward(ctx, xyzt, density_n_comp, compute_dtype, *planes):
        density, app, launched = _launch_plane_product(planes[:3], planes[3:], xyzt,
                                                       density_n_comp, False, compute_dtype)
        _count(plane_product, compute_dtype, launched)
        ctx.save_for_backward(xyzt, *planes)
        ctx.density_n_comp = density_n_comp
        ctx.compute_dtype = compute_dtype
        ctx.set_materialize_grads(False)
        return density, app

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_density, g_app):
        xyzt, *planes = ctx.saved_tensors
        P, Ca = xyzt.shape[0], planes[0].shape[-1] - ctx.density_n_comp
        if g_density is None:
            g_density = xyzt.new_zeros(P)
        if g_app is None:
            g_app = xyzt.new_zeros(P, Ca, dtype=ctx.compute_dtype)
        plane_grads, g_xyzt = plane_product_backward(
            planes[:3], planes[3:], xyzt, ctx.density_n_comp, g_density.contiguous(),
            g_app.contiguous(), want_planes=any(ctx.needs_input_grad[3:]),
            want_xyz=ctx.needs_input_grad[0], compute_dtype=ctx.compute_dtype)
        return (g_xyzt, None, None, *(plane_grads or [None] * 6))


def plane_product(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int,
                  compute_dtype: torch.dtype = torch.float32):
    """K1: density feature (P,) float32 and app features (P, Ca) in
    ``compute_dtype`` of the six-plane product.

    For CPU tensors this runs :func:`plane_product_reference` under ordinary
    autograd.  For CUDA tensors it launches ``nvfi_plane_product_fwd``
    (csrc/plane_product.cu) in the arm of ``compute_dtype`` or raises, and
    its gradient with respect to the planes and the spatial coords is
    :func:`plane_product_backward` (K1b, the same arm; the time column gets no
    gradient); ``plane_product.launches`` and ``plane_product.launches_bf16``
    count the forward launches of the two arms.
    """
    if xyzt.device.type == "cpu":
        return plane_product_reference(planes_space, planes_time, xyzt, density_n_comp,
                                       compute_dtype=compute_dtype)
    return _PlaneProduct.apply(xyzt, density_n_comp, compute_dtype, *planes_space, *planes_time)


plane_product.launches = 0
plane_product.launches_bf16 = 0


def plane_product_backward_reference(planes_space, planes_time, xyzt: torch.Tensor,
                                     density_n_comp: int, g_density, g_app,
                                     compute_dtype: torch.dtype = torch.float32):
    """Plain version of K1b: ``torch.autograd.grad`` through
    :func:`plane_product_reference` (in bf16 through :class:`_Bf16Corners`).

    Returns (six plane grads in the order s0 s1 s2 t0 t1 t2, grad_xyzt (P, 4)
    with a zero time column, as the kernel leaves it), all float32."""
    with torch.enable_grad():
        planes = [p.detach().requires_grad_(True) for p in list(planes_space) + list(planes_time)]
        x = xyzt.detach().requires_grad_(True)
        density, app = plane_product_reference(planes[:3], planes[3:], x, density_n_comp,
                                               compute_dtype=compute_dtype)
        *plane_grads, g_xyzt = torch.autograd.grad([density, app], planes + [x],
                                                   [g_density, g_app])
    g_xyzt = g_xyzt.clone()
    g_xyzt[:, 3] = 0.0
    return plane_grads, g_xyzt


def plane_product_backward(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int,
                           g_density: torch.Tensor, g_app: torch.Tensor,
                           want_planes: bool = True, want_xyz: bool = True,
                           compute_dtype: torch.dtype = torch.float32):
    """K1b: the gradient of :func:`plane_product`.

    Args:
      planes_space, planes_time, xyzt, density_n_comp, compute_dtype: the
        forward's inputs.
      g_density (P,) float32, g_app (P, Ca) in ``compute_dtype``: the incoming
        grads.  In bf16 the kernel rounds g_density to bf16 for every density
        channel, as JAX's VJP of the float32 density sum does.
    Returns:
      (list of six float32 plane grads shaped like the planes, or None without
      ``want_planes``; grad_xyzt (P, 4) float32 whose time column is zero, or
      None without ``want_xyz``).  The plane grads are summed with f32
      atomics, so their last bits change from run to run.
    For CPU tensors this runs :func:`plane_product_backward_reference`.  For
    CUDA tensors it launches ``nvfi_plane_product_bwd``
    (csrc/plane_product_bwd.cu) in the arm of ``compute_dtype`` (bf16: on the
    planes' bf16 copies, :func:`bf16_planes`) or raises;
    ``plane_product_backward.launches`` and ``.launches_bf16`` count the
    launches of the two arms.
    """
    if xyzt.device.type == "cpu":
        plane_grads, g_xyzt = plane_product_backward_reference(
            planes_space, planes_time, xyzt, density_n_comp, g_density, g_app, compute_dtype)
        return (plane_grads if want_planes else None), (g_xyzt if want_xyz else None)
    if xyzt.device.type != "cuda":
        raise ValueError(f"plane_product_backward: unsupported device {xyzt.device}")
    _check_compute_dtype(compute_dtype)
    planes = list(planes_space) + list(planes_time)
    _check_plane_product_args(planes, xyzt, density_n_comp)
    _check_plane_grad_args(xyzt, planes[0].shape[-1] - density_n_comp, g_density, g_app,
                           compute_dtype)
    P = xyzt.shape[0]
    plane_grads = _zero_plane_grads(planes) if want_planes else None
    g_xyzt = torch.empty_like(xyzt) if want_xyz else None
    if P == 0 or not (want_planes or want_xyz):
        return plane_grads, g_xyzt
    launch_plane_product_backward(planes, xyzt, density_n_comp, g_density, g_app, plane_grads,
                                  g_xyzt)
    return plane_grads, g_xyzt


plane_product_backward.launches = 0
plane_product_backward.launches_bf16 = 0


def _zero_plane_grads(planes):
    """Six zeroed grads shaped like the planes: views of one allocation, so
    that one memset zeroes them all.  Each view starts at a multiple of the
    plane sizes before it, 16-byte aligned whenever C % 4 == 0."""
    flat = torch.zeros(sum(p.numel() for p in planes), dtype=torch.float32,
                       device=planes[0].device)
    return [g.view(p.shape) for g, p in zip(flat.split([p.numel() for p in planes]), planes)]


def launch_plane_product_backward(planes, xyzt, density_n_comp, g_density, g_app, plane_grads,
                                  g_xyzt, stats=None) -> None:
    """One launch of ``nvfi_plane_product_bwd`` on checked CUDA tensors, with
    the plan for them, in the arm of ``g_app``'s dtype: float32 on the
    float32 ``planes``, bf16 on their bf16 copies (:func:`bf16_planes`, the
    copies K1.bf16 read, so a cache hit after the forward); raises if the C
    function refuses it, and adds one to the arm's counter of
    ``plane_product_backward`` if it launched.  ``plane_grads`` (zeroed,
    float32) or ``g_xyzt`` may be None; ``stats``, where given, is an int64
    tensor of three counters the kernel adds to (global atomic instructions,
    corner updates with a zero tent weight, updates merged into another
    sample's atomic)."""
    P, C = xyzt.shape[0], planes[0].shape[-1]
    bf16 = g_app.dtype == torch.bfloat16
    read = bf16_planes(planes, C) if bf16 else planes
    ptrs = [p.data_ptr() for p in read] + [g_app.data_ptr()]
    if plane_grads is not None:
        ptrs += [g.data_ptr() for g in plane_grads]
    plan = plane_product_bwd_plan(C, density_n_comp, ptrs, g_app.dtype)
    hw = (ctypes.c_int * 12)(*[int(d) for p in planes for d in p.shape[:2]])
    grad_ptrs = None if plane_grads is None else \
        (ctypes.c_void_p * 6)(*[g.data_ptr() for g in plane_grads])
    with torch.cuda.device(xyzt.device):
        err = kernels.load().nvfi_plane_product_bwd(
            *[p.data_ptr() for p in read], hw, xyzt.data_ptr(), P, C, density_n_comp,
            plan.vec, plan.run, plan.smem_bytes, int(bf16), g_density.data_ptr(),
            g_app.data_ptr(), grad_ptrs, None if g_xyzt is None else g_xyzt.data_ptr(),
            None if stats is None else stats.data_ptr(), kernels.stream_ptr(xyzt.device))
    kernels.check(err, "plane_product_bwd")
    _count(plane_product_backward, g_app.dtype)


def plane_product_density(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int,
                          compute_dtype: torch.dtype = torch.float32):
    """K1d: the density feature (P,) float32 alone, from the merged planes of K1.

    In float32 the kernel reads channels ``[0, density_n_comp)`` of the
    (H, W, C) planes in place (no sliced copy) and equals
    ``plane_product(...)[0]`` bit for bit on the card.  In bf16 it reads the
    bf16 copies of the density channels (:func:`bf16_planes`) and takes the
    chain's last product in float32, as JAX's ``density_feature`` does; it
    then differs from ``plane_product(...)[0]``, which rounds that product
    to bf16 as JAX's ``field_features`` does.  For CPU tensors this runs
    :func:`plane_product_reference` with ``density_only``.  For CUDA tensors
    it launches ``nvfi_plane_product_density_fwd`` in the arm of
    ``compute_dtype`` or raises; ``plane_product_density.launches`` and
    ``.launches_bf16`` count the launches of the two arms.
    """
    if xyzt.device.type == "cpu":
        return plane_product_reference(planes_space, planes_time, xyzt, density_n_comp,
                                       density_only=True, compute_dtype=compute_dtype)
    density, _, launched = _launch_plane_product(planes_space, planes_time, xyzt,
                                                 density_n_comp, True, compute_dtype)
    _count(plane_product_density, compute_dtype, launched)
    return density


plane_product_density.launches = 0
plane_product_density.launches_bf16 = 0

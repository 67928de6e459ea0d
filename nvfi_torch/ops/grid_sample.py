"""Bilinear plane sampling, the K-plane feature lookup (kernels K1 and K1d)
and the plain trilinear volume lookup.

Port of ``nvfi_tpu/ops/grid_sample.py:69-129`` (``make_quad_plane``,
``grid_sample_2d_block``) and ``:22-33, 227-260`` (``_corner_weights``,
``grid_sample_3d``) with the JAX package's conventions: planes are
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
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import kernels

# plane index pairs (the JAX package's kplane.MAT_SPACE / MAT_TIME): space
# plane i is (gs[m1], gs[m0], C) indexed by (xyz[m0], xyz[m1]); time plane i
# is (K, gs[m0], C) indexed by (xyz[m0], t).  csrc/plane_product.cu hardcodes
# the same pairs.
MAT_SPACE = ((0, 1), (0, 2), (1, 2))
MAT_TIME = ((2, 3), (1, 3), (0, 3))


def make_quad_plane(plane: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H-1, W-1, 4C) cell-quad view: channels ordered
    [y0x0, y0x1, y1x0, y1x1] (the TPU's one-row-per-cell gather table)."""
    return torch.cat(
        [plane[:-1, :-1], plane[:-1, 1:], plane[1:, :-1], plane[1:, 1:]], dim=-1
    )


def grid_sample_2d_block(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear plane sampling, one quad-row gather per point (plain version).

    The cell is clamped to [0, S-2] and every corner is weighted with the tent
    ``clip(1 - |x - col|, 0, 1)`` of the clamped cell, which reproduces the
    interior weights, the boundary cases and the zero weight of out-of-range
    corners in one formula.

    Args:
      plane:  (H, W, C).
      coords: (..., 2) normalized (x, y), x indexing W and y indexing H.
    Returns:
      (..., C).
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
                            density_n_comp: int, density_only: bool = False):
    """Plain version of K1: JAX ``kplane._plane_product`` + the Density sum.
    With ``density_only`` the plain version of K1d: the density channels are
    sliced out of the planes before the lookup (JAX ``density_feature``) and
    only the density feature (P,) is returned.

    Args:
      planes_space: 3 planes (gs[m1], gs[m0], C); planes_time: 3 planes
        (K, gs[m0], C); C = Cd + Ca, density channels first.
      xyzt: (P, 4) normalized coords, time already through normalize_time.
    Returns:
      density feature (P,) = sum of the first Cd product channels, and
      app features (P, Ca) = the remaining channels.
    """
    if density_only:
        planes_space = [p[..., :density_n_comp] for p in planes_space]
        planes_time = [p[..., :density_n_comp] for p in planes_time]
    feat_space = None
    feat_time = None
    for i in range(3):
        m0, m1 = MAT_SPACE[i]
        s = grid_sample_2d_block(planes_space[i], torch.stack([xyzt[:, m0], xyzt[:, m1]], -1))
        feat_space = s if feat_space is None else feat_space * s
        mt0, mt1 = MAT_TIME[i]
        tf = grid_sample_2d_block(planes_time[i], torch.stack([xyzt[:, mt0], xyzt[:, mt1]], -1))
        feat_time = tf if feat_time is None else feat_time * tf
    fused = feat_space * feat_time
    if density_only:
        return fused.sum(-1)
    return fused[:, :density_n_comp].sum(-1), fused[:, density_n_comp:]


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


def _check_plane_grad_args(xyzt, app_n_comp, g_density, g_app):
    P = xyzt.shape[0]
    for name, g, shape in (("g_density", g_density, (P,)), ("g_app", g_app, (P, app_n_comp))):
        if tuple(g.shape) != shape or g.device != xyzt.device or g.dtype != torch.float32 \
                or not g.is_contiguous():
            raise ValueError(f"plane_product_backward: {name} must be contiguous float32 "
                             f"{shape} on {xyzt.device}, got {g.dtype} {tuple(g.shape)} "
                             f"on {g.device}")


PLANE_PRODUCT_RUN = 128  # K1/K1d samples a block, where the shared memory allows
PLANE_PRODUCT_SMEM_LIMIT = 48 * 1024  # without the opt-in of larger dynamic shared memory


@dataclass(frozen=True)
class PlaneProductPlan:
    """How K1 and K1d are launched: ``vec`` channels a work item (4: the
    16-byte path, 1: scalar), ``run`` samples a block, ``smem_bytes`` of
    dynamic shared memory a block."""
    vec: int
    run: int
    smem_bytes: int


def plane_product_plan(C: int, density_n_comp: int, plane_ptrs) -> PlaneProductPlan:
    """The launch plan of K1 and K1d; both take the same plan for the same
    planes, which keeps K1d's density equal to K1's bit for bit.

    The 16-byte path needs C and density_n_comp multiples of 4 (no channel
    group straddles the density/app split or a row's end) and 16-byte aligned
    planes.  Shared memory per block: the (sample, plane) cell offsets and
    corner weights (24 B + 96 B a sample) and the density partials (4 B a
    sample and density group); ``run`` halves from 128 until it fits.
    """
    vec = 4 if C % 4 == 0 and density_n_comp % 4 == 0 \
        and all(int(p) % 16 == 0 for p in plane_ptrs) else 1
    per_sample = 6 * (16 + 4) + density_n_comp // vec * 4
    run = PLANE_PRODUCT_RUN
    while run * per_sample > PLANE_PRODUCT_SMEM_LIMIT and run > 1:
        run //= 2
    if run * per_sample > PLANE_PRODUCT_SMEM_LIMIT:
        raise ValueError(f"plane_product: density_n_comp {density_n_comp} needs more than "
                         f"{PLANE_PRODUCT_SMEM_LIMIT} B of shared memory a sample")
    return PlaneProductPlan(vec=vec, run=run, smem_bytes=run * per_sample)


def _launch_plane_product(planes_space, planes_time, xyzt, density_n_comp, density_only):
    """Check the arguments, allocate the outputs and launch K1 or K1d."""
    if xyzt.device.type != "cuda":
        raise ValueError(f"plane_product: unsupported device {xyzt.device}")
    planes = list(planes_space) + list(planes_time)
    _check_plane_product_args(planes, xyzt, density_n_comp)
    P = xyzt.shape[0]
    C = planes[0].shape[-1]
    density = torch.empty(P, dtype=torch.float32, device=xyzt.device)
    app = None if density_only else torch.empty(P, C - density_n_comp, dtype=torch.float32,
                                                device=xyzt.device)
    if P == 0:
        return density, app, False
    plan = plane_product_plan(C, density_n_comp, [p.data_ptr() for p in planes])
    lib = kernels.load()
    hw = (ctypes.c_int * 12)(*[int(d) for p in planes for d in p.shape[:2]])
    head = (*[p.data_ptr() for p in planes], hw, xyzt.data_ptr(), P, C, density_n_comp,
            plan.vec, plan.run, plan.smem_bytes, density.data_ptr())
    with torch.cuda.device(xyzt.device):
        if density_only:
            err = lib.nvfi_plane_product_density_fwd(*head, kernels.stream_ptr(xyzt.device))
        else:
            err = lib.nvfi_plane_product_fwd(*head, app.data_ptr(),
                                             kernels.stream_ptr(xyzt.device))
    kernels.check(err, "plane_product_density_fwd" if density_only else "plane_product_fwd")
    return density, app, True


class _PlaneProduct(torch.autograd.Function):
    """K1 forward, K1b backward.  The backward recomputes the lookup from
    ``xyzt`` and the planes, so the forward saves only those (and nothing
    without a graph: ``no_grad`` / ``inference_mode``)."""

    @staticmethod
    def forward(ctx, xyzt, density_n_comp, *planes):
        density, app, launched = _launch_plane_product(planes[:3], planes[3:], xyzt,
                                                       density_n_comp, density_only=False)
        plane_product.launches += launched
        ctx.save_for_backward(xyzt, *planes)
        ctx.density_n_comp = density_n_comp
        ctx.set_materialize_grads(False)
        return density, app

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_density, g_app):
        xyzt, *planes = ctx.saved_tensors
        if g_density is None:
            g_density = xyzt.new_zeros(xyzt.shape[0])
        if g_app is None:
            g_app = xyzt.new_zeros(xyzt.shape[0], planes[0].shape[-1] - ctx.density_n_comp)
        plane_grads, g_xyzt = plane_product_backward(
            planes[:3], planes[3:], xyzt, ctx.density_n_comp, g_density.contiguous(),
            g_app.contiguous(), want_planes=any(ctx.needs_input_grad[2:]),
            want_xyz=ctx.needs_input_grad[0])
        return (g_xyzt, None, *(plane_grads or [None] * 6))


def plane_product(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int):
    """K1: density feature (P,) and app features (P, Ca) of the six-plane product.

    For CPU tensors this runs :func:`plane_product_reference` under ordinary
    autograd.  For CUDA tensors it launches ``nvfi_plane_product_fwd``
    (csrc/plane_product.cu) or raises, and its gradient with respect to the
    planes and the spatial coords is :func:`plane_product_backward` (K1b; the
    time column gets no gradient); ``plane_product.launches`` counts the
    forward launches.
    """
    if xyzt.device.type == "cpu":
        return plane_product_reference(planes_space, planes_time, xyzt, density_n_comp)
    return _PlaneProduct.apply(xyzt, density_n_comp, *planes_space, *planes_time)


plane_product.launches = 0


def plane_product_backward_reference(planes_space, planes_time, xyzt: torch.Tensor,
                                     density_n_comp: int, g_density, g_app):
    """Plain version of K1b: ``torch.autograd.grad`` through
    :func:`plane_product_reference`.

    Returns (six plane grads in the order s0 s1 s2 t0 t1 t2, grad_xyzt (P, 4)
    with a zero time column, as the kernel leaves it)."""
    with torch.enable_grad():
        planes = [p.detach().requires_grad_(True) for p in list(planes_space) + list(planes_time)]
        x = xyzt.detach().requires_grad_(True)
        density, app = plane_product_reference(planes[:3], planes[3:], x, density_n_comp)
        *plane_grads, g_xyzt = torch.autograd.grad([density, app], planes + [x],
                                                   [g_density, g_app])
    g_xyzt = g_xyzt.clone()
    g_xyzt[:, 3] = 0.0
    return plane_grads, g_xyzt


def plane_product_backward(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int,
                           g_density: torch.Tensor, g_app: torch.Tensor,
                           want_planes: bool = True, want_xyz: bool = True):
    """K1b: the gradient of :func:`plane_product`.

    Args:
      planes_space, planes_time, xyzt, density_n_comp: the forward's inputs.
      g_density (P,), g_app (P, Ca): the incoming grads.
    Returns:
      (list of six plane grads shaped like the planes, or None without
      ``want_planes``; grad_xyzt (P, 4) whose time column is zero, or None
      without ``want_xyz``).  The plane grads are summed with f32 atomics, so
      their last bits change from run to run.
    For CPU tensors this runs :func:`plane_product_backward_reference`.  For
    CUDA tensors it launches ``nvfi_plane_product_bwd``
    (csrc/plane_product_bwd.cu) or raises; ``plane_product_backward.launches``
    counts the launches.
    """
    if xyzt.device.type == "cpu":
        plane_grads, g_xyzt = plane_product_backward_reference(
            planes_space, planes_time, xyzt, density_n_comp, g_density, g_app)
        return (plane_grads if want_planes else None), (g_xyzt if want_xyz else None)
    if xyzt.device.type != "cuda":
        raise ValueError(f"plane_product_backward: unsupported device {xyzt.device}")
    planes = list(planes_space) + list(planes_time)
    _check_plane_product_args(planes, xyzt, density_n_comp)
    _check_plane_grad_args(xyzt, planes[0].shape[-1] - density_n_comp, g_density, g_app)
    P, C = xyzt.shape[0], planes[0].shape[-1]
    plane_grads = [torch.zeros_like(p) for p in planes] if want_planes else None
    g_xyzt = torch.empty_like(xyzt) if want_xyz else None
    if P == 0 or not (want_planes or want_xyz):
        return plane_grads, g_xyzt
    lib = kernels.load()
    hw = (ctypes.c_int * 12)(*[int(d) for p in planes for d in p.shape[:2]])
    grad_ptrs = (ctypes.c_void_p * 6)(*[g.data_ptr() for g in plane_grads]) \
        if want_planes else None
    with torch.cuda.device(xyzt.device):
        err = lib.nvfi_plane_product_bwd(
            *[p.data_ptr() for p in planes], hw, xyzt.data_ptr(), P, C, density_n_comp,
            g_density.data_ptr(), g_app.data_ptr(), grad_ptrs,
            None if g_xyzt is None else g_xyzt.data_ptr(), kernels.stream_ptr(xyzt.device))
    kernels.check(err, "plane_product_bwd")
    plane_product_backward.launches += 1
    return plane_grads, g_xyzt


plane_product_backward.launches = 0


def plane_product_density(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int):
    """K1d: the density feature (P,) alone, from the merged planes of K1.

    The kernel reads channels ``[0, density_n_comp)`` of the (H, W, C) planes
    in place (no sliced copy) and equals ``plane_product(...)[0]`` bit for bit
    on the card.  For CPU tensors this runs :func:`plane_product_reference`
    with ``density_only``.  For CUDA tensors it launches
    ``nvfi_plane_product_density_fwd`` or raises;
    ``plane_product_density.launches`` counts the launches.
    """
    if xyzt.device.type == "cpu":
        return plane_product_reference(planes_space, planes_time, xyzt, density_n_comp,
                                       density_only=True)
    density, _, launched = _launch_plane_product(planes_space, planes_time, xyzt,
                                                 density_n_comp, density_only=True)
    plane_product_density.launches += launched
    return density


plane_product_density.launches = 0

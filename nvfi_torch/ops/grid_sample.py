"""Bilinear plane sampling and the K-plane feature lookup (kernel K1).

Port of ``nvfi_tpu/ops/grid_sample.py:69-129`` (``make_quad_plane``,
``grid_sample_2d_block``) with the JAX package's conventions: planes are
channels-last ``(H, W, C)``; normalized coord u in [-1, 1] maps to the pixel
coordinate ``(u+1)/2 * (S-1)`` (``F.grid_sample`` with align_corners=True),
and corners outside the grid weigh zero (padding_mode='zeros').

``plane_product`` is the wrapper of the hand-written CUDA kernel
``csrc/plane_product.cu``; ``plane_product_reference`` is its plain PyTorch
version, which the wrapper runs for CPU tensors only.
"""

from __future__ import annotations

import ctypes

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


def plane_product_reference(planes_space, planes_time, xyzt: torch.Tensor,
                            density_n_comp: int):
    """Plain version of K1: JAX ``kplane._plane_product`` + the Density sum.

    Args:
      planes_space: 3 planes (gs[m1], gs[m0], C); planes_time: 3 planes
        (K, gs[m0], C); C = Cd + Ca, density channels first.
      xyzt: (P, 4) normalized coords, time already through normalize_time.
    Returns:
      density feature (P,) = sum of the first Cd product channels, and
      app features (P, Ca) = the remaining channels.
    """
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


def plane_product(planes_space, planes_time, xyzt: torch.Tensor, density_n_comp: int):
    """K1: density feature (P,) and app features (P, Ca) of the six-plane product.

    For CPU tensors this runs :func:`plane_product_reference`.  For CUDA
    tensors it launches ``nvfi_plane_product_fwd`` (csrc/plane_product.cu) or
    raises; ``plane_product.launches`` counts the launches.
    """
    if xyzt.device.type == "cpu":
        return plane_product_reference(planes_space, planes_time, xyzt, density_n_comp)
    if xyzt.device.type != "cuda":
        raise ValueError(f"plane_product: unsupported device {xyzt.device}")
    planes = list(planes_space) + list(planes_time)
    _check_plane_product_args(planes, xyzt, density_n_comp)
    P = xyzt.shape[0]
    C = planes[0].shape[-1]
    density = torch.empty(P, dtype=torch.float32, device=xyzt.device)
    app = torch.empty(P, C - density_n_comp, dtype=torch.float32, device=xyzt.device)
    if P == 0:
        return density, app
    lib = kernels.load()
    hw = (ctypes.c_int * 12)(*[int(d) for p in planes for d in p.shape[:2]])
    with torch.cuda.device(xyzt.device):
        err = lib.nvfi_plane_product_fwd(
            *[p.data_ptr() for p in planes], hw, xyzt.data_ptr(), P, C, density_n_comp,
            density.data_ptr(), app.data_ptr(), kernels.stream_ptr(xyzt.device),
        )
    kernels.check(err, "plane_product_fwd")
    plane_product.launches += 1
    return density, app


plane_product.launches = 0

"""Volume-rendering compositing (kernel K2).

Port of ``nvfi_tpu/ops/compositing.py:17-33`` (``raw2alpha``):
``alpha = 1 - exp(-sigma * dist)``, transmittance is the exclusive cumulative
product of ``1 - alpha + 1e-10`` along the sample axis (the floor kept as
written), and weights are ``alpha * T``.

``composite`` is the wrapper of the hand-written CUDA kernel
``csrc/composite.cu``, which fuses ``raw2alpha`` with the per-ray sums of the
dense eval render (JAX ``kplane.render_rays`` :884-990);
``composite_reference`` is its plain PyTorch version, which the wrapper runs
for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import kernels


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """(alpha, weights, background transmittance) per ray; dist is already
    multiplied by distance_scale."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    one = torch.ones_like(alpha[..., :1])
    T = torch.cumprod(torch.cat([one, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    weights = alpha * T[..., :-1]
    return alpha, weights, T[..., -1:]


def composite_reference(sigma, dist, z_vals, rgb_pts, thres: float, white_bg: bool,
                        far: float):
    """Plain version of K2.

    Args:
      sigma: (N, S) densities, zero outside the box; dist: (N, S) step lengths
        times distance_scale; z_vals: (N, S); rgb_pts: (N, S, 3) shaded colour
        of every sample; thres: rayMarch_weight_thres; far: the far bound.
    Returns:
      weight (N, S), acc (N,), rgb (N, 3), depth (N,).
    """
    _, weight, _ = raw2alpha(sigma, dist)
    app_mask = weight > thres
    acc = torch.sum(weight, dim=-1)
    rgb_pts = torch.where(app_mask[..., None], rgb_pts, 0.0)
    rgb = torch.sum(weight[..., None] * rgb_pts, dim=-2)
    if white_bg:
        rgb = rgb + (1.0 - acc[..., None])
    rgb = torch.clamp(rgb, 0.0, 1.0)
    depth = torch.sum(weight * z_vals, dim=-1) + (1.0 - acc) * far
    return weight, acc, rgb, depth


def _check_composite_args(sigma, dist, z_vals, rgb_pts):
    N, S = sigma.shape if sigma.dim() == 2 else (None, None)
    for name, x, shape in (("sigma", sigma, (N, S)), ("dist", dist, (N, S)),
                           ("z_vals", z_vals, (N, S)), ("rgb_pts", rgb_pts, (N, S, 3))):
        if N is None or tuple(x.shape) != shape:
            raise ValueError(f"composite: {name} has shape {tuple(x.shape)}, "
                             f"want {shape} (sigma must be (N, S))")
        if x.device != sigma.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"composite: {name} must be contiguous float32 on "
                             f"{sigma.device}, got {x.dtype} on {x.device}")


def composite(sigma, dist, z_vals, rgb_pts, thres: float, white_bg: bool, far: float):
    """K2: weight (N, S), acc (N,), rgb (N, 3), depth (N,) of the dense render.

    For CPU tensors this runs :func:`composite_reference`.  For CUDA tensors
    it launches ``nvfi_composite_fwd`` (csrc/composite.cu) or raises;
    ``composite.launches`` counts the launches.
    """
    if sigma.device.type == "cpu":
        return composite_reference(sigma, dist, z_vals, rgb_pts, thres, white_bg, far)
    if sigma.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigma.device}")
    _check_composite_args(sigma, dist, z_vals, rgb_pts)
    N, S = sigma.shape
    kw = dict(dtype=torch.float32, device=sigma.device)
    weight = torch.empty(N, S, **kw)
    acc = torch.empty(N, **kw)
    rgb = torch.empty(N, 3, **kw)
    depth = torch.empty(N, **kw)
    if N == 0:
        return weight, acc, rgb, depth
    lib = kernels.load()
    with torch.cuda.device(sigma.device):
        err = lib.nvfi_composite_fwd(
            sigma.data_ptr(), dist.data_ptr(), z_vals.data_ptr(), rgb_pts.data_ptr(),
            N, S, float(thres), int(bool(white_bg)), float(far),
            weight.data_ptr(), acc.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
            kernels.stream_ptr(sigma.device),
        )
    kernels.check(err, "composite_fwd")
    composite.launches += 1
    return weight, acc, rgb, depth


composite.launches = 0

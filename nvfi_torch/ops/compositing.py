"""Volume-rendering compositing (kernel K2).

Port of ``nvfi_tpu/ops/compositing.py:17-33`` (``raw2alpha``):
``alpha = 1 - exp(-sigma * dist)``, transmittance is the exclusive cumulative
product of ``1 - alpha + 1e-10`` along the sample axis (the floor kept as
written), and weights are ``alpha * T``.

``composite`` is the wrapper of the hand-written CUDA kernel
``csrc/composite.cu``, which fuses ``raw2alpha`` with the per-ray sums of the
dense render (JAX ``kplane.render_rays`` :884-990); its gradient is kernel K2b
(``csrc/composite_bwd.cu``, wrapper ``composite_backward``), reached through a
``torch.autograd.Function``.  ``composite_reference`` and
``composite_backward_reference`` are the plain PyTorch versions, which the
wrappers run for CPU tensors only.

The clip of the composited colour splits its ties evenly: the derivative of
``clip(x, 0, 1)`` is 0.5 at x == 0 and x == 1, as ``jax.grad(jnp.clip)``
gives (``torch.clamp`` alone would pass 1.0).  With a white background every
ray that misses the box composites to exactly 1.0, so the tie is a common
case, not a measure-zero one.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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


class _Clip01(torch.autograd.Function):
    """clip(x, 0, 1) whose derivative is 1 inside (0, 1), 0.5 at exactly 0 or
    1 and 0 outside (the JAX package's rule at the ties)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        inside = ((x > 0) & (x < 1)).to(grad.dtype)
        tie = ((x == 0) | (x == 1)).to(grad.dtype)
        return grad * (inside + 0.5 * tie)


def composite_reference(sigma, dist, z_vals, rgb_pts, thres: float, white_bg: bool,
                        far: float, return_raw: bool = False):
    """Plain version of K2.

    Args:
      sigma: (N, S) densities, zero outside the box; dist: (N, S) step lengths
        times distance_scale; z_vals: (N, S); rgb_pts: (N, S, 3) shaded colour
        of every sample; thres: rayMarch_weight_thres; far: the far bound.
    Returns:
      weight (N, S), acc (N,), rgb (N, 3), depth (N,) and, with
      ``return_raw``, the colour before the clip (N, 3), which the kernel
      stores for its backward.
    """
    _, weight, _ = raw2alpha(sigma, dist)
    app_mask = weight > thres
    acc = torch.sum(weight, dim=-1)
    rgb_pts = torch.where(app_mask[..., None], rgb_pts, 0.0)
    rgb = torch.sum(weight[..., None] * rgb_pts, dim=-2)
    if white_bg:
        rgb = rgb + (1.0 - acc[..., None])
    rgb_raw, rgb = rgb, _Clip01.apply(rgb)
    depth = torch.sum(weight * z_vals, dim=-1) + (1.0 - acc) * far
    if return_raw:
        return weight, acc, rgb, depth, rgb_raw
    return weight, acc, rgb, depth


def _check_composite_args(sigma, dist, z_vals, rgb_pts, **more):
    N, S = sigma.shape if sigma.dim() == 2 else (None, None)
    shapes = {"weight": (N, S), "rgb_raw": (N, 3), "g_rgb": (N, 3), "g_acc": (N,),
              "g_depth": (N,), "g_weight": (N, S)}
    named = [("sigma", sigma, (N, S)), ("dist", dist, (N, S)), ("z_vals", z_vals, (N, S)),
             ("rgb_pts", rgb_pts, (N, S, 3))]
    named += [(k, v, shapes[k]) for k, v in more.items() if v is not None]
    for name, x, shape in named:
        if N is None or tuple(x.shape) != shape:
            raise ValueError(f"composite: {name} has shape {tuple(x.shape)}, "
                             f"want {shape} (sigma must be (N, S))")
        if x.device != sigma.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"composite: {name} must be contiguous float32 on "
                             f"{sigma.device}, got {x.dtype} on {x.device}")


COMPOSITE_MAX_WARPS = 32  # csrc/composite.cu kMaxWarps: warps a block
COMPOSITE_MAX_TILES = 4  # csrc/composite.cu kMaxTiles: tiles of 32 samples a warp holds at once


@dataclass(frozen=True)
class CompositePlan:
    """How K2 is launched: ``warps_per_ray`` warps share a ray, each owning
    ``tiles_per_warp`` tiles of 32 consecutive samples; a block holds
    ``rays_per_block`` rays."""
    warps_per_ray: int
    tiles_per_warp: int
    rays_per_block: int


@functools.lru_cache(maxsize=None)
def composite_target_warps(device_index: int) -> int:
    """Warps in flight that fill the card well: 32 a multiprocessor (4224 on
    an H100's 132)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count * 32


def composite_plan(N: int, S: int, target_warps: int) -> CompositePlan:
    """The launch plan of K2 for N rays of S samples on a card that
    ``target_warps`` warps fill (:func:`composite_target_warps`).

    Where the rays alone give at least half of ``target_warps`` warps (a
    render chunk), one warp streams each ray, tile batch by tile batch.
    Where they are few (a train chunk's 128), several warps share a ray, so
    that about ``target_warps`` warps are in flight, up to a tile each; a
    warp that shares its ray holds its whole segment in registers, at most
    ``COMPOSITE_MAX_TILES`` tiles.  The warps of a ray split its tiles into
    equal contiguous segments, none of them empty.
    """
    tiles = max(1, -(-S // 32))
    want = -(-target_warps // max(N, 1))
    need = -(-tiles // COMPOSITE_MAX_TILES)
    if want <= 2 or need > COMPOSITE_MAX_WARPS:
        return CompositePlan(warps_per_ray=1, tiles_per_warp=tiles, rays_per_block=8)
    warps = min(max(need, want), tiles, COMPOSITE_MAX_WARPS)
    per_warp = -(-tiles // warps)
    warps = -(-tiles // per_warp)
    return CompositePlan(warps_per_ray=warps, tiles_per_warp=per_warp,
                         rays_per_block=max(1, 16 // warps))


def _launch_composite(sigma, dist, z_vals, rgb_pts, thres, white_bg, far, want_raw):
    """Check the arguments, allocate the outputs and launch K2.  With
    ``want_raw`` the kernel also stores the colour before the clip, which the
    backward kernel reads."""
    if sigma.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigma.device}")
    _check_composite_args(sigma, dist, z_vals, rgb_pts)
    N, S = sigma.shape
    kw = dict(dtype=torch.float32, device=sigma.device)
    weight = torch.empty(N, S, **kw)
    acc = torch.empty(N, **kw)
    rgb = torch.empty(N, 3, **kw)
    depth = torch.empty(N, **kw)
    rgb_raw = torch.empty(N, 3, **kw) if want_raw else None
    if N == 0:
        return weight, acc, rgb, depth, rgb_raw
    plan = composite_plan(N, S, composite_target_warps(sigma.device.index))
    lib = kernels.load()
    with torch.cuda.device(sigma.device):
        err = lib.nvfi_composite_fwd(
            sigma.data_ptr(), dist.data_ptr(), z_vals.data_ptr(), rgb_pts.data_ptr(),
            N, S, plan.warps_per_ray, plan.tiles_per_warp, plan.rays_per_block,
            float(thres), int(bool(white_bg)), float(far),
            weight.data_ptr(), acc.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
            None if rgb_raw is None else rgb_raw.data_ptr(),
            kernels.stream_ptr(sigma.device),
        )
    kernels.check(err, "composite_fwd")
    composite.launches += 1
    return weight, acc, rgb, depth, rgb_raw


class _Composite(torch.autograd.Function):
    """K2 forward, K2b backward.  Without a graph (``no_grad`` /
    ``inference_mode``, or no input that requires grad) nothing is saved and
    the colour before the clip is not stored."""

    @staticmethod
    def forward(ctx, sigma, dist, z_vals, rgb_pts, thres, white_bg, far):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("composite: dist and z_vals get no gradient; detach them")
        want = ctx.needs_input_grad[0] or ctx.needs_input_grad[3]
        weight, acc, rgb, depth, rgb_raw = _launch_composite(
            sigma, dist, z_vals, rgb_pts, thres, white_bg, far, want_raw=want)
        if want:
            ctx.save_for_backward(sigma, dist, z_vals, rgb_pts, weight, rgb_raw)
            ctx.consts = (thres, white_bg, far)
            ctx.set_materialize_grads(False)
        return weight, acc, rgb, depth

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_weight, g_acc, g_rgb, g_depth):
        sigma, dist, z_vals, rgb_pts, weight, rgb_raw = ctx.saved_tensors
        contiguous = [None if g is None else g.contiguous()
                      for g in (g_rgb, g_acc, g_depth, g_weight)]
        grad_sigma, grad_rgb_pts = composite_backward(
            sigma, dist, z_vals, rgb_pts, weight, rgb_raw, *contiguous, *ctx.consts)
        return grad_sigma, None, None, grad_rgb_pts, None, None, None


def composite(sigma, dist, z_vals, rgb_pts, thres: float, white_bg: bool, far: float):
    """K2: weight (N, S), acc (N,), rgb (N, 3), depth (N,) of the dense render.

    For CPU tensors this runs :func:`composite_reference` under ordinary
    autograd.  For CUDA tensors it launches ``nvfi_composite_fwd``
    (csrc/composite.cu) or raises, and its gradient with respect to ``sigma``
    and ``rgb_pts`` is :func:`composite_backward` (K2b); ``composite.launches``
    counts the forward launches.
    """
    if sigma.device.type == "cpu":
        return composite_reference(sigma, dist, z_vals, rgb_pts, thres, white_bg, far)
    return _Composite.apply(sigma, dist, z_vals, rgb_pts, thres, white_bg, far)


composite.launches = 0


def composite_backward_reference(sigma, dist, z_vals, rgb_pts, g_rgb, g_acc, g_depth, g_weight,
                                 thres: float, white_bg: bool, far: float):
    """Plain version of K2b: ``torch.autograd.grad`` through
    :func:`composite_reference`.  Any of the incoming grads may be None
    (zeros).  Returns (grad_sigma (N, S), grad_rgb_pts (N, S, 3))."""
    with torch.enable_grad():
        sigma = sigma.detach().requires_grad_(True)
        rgb_pts = rgb_pts.detach().requires_grad_(True)
        weight, acc, rgb, depth = composite_reference(sigma, dist, z_vals, rgb_pts, thres,
                                                      white_bg, far)
        pairs = [(o, g) for o, g in ((rgb, g_rgb), (acc, g_acc), (depth, g_depth),
                                     (weight, g_weight)) if g is not None]
        if not pairs:
            return torch.zeros_like(sigma), torch.zeros_like(rgb_pts)
        return torch.autograd.grad([o for o, _ in pairs], [sigma, rgb_pts],
                                   [g for _, g in pairs])


def composite_backward(sigma, dist, z_vals, rgb_pts, weight, rgb_raw, g_rgb, g_acc, g_depth,
                       g_weight, thres: float, white_bg: bool, far: float):
    """K2b: (grad_sigma (N, S), grad_rgb_pts (N, S, 3)) of :func:`composite`.

    Args:
      sigma, dist, z_vals, rgb_pts: the forward's inputs; weight (N, S): its
        output; rgb_raw (N, 3): the colour before the clip, which the forward
        kernel stores when a gradient is wanted (may be None without g_rgb).
      g_rgb (N, 3), g_acc (N,), g_depth (N,), g_weight (N, S): the incoming
        grads; each may be None (zeros).
    For CPU tensors this runs :func:`composite_backward_reference` (which
    recomputes ``weight`` and ``rgb_raw``).  For CUDA tensors it launches
    ``nvfi_composite_bwd`` (csrc/composite_bwd.cu) or raises;
    ``composite_backward.launches`` counts the launches.
    """
    if sigma.device.type == "cpu":
        return composite_backward_reference(sigma, dist, z_vals, rgb_pts, g_rgb, g_acc, g_depth,
                                            g_weight, thres, white_bg, far)
    if sigma.device.type != "cuda":
        raise ValueError(f"composite_backward: unsupported device {sigma.device}")
    if g_rgb is not None and rgb_raw is None:
        raise ValueError("composite_backward: g_rgb needs rgb_raw, the colour before the clip")
    _check_composite_args(sigma, dist, z_vals, rgb_pts, weight=weight, rgb_raw=rgb_raw,
                          g_rgb=g_rgb, g_acc=g_acc, g_depth=g_depth, g_weight=g_weight)
    N, S = sigma.shape
    grad_sigma = torch.empty_like(sigma)
    grad_rgb_pts = torch.empty_like(rgb_pts)
    if N == 0:
        return grad_sigma, grad_rgb_pts
    ptr = [None if x is None else x.data_ptr()
           for x in (rgb_raw, g_rgb, g_acc, g_depth, g_weight)]
    lib = kernels.load()
    with torch.cuda.device(sigma.device):
        err = lib.nvfi_composite_bwd(
            sigma.data_ptr(), dist.data_ptr(), z_vals.data_ptr(), rgb_pts.data_ptr(),
            weight.data_ptr(), *ptr, N, S, float(thres), int(bool(white_bg)), float(far),
            grad_sigma.data_ptr(), grad_rgb_pts.data_ptr(), kernels.stream_ptr(sigma.device),
        )
    kernels.check(err, "composite_bwd")
    composite_backward.launches += 1
    return grad_sigma, grad_rgb_pts


composite_backward.launches = 0

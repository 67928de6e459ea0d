"""Volume-rendering compositing (kernel K2).

Port of ``nvfi_tpu/ops/compositing.py:17-33`` (``raw2alpha``):
``alpha = 1 - exp(-sigma * dist)``, transmittance is the exclusive cumulative
product of ``1 - alpha + 1e-10`` along the sample axis (the floor kept as
written), and weights are ``alpha * T``.

``composite`` is the wrapper of the hand-written CUDA kernel
``csrc/composite.cu``, which fuses ``raw2alpha`` with the per-ray sums of the
dense render (JAX ``kplane.render_rays`` :884-990); its gradient is kernel K2b
(``csrc/composite_bwd.cu``, wrapper ``composite_backward``), reached through a
``torch.autograd.Function``.  Their launch plans (``composite_plan``,
``composite_bwd_plan``) let several warps share a ray where the rays are
few.  ``composite_reference`` and
``composite_backward_reference`` are the plain PyTorch versions, which the
wrappers run for CPU tensors only.

``composite_weights`` is the colourless arm of K2 (the same kernel with no
colour pointers) and ``composite_weights_backward`` that of K2b: weight, acc
and depth, and grad_sigma from their grads.  The per-ray top-K shade of the
turbo render (JAX ``kplane.py:884-954``) composites its colour from the
selected samples afterwards, so it needs no (N, S, 3) colour here.

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
    """Shapes, dtype, device and layout; ``rgb_pts`` None is the colourless arm."""
    N, S = sigma.shape if sigma.dim() == 2 else (None, None)
    shapes = {"weight": (N, S), "rgb_raw": (N, 3), "g_rgb": (N, 3), "g_acc": (N,),
              "g_depth": (N,), "g_weight": (N, S)}
    named = [("sigma", sigma, (N, S)), ("dist", dist, (N, S)), ("z_vals", z_vals, (N, S))]
    if rgb_pts is not None:
        named.append(("rgb_pts", rgb_pts, (N, S, 3)))
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


def composite_bwd_plan(N: int, S: int, target_warps: int) -> CompositePlan:
    """The launch plan of K2b (csrc/composite_bwd.cu) for N rays of S samples.

    Every warp holds its segment, at most ``COMPOSITE_MAX_TILES`` tiles, in
    registers through both passes, so a ray takes at least
    ceil(tiles / COMPOSITE_MAX_TILES) warps: 6 a ray at a render chunk's 4096
    rays of 686 samples.  Where the rays are few, more, so that about
    ``target_warps`` warps are in flight, up to a tile each (K2's rule): 22 a
    ray at a train chunk's 128.  A block holds one ray where its warps are
    more than four.  Rays longer than COMPOSITE_MAX_WARPS segments (4096
    samples) are refused.
    """
    tiles = max(1, -(-S // 32))
    need = -(-tiles // COMPOSITE_MAX_TILES)
    if need > COMPOSITE_MAX_WARPS:
        raise ValueError(f"composite_backward: rays of {S} samples, more than K2b takes "
                         f"({COMPOSITE_MAX_WARPS * COMPOSITE_MAX_TILES * 32})")
    want = -(-target_warps // max(N, 1))
    warps = need if want <= 2 else min(max(need, want), tiles, COMPOSITE_MAX_WARPS)
    per_warp = -(-tiles // warps)
    warps = -(-tiles // per_warp)
    return CompositePlan(warps_per_ray=warps, tiles_per_warp=per_warp,
                         rays_per_block=max(1, 8 // warps))


def _launch_composite(sigma, dist, z_vals, rgb_pts, thres, white_bg, far, want_raw):
    """Check the arguments, allocate the outputs and launch K2.  With
    ``want_raw`` the kernel also stores the colour before the clip, which the
    backward kernel reads.  With ``rgb_pts`` None the colourless arm runs:
    rgb and rgb_raw come back None, and the launch counts on
    ``composite_weights``."""
    if sigma.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigma.device}")
    _check_composite_args(sigma, dist, z_vals, rgb_pts)
    colour = rgb_pts is not None
    N, S = sigma.shape
    kw = dict(dtype=torch.float32, device=sigma.device)
    weight = torch.empty(N, S, **kw)
    acc = torch.empty(N, **kw)
    rgb = torch.empty(N, 3, **kw) if colour else None
    depth = torch.empty(N, **kw)
    rgb_raw = torch.empty(N, 3, **kw) if want_raw and colour else None
    if N == 0:
        return weight, acc, rgb, depth, rgb_raw
    plan = composite_plan(N, S, composite_target_warps(sigma.device.index))
    lib = kernels.load()
    with torch.cuda.device(sigma.device):
        err = lib.nvfi_composite_fwd(
            sigma.data_ptr(), dist.data_ptr(), z_vals.data_ptr(), _ptr(rgb_pts),
            N, S, plan.warps_per_ray, plan.tiles_per_warp, plan.rays_per_block,
            float(thres), int(bool(white_bg)), float(far),
            weight.data_ptr(), acc.data_ptr(), _ptr(rgb), depth.data_ptr(), _ptr(rgb_raw),
            kernels.stream_ptr(sigma.device),
        )
    kernels.check(err, "composite_fwd")
    if colour:
        composite.launches += 1
    else:
        composite_weights.launches += 1
    return weight, acc, rgb, depth, rgb_raw


def _ptr(x):
    return None if x is None else x.data_ptr()


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
        # without g_rgb and g_weight the colours reach no output: zeros
        grads = torch.autograd.grad([o for o, _ in pairs], [sigma, rgb_pts],
                                    [g for _, g in pairs], allow_unused=True)
        return tuple(torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, (sigma, rgb_pts)))


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
    ``nvfi_composite_bwd`` (csrc/composite_bwd.cu) with the plan of
    :func:`composite_bwd_plan` or raises; ``composite_backward.launches``
    counts the launches.
    """
    if sigma.device.type == "cpu":
        return composite_backward_reference(sigma, dist, z_vals, rgb_pts, g_rgb, g_acc, g_depth,
                                            g_weight, thres, white_bg, far)
    if g_rgb is not None and rgb_raw is None:
        raise ValueError("composite_backward: g_rgb needs rgb_raw, the colour before the clip")
    return _launch_composite_bwd(sigma, dist, z_vals, rgb_pts, weight, rgb_raw, g_rgb, g_acc,
                                 g_depth, g_weight, thres, white_bg, far)


composite_backward.launches = 0


def _launch_composite_bwd(sigma, dist, z_vals, rgb_pts, weight, rgb_raw, g_rgb, g_acc, g_depth,
                          g_weight, thres, white_bg, far):
    """Check the arguments, allocate the grads and launch K2b: both arms
    (``rgb_pts`` None: the colourless arm, no grad_rgb_pts, counted on
    ``composite_weights_backward``)."""
    if sigma.device.type != "cuda":
        raise ValueError(f"composite_backward: unsupported device {sigma.device}")
    _check_composite_args(sigma, dist, z_vals, rgb_pts, weight=weight, rgb_raw=rgb_raw,
                          g_rgb=g_rgb, g_acc=g_acc, g_depth=g_depth, g_weight=g_weight)
    colour = rgb_pts is not None
    N, S = sigma.shape
    grad_sigma = torch.empty_like(sigma)
    grad_rgb_pts = torch.empty_like(rgb_pts) if colour else None
    if N == 0:
        return grad_sigma, grad_rgb_pts
    plan = composite_bwd_plan(N, S, composite_target_warps(sigma.device.index))
    lib = kernels.load()
    with torch.cuda.device(sigma.device):
        err = lib.nvfi_composite_bwd(
            sigma.data_ptr(), dist.data_ptr(), z_vals.data_ptr(), _ptr(rgb_pts),
            weight.data_ptr(), *map(_ptr, (rgb_raw, g_rgb, g_acc, g_depth, g_weight)), N, S,
            plan.warps_per_ray, plan.tiles_per_warp, plan.rays_per_block, float(thres),
            int(bool(white_bg)), float(far), grad_sigma.data_ptr(), _ptr(grad_rgb_pts),
            kernels.stream_ptr(sigma.device),
        )
    kernels.check(err, "composite_bwd")
    if colour:
        composite_backward.launches += 1
    else:
        composite_weights_backward.launches += 1
    return grad_sigma, grad_rgb_pts


# ---------------------------------------------------------------------------
# the colourless arms: weight, acc and depth, and grad_sigma from their grads
# ---------------------------------------------------------------------------

def composite_weights_reference(sigma, dist, z_vals, far: float):
    """Plain version of K2's colourless arm: weight (N, S), acc (N,), depth
    (N,), the same values as :func:`composite_reference`'s."""
    _, weight, _ = raw2alpha(sigma, dist)
    acc = torch.sum(weight, dim=-1)
    depth = torch.sum(weight * z_vals, dim=-1) + (1.0 - acc) * far
    return weight, acc, depth


class _CompositeWeights(torch.autograd.Function):
    """K2's colourless arm forward, K2b's colourless arm backward."""

    @staticmethod
    def forward(ctx, sigma, dist, z_vals, far):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("composite_weights: dist and z_vals get no gradient; detach them")
        weight, acc, _, depth, _ = _launch_composite(sigma, dist, z_vals, None, 0.0, False, far,
                                                     want_raw=False)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(sigma, dist, z_vals, weight)
            ctx.far = far
            ctx.set_materialize_grads(False)
        return weight, acc, depth

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_weight, g_acc, g_depth):
        sigma, dist, z_vals, weight = ctx.saved_tensors
        grads = [None if g is None else g.contiguous() for g in (g_acc, g_depth, g_weight)]
        grad_sigma = composite_weights_backward(sigma, dist, z_vals, weight, *grads, ctx.far)
        return grad_sigma, None, None, None


def composite_weights(sigma, dist, z_vals, far: float):
    """K2's colourless arm: weight (N, S), acc (N,), depth (N,), without any
    colour.  For CPU tensors this runs :func:`composite_weights_reference`
    under ordinary autograd.  For CUDA tensors it launches
    ``nvfi_composite_fwd`` with null colour pointers or raises, and its
    gradient with respect to ``sigma`` is :func:`composite_weights_backward`;
    ``composite_weights.launches`` counts the forward launches."""
    if sigma.device.type == "cpu":
        return composite_weights_reference(sigma, dist, z_vals, far)
    return _CompositeWeights.apply(sigma, dist, z_vals, far)


composite_weights.launches = 0


def composite_weights_backward_reference(sigma, dist, z_vals, g_acc, g_depth, g_weight,
                                         far: float):
    """Plain version of K2b's colourless arm: ``torch.autograd.grad`` through
    :func:`composite_weights_reference`; any grad may be None (zeros).
    Returns grad_sigma (N, S)."""
    with torch.enable_grad():
        sigma = sigma.detach().requires_grad_(True)
        weight, acc, depth = composite_weights_reference(sigma, dist, z_vals, far)
        pairs = [(o, g) for o, g in ((acc, g_acc), (depth, g_depth), (weight, g_weight))
                 if g is not None]
        if not pairs:
            return torch.zeros_like(sigma)
        (grad,) = torch.autograd.grad([o for o, _ in pairs], [sigma], [g for _, g in pairs])
        return grad


def composite_weights_backward(sigma, dist, z_vals, weight, g_acc, g_depth, g_weight,
                               far: float):
    """K2b's colourless arm: grad_sigma (N, S) of :func:`composite_weights`
    from g_acc (N,), g_depth (N,), g_weight (N, S), each of which may be None
    (zeros); ``weight`` is the forward's output.  For CPU tensors this runs
    :func:`composite_weights_backward_reference`.  For CUDA tensors it
    launches ``nvfi_composite_bwd`` with null colour pointers or raises;
    ``composite_weights_backward.launches`` counts the launches."""
    if sigma.device.type == "cpu":
        return composite_weights_backward_reference(sigma, dist, z_vals, g_acc, g_depth,
                                                    g_weight, far)
    return _launch_composite_bwd(sigma, dist, z_vals, None, weight, None, None, g_acc, g_depth,
                                 g_weight, 0.0, False, far)[0]


composite_weights_backward.launches = 0


# ---------------------------------------------------------------------------
# Multi-field compositing (plain PyTorch: nothing in either package calls it
# on a path, so it has no kernel)
# ---------------------------------------------------------------------------

def raw2alpha_seg(sigma: torch.Tensor, dist: torch.Tensor):
    """Compositing of several fields (JAX ``compositing.py:36-48``): the
    transmittance is the product over the fields.

    sigma (F, R, S) per-field densities, dist (R, S).  Returns alpha
    (F, R, S), weights (F, R, S), bg_T (R, 1)."""
    alpha = 1.0 - torch.exp(-sigma * dist[None])
    one = torch.ones_like(alpha[..., :1])
    T = torch.cumprod(torch.cat([one, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    T = torch.prod(T, dim=0)
    weights = alpha * T[None, :, :-1]
    return alpha, weights, T[:, -1:]


def alpha2weights(alpha: torch.Tensor) -> torch.Tensor:
    """Weights from alphas (..., S) (JAX ``compositing.py:51-55``)."""
    one = torch.ones_like(alpha[..., :1])
    T = torch.cumprod(torch.cat([one, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    return alpha * T[..., :-1]

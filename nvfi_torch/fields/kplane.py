"""Keyframe K-plane dynamic radiance field: the dense render (eval and
training), the alpha mask (occupancy volume) that prunes it, and the plane
regularizers.

Port of ``nvfi_tpu/fields/kplane.py``.  Three *space* planes (xy, xz, yz)
times three *space-time* planes (zt, yt, xt), density and appearance channels
merged in one channels-last plane per orientation (density first); samples
off a keyframe are advected back to the nearest keyframe time through the
velocity field with RK2 over a static step count.

Ported here: ``KPlaneMeta`` and its derived step counts, ``init_params``,
the coordinate helpers, ``field_features`` (kernel K1 plus the app basis),
``feature2density``, ``integrate_pos``, box ``sample_ray`` and the dense
branch of ``render_rays`` (kernel K2 for compositing), with ``alpha_state``
pruning (``sample_alpha``, kernel K3, for eval; ``sample_occupied``, kernel
K4, for training with ``train_occupancy_prune``); the mask build
``compute_dense_alpha`` / ``update_alpha_mask`` over ``density_feature``
(kernel K1d) and ``corner_dilate``; ``density_l1`` and the TV losses.  A
training render runs under autograd: K1 and K2 carry their backward kernels
(K1b, K2b), and what JAX draws from its key (the stratified jitter, the
background coin) comes in as arguments.
``compute_dtype = "bfloat16"`` is the JAX package's mixed precision: the
render casts the MLP and decoder leaves to bf16 for its compute
(``cast_compute``; the planes stay float32, and the gradients land in float32
on the masters), and K1, K1d and K1b run their bf16 arms.
Options that select another path raise ``NotImplementedError`` naming the
ROADMAP.md item that will port them; none silently takes another path.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.compositing import composite
from ..ops import occupancy
from ..ops.grid_sample import MAT_SPACE, MAT_TIME, plane_product, plane_product_density
from ..ops.resize import max_pool3d_same
from .mlp import linear_init
from .shaders import (DENSITY_DATA_DIM, init_shader, make_density_decoder, make_shader,
                      unported)
from . import velocity as vel_mod
from .velocity import VelGate


# ---------------------------------------------------------------------------
# Static metadata
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KPlaneMeta:
    """Static structure of a keyframe K-plane scene.

    The same fields and defaults as the JAX package's ``KPlaneMeta``, so both
    read one checkpoint sidecar.  Fields the port does not run yet are kept
    and refused by ``render_rays`` when they would change the path.
    """

    grid_size: tuple  # (gx, gy, gz)
    num_keyframes: int
    tmax: float
    aabb: tuple  # ((x0,y0,z0),(x1,y1,z1))
    near_far: tuple
    density_n_comp: int
    app_n_comp: int
    app_dim: int
    density_shift: float
    distance_scale: float
    alpha_mask_thres: float
    raymarch_weight_thres: float
    fea2dense: str = "softplus"
    density_mode: str = "Density"
    shading_mode: str = "MLP_PE"
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    feature_c: int = 128
    step_ratio: float = 0.5
    max_n_samples: int = 1024
    use_vel: bool = True
    vel_hidden: int = 128
    dt_scale: float = 1.0
    vel_gate: VelGate = field(default_factory=lambda: VelGate("aabb", 0.03))
    mask_dim: int = 0
    alpha_grid: tuple = ()
    train_occupancy_prune: bool = False
    compute_dtype: str = "float32"
    ray_sampling: str = "box"  # 'box' | 'ndc' | 'contracted'
    parity_sampling: bool = False  # reference's literal ray-start rule
    shade_fraction: float = 1.0
    block_budget: float = 1.0
    sample_block: int = 64
    # both bit-identical TPU gather levers: the port's K1 reads every channel
    # of every plane in one pass whatever they say
    gather_fuse: bool = False
    shade_reuse: bool = True

    @property
    def aabb_np(self) -> np.ndarray:
        return np.asarray(self.aabb, dtype=np.float32)

    @property
    def aabb_size(self) -> np.ndarray:
        a = self.aabb_np
        return a[1] - a[0]

    @property
    def units(self) -> np.ndarray:
        return self.aabb_size / (np.asarray(self.grid_size) - 1)

    @property
    def step_size(self) -> float:
        return float(np.mean(self.units) * self.step_ratio)

    @property
    def n_samples(self) -> int:
        diag = float(np.linalg.norm(self.aabb_size))
        return min(self.max_n_samples, int(diag / self.step_size) + 1)

    @property
    def time_scale_factor(self) -> float:
        """Keyframe spacing Delta."""
        return self.tmax / (self.num_keyframes - 1) if self.num_keyframes > 1 else 1.0

    @property
    def dt_max(self) -> float:
        if self.num_keyframes <= 1:
            return 1.0
        return 0.5 * self.tmax / (self.num_keyframes - 1) * self.dt_scale

    @property
    def snap_steps(self) -> int:
        """Steps covering one post-snap offset (|offset| <= Delta/2)."""
        return max(1, int(math.ceil(1.0 / self.dt_scale - 1e-9)))

    @property
    def max_adv_steps(self) -> int:
        """Static RK2 step bound for a full [0, tmax] offset."""
        return max(1, int(math.ceil(self.tmax / self.dt_max - 1e-9)))

    @property
    def transfer_adv_steps(self) -> int:
        """Static RK2 step bound for advecting back to t = 0 from any t in [0, 1]."""
        return max(1, int(math.ceil(1.0 / self.dt_max - 1e-9)))

    @property
    def render_adv_steps(self) -> int:
        """Static RK2 step bound for eval renders at any t in [0, 1]: past
        tmax the snap clamps to the last keyframe and the offset grows to
        1 - tmax."""
        if self.num_keyframes <= 1 or self.tmax <= 0:
            return 1
        return max(1, int(math.ceil((1.0 - self.tmax) / self.dt_max - 1e-9))
                   + self.snap_steps)


def render_steps_for_time(meta: KPlaneMeta, t: float, transfer: bool = False) -> int:
    """Exact static RK2 step count for an eval render at a host-known time t.
    Extra steps are dt = 0 no-ops, so any count above this is exact too."""
    if not meta.use_vel or meta.num_keyframes <= 1:
        return 1
    if transfer:
        return max(1, int(math.ceil(float(t) / meta.dt_max - 1e-9)))
    if float(t) <= meta.tmax + 1e-6:
        return meta.snap_steps
    return max(1, int(math.ceil((float(t) - meta.tmax) / meta.dt_max - 1e-9))
               + meta.snap_steps)


def eval_exact_meta(meta: KPlaneMeta) -> KPlaneMeta:
    """Strip training-time turbo budgets off a meta for exact eval renders."""
    return replace(meta, train_occupancy_prune=False, block_budget=1.0,
                   shade_fraction=1.0)


def meta_from_cfg(nvfi_cfg, aabb, grid_size, near_far) -> KPlaneMeta:
    """Build meta from a reference-schema ``cfg.nvfi`` block."""
    if "sur_x" in nvfi_cfg:
        aabb_np = np.asarray(aabb, dtype=np.float64)
        sur = np.stack(
            [np.asarray(nvfi_cfg[k], dtype=np.float64) for k in ("sur_x", "sur_y", "sur_z")],
            axis=-1,
        )  # (2,3)
        bounds = (sur - aabb_np[0]) * 2.0 / (aabb_np[1] - aabb_np[0]) - 1.0
        gate = VelGate("sur", bounds=(tuple(bounds[0].tolist()), tuple(bounds[1].tolist())),
                       world=(tuple(sur[0].tolist()), tuple(sur[1].tolist())))
    else:
        gate = VelGate("aabb", float(nvfi_cfg.get("eps", 0.03)))
    # lenient float: a shipped reference config carries "0.75 4" (a stray
    # token) that YAML parses as a string; take the first token
    tmax_raw = nvfi_cfg.tmax
    tmax = float(str(tmax_raw).split()[0]) if isinstance(tmax_raw, str) else float(tmax_raw)
    return KPlaneMeta(
        grid_size=tuple(int(g) for g in grid_size),
        num_keyframes=int(nvfi_cfg.num_keyframes),
        tmax=tmax,
        aabb=tuple(tuple(float(v) for v in row) for row in np.asarray(aabb)),
        near_far=tuple(float(v) for v in near_far),
        density_n_comp=int(nvfi_cfg.density_n_comp[0]),
        app_n_comp=int(nvfi_cfg.appearance_n_comp[0]),
        app_dim=int(nvfi_cfg.app_dim),
        density_shift=float(nvfi_cfg.density_shift),
        distance_scale=float(nvfi_cfg.distance_scale),
        alpha_mask_thres=float(nvfi_cfg.alphaMask_thres),
        raymarch_weight_thres=float(nvfi_cfg.rayMarch_weight_thres),
        fea2dense=str(nvfi_cfg.fea2denseAct),
        density_mode=str(nvfi_cfg.densityMode),
        shading_mode=str(nvfi_cfg.shadingMode),
        pos_pe=int(nvfi_cfg.pos_pe),
        view_pe=int(nvfi_cfg.view_pe),
        fea_pe=int(nvfi_cfg.fea_pe),
        feature_c=int(nvfi_cfg.featureC),
        step_ratio=float(nvfi_cfg.step_ratio),
        max_n_samples=int(nvfi_cfg.max_n_samples),
        use_vel=bool(nvfi_cfg.use_vel),
        vel_hidden=int(nvfi_cfg.get("vel_hidden", 128)),
        dt_scale=float(nvfi_cfg.get("dt_scale", 1.0)),
        vel_gate=gate,
        compute_dtype=str(nvfi_cfg.get("compute_dtype", "float32")),
        train_occupancy_prune=bool(nvfi_cfg.get("train_occupancy_prune", False)),
        ray_sampling="contracted" if nvfi_cfg.get("contract_ray", False) else "box",
        parity_sampling=bool(nvfi_cfg.get("parity_sampling", False)),
        block_budget=float(nvfi_cfg.get("block_budget", 1.0)),
        shade_fraction=float(nvfi_cfg.get("shade_fraction", 1.0)),
        sample_block=int(nvfi_cfg.get("sample_block", 64)),
        shade_reuse=bool(nvfi_cfg.get("shade_reuse", True)),
        gather_fuse=bool(nvfi_cfg.get("gather_fuse", False)),
    )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def map_params(fn, tree):
    """Apply ``fn`` to every leaf of a param tree (dicts, lists, None kept)."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def init_params(generator: torch.Generator, meta: KPlaneMeta, device="cuda") -> dict:
    """Scene params in the JAX package's pytree layout.

    Drawn on the CPU from ``generator`` (so a seed gives the same params on
    every device), then moved to ``device``.  Distributions match the JAX
    package: density space channels U(0.1, 0.5) x 0.8 (softplus) or x 0.5,
    app channels U(0.1, 0.5) x 0.1, time planes ones, linears U(+-1/sqrt(in)).
    The values differ from JAX's for the same seed: carry JAX params across
    with ``train.checkpoint.params_from_numpy`` where equality matters.
    """
    dev = resolve_device(device)
    gs = meta.grid_size
    K = meta.num_keyframes
    C = meta.density_n_comp + meta.app_n_comp
    density_scale = 0.8 if meta.fea2dense == "softplus" else 0.5

    def uniform(*shape):
        return torch.rand(*shape, generator=generator) * 0.4 + 0.1

    def space_plane(i):
        m0, m1 = MAT_SPACE[i]
        d = density_scale * uniform(gs[m1], gs[m0], meta.density_n_comp)
        a = 0.1 * uniform(gs[m1], gs[m0], meta.app_n_comp)
        return torch.cat([d, a], dim=-1)

    params = {
        "planes_space": [space_plane(i) for i in range(3)],
        "planes_time": [torch.ones(K, gs[MAT_TIME[i][0]], C) for i in range(3)],
        "basis_mat": linear_init(generator, meta.app_n_comp, meta.app_dim, bias=False),
        "basis_mat_density": linear_init(
            generator, meta.density_n_comp, DENSITY_DATA_DIM[meta.density_mode], bias=False
        ),
        "shader": init_shader(
            generator, meta.shading_mode, meta.app_dim, meta.view_pe, meta.pos_pe,
            meta.fea_pe, meta.feature_c,
        ),
    }
    if meta.use_vel:
        params["vel"] = vel_mod.init_velocity_params(generator, meta.vel_hidden)
    return map_params(lambda x: x.to(dev), params)


# ---------------------------------------------------------------------------
# Compute precision
# ---------------------------------------------------------------------------

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(meta: KPlaneMeta) -> torch.dtype:
    """The torch dtype of ``meta.compute_dtype``; other dtypes are refused."""
    if meta.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"nvfi_torch: compute_dtype={meta.compute_dtype!r} is not "
                                  "ported yet (ROADMAP.md A4: float32 and bfloat16 are)")
    return COMPUTE_DTYPES[meta.compute_dtype]


def cast_compute(params, meta: KPlaneMeta):
    """Every float32 leaf except the planes, cast to the compute dtype (the
    params themselves for float32).

    The cast is an ordinary autograd op, so a loss's gradients flow through it
    and land in float32 on the master leaves, which the optimizer updates: the
    JAX package's bf16-compute / f32-state recipe.  The planes stay float32:
    the lookup kernels round the gathered rows instead."""
    dt = _compute_dtype(meta)
    if dt == torch.float32:
        return params
    return {k: v if k in ("planes_space", "planes_time") else
            map_params(lambda x: x.to(dt) if x.dtype == torch.float32 else x, v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Coordinate helpers
# ---------------------------------------------------------------------------

def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device.  Dividing by a tensor (not a
    Python float) keeps the division exact on CUDA, where a scalar divisor is
    turned into a multiply by its reciprocal; keyframe snapping rounds at .5
    ties and must see the JAX package's quotient."""
    return torch.as_tensor(np.asarray(value, np.float32), device=like.device)


def normalize_coord(meta: KPlaneMeta, xyz: torch.Tensor) -> torch.Tensor:
    a = meta.aabb_np
    inv = 2.0 / (a[1] - a[0])
    return (xyz - _f32(a[0], xyz)) * _f32(inv, xyz) - 1.0


def denormalize_coord(meta: KPlaneMeta, xyz_norm: torch.Tensor) -> torch.Tensor:
    return occupancy.denormalize(xyz_norm, meta.aabb_np)


def normalize_time(meta: KPlaneMeta, t: torch.Tensor) -> torch.Tensor:
    if meta.num_keyframes == 1 or meta.tmax == 0:
        return t * 0.0
    return t * 2.0 / _f32(meta.tmax, t) - 1.0


def snap_to_keyframe(meta: KPlaneMeta, t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest keyframe time (torch.round is half-to-even, as
    jnp.round)."""
    delta = meta.time_scale_factor
    return torch.round(torch.clamp(t / _f32(delta, t), 0.0, meta.num_keyframes - 1)) * delta


# ---------------------------------------------------------------------------
# Feature evaluation
# ---------------------------------------------------------------------------

def field_features(params, meta: KPlaneMeta, xyzt: torch.Tensor):
    """Density feature (..., 1) and app feature (..., app_dim) from one pass of
    kernel K1 (the JAX ``_plane_product`` + ``_decode_density`` sum), then the
    app basis as a plain matmul, as the JAX package leaves it to XLA.  In
    bf16 the density is summed in float32 and the app basis is a bf16 matmul."""
    if meta.density_mode != "Density":
        raise unported("densityMode", meta.density_mode)
    batch = xyzt.shape[:-1]
    density, app = plane_product(params["planes_space"], params["planes_time"],
                                 xyzt.reshape(-1, 4).contiguous(), meta.density_n_comp,
                                 compute_dtype=_compute_dtype(meta))
    app = app @ params["basis_mat"]["w"].to(app.dtype)
    return density.reshape(*batch, 1), app.reshape(*batch, -1)


def density_feature(params, meta: KPlaneMeta, xyzt: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> density feature (..., 1) float32 from kernel K1d, which
    reads only the density channels of the merged planes (the JAX
    ``density_feature`` slices them out before the gather), in the arm of
    the compute dtype."""
    if meta.density_mode != "Density":
        raise unported("densityMode", meta.density_mode)
    batch = xyzt.shape[:-1]
    density = plane_product_density(params["planes_space"], params["planes_time"],
                                    xyzt.reshape(-1, 4).contiguous(), meta.density_n_comp,
                                    compute_dtype=_compute_dtype(meta))
    return density.reshape(*batch, 1)


def feature2density(meta: KPlaneMeta, density_features: torch.Tensor) -> torch.Tensor:
    x = make_density_decoder(meta.density_mode)(density_features)
    if meta.fea2dense == "softplus":
        return F.softplus(x + meta.density_shift)
    if meta.fea2dense == "relu":
        return F.relu(x)
    if meta.fea2dense == "relu_abs":
        return torch.abs(x)
    raise ValueError(meta.fea2dense)


# ---------------------------------------------------------------------------
# Velocity advection (RK2, static step count)
# ---------------------------------------------------------------------------

def integrate_pos(params, meta: KPlaneMeta, xyz, t, base_times, n_steps: int | None = None):
    """Backward-advect normalized points from time t to base_times.

    Per step ``dt = sign(offset) * min(|offset|, dt_max)``, RK2 midpoint, and
    for the 'sur' gate a step that leaves the surround box is reverted.  The
    loop runs ``n_steps`` times; points whose offset reached zero keep dt = 0.
    """
    if not meta.use_vel:
        return xyz
    if n_steps is None:
        n_steps = meta.max_adv_steps
    dt_max = meta.dt_max
    vel_params = params["vel"]
    gate = meta.vel_gate
    lo, hi = vel_mod.gate_box(gate, xyz.device)

    t_curr = t
    remaining = t - base_times
    for _ in range(n_steps):
        dt = torch.sign(remaining) * torch.clamp(torch.abs(remaining), max=dt_max)
        v1 = vel_mod.gated_velocity(vel_params, gate, xyz, t_curr)
        p_mid = xyz - 0.5 * dt * v1
        t_mid = t_curr - 0.5 * dt
        v2 = vel_mod.gated_velocity(vel_params, gate, p_mid, t_mid)
        xyz_new = xyz - dt * v2
        if gate.mode == "sur":
            out = torch.any((xyz_new < lo) | (xyz_new > hi), dim=-1, keepdim=True)
            xyz_new = torch.where(out, xyz, xyz_new)
        moved = torch.abs(remaining) > 0
        xyz = torch.where(moved, xyz_new, xyz)
        t_curr = t_curr - dt
        remaining = remaining - dt
    return xyz


# ---------------------------------------------------------------------------
# Ray sampling
# ---------------------------------------------------------------------------

def sample_ray(meta: KPlaneMeta, rays_o: torch.Tensor, rays_d: torch.Tensor, n_samples: int,
               jitter: torch.Tensor | None = None):
    """Uniform-in-box sampling.  ``jitter`` (N, 1) in [0, 1) is the per-ray
    stratified offset of a training render, in steps (JAX draws it from its
    key); without it the samples sit on the eval positions.

    Returns (pts (N,S,3), z_vals (N,S), valid (N,S)).  The start rule is the
    JAX package's: if any origin of the batch lies inside the box every ray
    starts at ``near``, otherwise each ray starts at its own box entry.
    """
    a = meta.aabb_np
    a0, a1 = _f32(a[0], rays_o), _f32(a[1], rays_o)
    near, far = meta.near_far
    inside = (rays_o >= a0) & (rays_o <= a1)
    inside_any = torch.any(inside) if meta.parity_sampling else torch.any(torch.all(inside, dim=-1))
    vec = torch.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (a1 - rays_o) / vec
    rate_b = (a0 - rays_o) / vec
    t_min_c = torch.clamp(torch.amax(torch.minimum(rate_a, rate_b), dim=-1), near, far)
    t_min = torch.where(inside_any, near, t_min_c)

    rng = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    z_vals = t_min[:, None] + rng * meta.step_size
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    valid = torch.all((pts >= a0) & (pts <= a1), dim=-1)
    return pts, z_vals, valid


# ---------------------------------------------------------------------------
# Full render (dense branch)
# ---------------------------------------------------------------------------

def _refuse_unported(meta: KPlaneMeta, transfer_vel, mask_params):
    refusals = (
        (transfer_vel, "transfer_vel (ROADMAP.md A9: motion transfer)"),
        (mask_params is not None, "mask_params segmentation head (ROADMAP.md A8)"),
        (meta.ray_sampling != "box", f"ray_sampling={meta.ray_sampling!r} (ROADMAP.md A3)"),
        (0.0 < meta.block_budget < 1.0, "block_budget < 1 turbo sampling (ROADMAP.md A6)"),
        (0.0 < meta.shade_fraction < 1.0, "shade_fraction < 1 top-K shading (ROADMAP.md A6)"),
    )
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"nvfi_torch.render_rays: {what} is not ported yet")


def render_rays(
    params,
    meta: KPlaneMeta,
    t,
    rays_o,
    rays_d,
    *,
    white_bg: bool,
    training: bool = False,
    transfer_vel: bool = False,
    alpha_state=None,
    mask_params=None,
    advect: bool = True,
    adv_steps: int | None = None,
    jitter=None,
    bg_coin: bool | None = None,
    device="cuda",
):
    """Render a batch of rays at time(s) t: the dense branch.

    An eval render (``training=False``) runs under ``inference_mode``; a
    training render runs under autograd, so that a loss on its outputs
    back-propagates to ``params`` (through K2b and K1b on the card).

    Args:
      params: on ``device`` (init_params / params_from_numpy / checkpoint.load).
      t: scalar or (N,) per-ray times.
      rays_o, rays_d: (N, 3) arrays or tensors; directions unnormalized.
      alpha_state: optional occupancy mask on ``device`` (``update_alpha_mask``
        / ``checkpoint.alpha_state_from_numpy``).  Eval: samples whose
        trilinear mask value is 0 get zero density (K3).  Training: used only
        with ``meta.train_occupancy_prune``, through the dilated nearest test
        (K4).  The render stays dense: every sample is still advected, looked
        up and shaded.
      advect: False skips the RK2 advection; valid only when every t of the
        batch is exactly a keyframe time (the advected positions would be
        discarded anyway).
      adv_steps: static RK2 step count (default ``meta.snap_steps`` when
        training, where the snap leaves |offset| <= Delta/2, else
        ``meta.render_adv_steps``).
      jitter: (N, 1) in [0, 1), required when training: the per-ray
        stratified offset.
      bg_coin: required when training without ``white_bg``: True composites
        this batch over white (JAX's training coin flip).
    Returns:
      dict with rgb (N,3), depth (N,), acc (N,), weight (N,S), mask (N,3)
      (zeros: no segmentation head is ported), z_vals (N,S) and the JAX
      package's budget-exactness counts ``dropped_blocks`` and
      ``dropped_shade``, which are 0.0 on the dense branch.  All float32:
      in bf16 the velocity net, the field's app basis and the shader run on
      ``cast_compute(params)``, and sigma, the positions and the shaded
      colour are float32 again before compositing, as in the JAX package.
    """
    _refuse_unported(meta, transfer_vel, mask_params)
    if training and jitter is None:
        raise ValueError("render_rays(training=True) needs jitter (N, 1): random draws "
                         "are inputs (train.trainer.draw_train_inputs makes them)")
    if training and not white_bg and bg_coin is None:
        raise ValueError("render_rays(training=True, white_bg=False) needs bg_coin")
    if not training:
        jitter = None  # the eval positions
    # an eval render keeps no graph; a training render runs under autograd
    with contextlib.nullcontext() if training else torch.inference_mode():
        dev = resolve_device(device)
        if params["planes_space"][0].device != dev:
            raise ValueError(f"render_rays: params are on {params['planes_space'][0].device}, "
                             f"device is {dev}")
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
        N, S = rays_o.shape[0], meta.n_samples
        if jitter is not None:
            jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev).reshape(N, 1)

        pts, z_vals, valid = sample_ray(meta, rays_o, rays_d, S, jitter)
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1)
        viewdirs = rays_d[:, None, :].expand(N, S, 3)

        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        t = (t.reshape(-1, 1, 1) if t.dim() > 0 else t).expand(N, S, 1)
        xyz = normalize_coord(meta, pts)
        base_times = snap_to_keyframe(meta, t)

        # occupancy pruning: the exact trilinear > 0 test (K3) of the eval render;
        # in training, only with train_occupancy_prune, the dilated nearest test
        # (K4), a weak superset of it
        if alpha_state is not None and (not training or meta.train_occupancy_prune):
            if training:
                valid = valid & sample_occupied(alpha_state, xyz, meta)
            else:
                valid = valid & (sample_alpha(alpha_state, xyz, meta) > 0)

        cp = cast_compute(params, meta)
        # pass 1: advect every sample and evaluate the field (K1)
        if meta.use_vel and advect:
            if adv_steps is not None:
                n_steps = adv_steps
            else:
                n_steps = meta.snap_steps if training else meta.render_adv_steps
            advected = integrate_pos(cp, meta, xyz, t, base_times, n_steps=n_steps)
            xyz_eval = torch.where(torch.isclose(t, base_times), xyz, advected)
            bt = base_times
        else:
            xyz_eval = xyz
            bt = t
        xyzt_eval = torch.cat([xyz_eval, normalize_time(meta, bt)], dim=-1)
        sigma_feat, app_feat = field_features(cp, meta, xyzt_eval)
        sigma = torch.where(valid, feature2density(meta, sigma_feat), 0.0)

        # pass 2: shade every sample, then composite (K2); the kernel zeroes the
        # colour of samples at or below rayMarch_weight_thres, as app_mask does
        shader = make_shader(meta.shading_mode, meta.view_pe, meta.pos_pe, meta.fea_pe)
        rgb_pts = shader(cp["shader"], xyz_eval, viewdirs, app_feat).float()
        over_white = white_bg or (training and bool(bg_coin))
        weight, acc, rgb, depth = composite(
            sigma.contiguous(), (dists * meta.distance_scale).contiguous(), z_vals.contiguous(),
            rgb_pts.contiguous(), meta.raymarch_weight_thres, over_white, meta.near_far[1],
        )
        # no segmentation head is ported (mask_params is refused above): the
        # mask map is zeros, as JAX returns it without one
        mask_map = torch.zeros(N, 3, dtype=rgb.dtype, device=dev)
        return {"rgb": rgb, "depth": depth, "acc": acc, "weight": weight, "mask": mask_map,
                "z_vals": z_vals, "dropped_blocks": 0.0, "dropped_shade": 0.0}


# ---------------------------------------------------------------------------
# Alpha mask (occupancy grid)
# ---------------------------------------------------------------------------

def _mask_boxes(alpha_state: dict, meta: KPlaneMeta | None):
    """(model aabb, mask aabb) for the lookups, which re-normalize model-aabb
    coords into the alpha volume's own aabb (the model aabb may have moved
    since the mask was built; JAX ``_to_mask_coords``).  Without ``meta`` the
    two aabbs are taken to be the same."""
    return (None if meta is None else meta.aabb_np), alpha_state["aabb"]


def sample_alpha(alpha_state: dict, xyz_norm: torch.Tensor, meta: KPlaneMeta | None = None):
    """Trilinear occupancy lookup (kernel K3): (..., 3) -> (...,)."""
    return occupancy.occupancy_trilinear(alpha_state["volume"], alpha_state.get("bits"),
                                         xyz_norm.contiguous(), *_mask_boxes(alpha_state, meta))


def corner_dilate(vol: torch.Tensor) -> torch.Tensor:
    """(D,H,W) -> per-cell corner max: out[i,j,k] = max(vol[i:i+2, j:j+2, k:k+2])
    with edge clamping."""
    for ax in range(3):
        n = vol.shape[ax]
        shifted = torch.cat([vol.narrow(ax, 1, n - 1), vol.narrow(ax, n - 1, 1)], dim=ax)
        vol = torch.maximum(vol, shifted)
    return vol


def sample_occupied(alpha_state: dict, xyz_norm: torch.Tensor, meta: KPlaneMeta | None = None):
    """Boolean occupancy test (kernel K4), a weak superset of
    ``sample_alpha(...) > 0``.

    The volume is binary, so ``trilinear(x) > 0`` says "some cell corner with
    nonzero weight is occupied", which one gather into the corner-dilated
    volume answers.  At exactly grid-aligned coords the dilated test also sees
    corners whose trilinear weight is exactly 0, so it keeps a superset of the
    samples: pruning by it never drops a sample the trilinear test keeps.

    Falls back to the trilinear test when the state has no ``dilated`` volume
    (old checkpoints)."""
    dil = alpha_state.get("dilated")
    if dil is None:
        return sample_alpha(alpha_state, xyz_norm, meta) > 0
    return occupancy.occupancy_nearest(dil, xyz_norm.contiguous(),
                                       *_mask_boxes(alpha_state, meta))


@torch.inference_mode()
def dense_alpha_chunk(params, meta: KPlaneMeta, xyz_c: torch.Tensor, tval: float, n_steps: int):
    """Alpha of one step_size of density at normalized points (n, 3), all at
    time ``tval``: advect to the keyframe, look the density up (K1d), decode.
    The params are not cast, as in the JAX package: in bf16 the velocity net
    runs in float32 and only the density lookup takes its bf16 arm."""
    t = torch.full((xyz_c.shape[0], 1), tval, dtype=torch.float32, device=xyz_c.device)
    base = snap_to_keyframe(meta, t)
    prev = integrate_pos(params, meta, xyz_c, t, base, n_steps=n_steps)
    xyzt = torch.cat([prev, normalize_time(meta, base)], dim=-1)
    sigma = feature2density(meta, density_feature(params, meta, xyzt))
    return 1.0 - torch.exp(-sigma * meta.step_size)


@torch.inference_mode()
def compute_dense_alpha(params, meta: KPlaneMeta, grid_size: tuple, transfer: bool = False,
                        n_times: int = 60, chunk: int = 262144, device="cuda"):
    """Max-over-time dense alpha grid.

    Sweeps t over ``i / n_times`` and advects the grid points to their
    keyframe before the density lookup (K1d).  The grid coordinates are made
    on the host with numpy and moved to ``device`` in fixed-size chunks, the
    last one padded with zeros; each chunk keeps a running max over the times.
    Returns (alpha (gx,gy,gz) tensor on ``device``, dense_xyz (gx,gy,gz,3)
    numpy array of world coords).
    """
    if transfer:
        raise NotImplementedError("nvfi_torch.compute_dense_alpha: transfer (ROADMAP.md A9: "
                                  "motion transfer) is not ported yet")
    dev = resolve_device(device)
    gx, gy, gz = grid_size
    a = meta.aabb_np
    lin = [np.linspace(0.0, 1.0, g, dtype=np.float32) for g in (gx, gy, gz)]
    mesh = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1)
    dense_xyz = a[0] * (1 - mesh) + a[1] * mesh  # (gx,gy,gz,3) host
    flat = dense_xyz.reshape(-1, 3)
    xyz_norm = ((flat - a[0]) * (2.0 / (a[1] - a[0])) - 1.0).astype(np.float32)
    total = flat.shape[0]
    chunk = min(chunk, total)

    pad = (-total) % chunk
    padded = np.concatenate([xyz_norm, np.zeros((pad, 3), np.float32)]) if pad else xyz_norm
    chunks = torch.as_tensor(padded, device=dev).reshape(-1, chunk, 3)
    alpha = torch.zeros(chunks.shape[:2], dtype=torch.float32, device=dev)
    for i in range(n_times):
        tval = i / n_times
        # two step counts: a time inside the training window needs the steps
        # of one post-snap offset, only t > tmax the full extrapolation bound
        n_steps = meta.snap_steps if tval <= meta.tmax + 1e-6 else meta.render_adv_steps
        for c in range(chunks.shape[0]):
            torch.maximum(alpha[c], dense_alpha_chunk(params, meta, chunks[c], tval, n_steps),
                          out=alpha[c])
    return alpha.reshape(-1)[:total].reshape(gx, gy, gz), dense_xyz


@torch.inference_mode()
def update_alpha_mask(params, meta: KPlaneMeta, grid_size: tuple, transfer: bool = False,
                      device="cuda"):
    """Build the binary occupancy volume and the proposed shrunk aabb.

    Returns (alpha_state, new_aabb (2,3) numpy).  ``alpha_state`` holds
    tensors on ``device``: ``volume`` (D,H,W) = (gz,gy,gx) so that x indexes
    W, the ``aabb`` (2,3) the mask was built in, ``dilated``, the
    corner-dilated volume of ``sample_occupied``, and ``bits``, the cell bits
    of ``sample_alpha`` (``ops.occupancy.occupancy_bits``; derived, never
    saved).
    """
    alpha, dense_xyz = compute_dense_alpha(params, meta, grid_size, transfer, device=device)
    alpha = torch.clamp(alpha, 0, 1).permute(2, 1, 0)  # (gz,gy,gx)
    alpha = max_pool3d_same(alpha, kernel=3)
    vol = (alpha >= _f32(meta.alpha_mask_thres, alpha)).to(torch.float32).contiguous()

    occ = vol.cpu().numpy() > 0.5
    if occ.any():
        valid_xyz = dense_xyz.transpose(2, 1, 0, 3)[occ]
        new_aabb = np.stack([valid_xyz.min(0), valid_xyz.max(0)])
    else:
        new_aabb = meta.aabb_np.copy()
    alpha_state = {
        "volume": vol,
        "aabb": torch.as_tensor(meta.aabb_np, device=vol.device),
        "dilated": corner_dilate(vol),
        "bits": occupancy.occupancy_bits(vol),
    }
    return alpha_state, new_aabb


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------

def density_l1(params, meta: KPlaneMeta) -> torch.Tensor:
    """L1 of the density channels; the time planes are penalized toward 1."""
    cd = meta.density_n_comp
    total = 0.0
    for p in params["planes_space"]:
        total = total + torch.mean(torch.abs(p[..., :cd]))
    for p in params["planes_time"]:
        total = total + torch.mean(torch.abs(1.0 - p[..., :cd]))
    return total


def _tv(plane: torch.Tensor, t_axis: bool) -> torch.Tensor:
    """Plain first-difference TV of an (H, W, C) plane; a time plane weighs
    its keyframe axis x3 (and counts H - 2 rows there, as the JAX package)."""
    h, w, c = plane.shape
    h_tv = torch.sum((plane[1:] - plane[:-1]) ** 2)
    if t_axis:
        h_tv = h_tv * 3.0
        count_h = max(h - 2, 1) * w * c
    else:
        count_h = (h - 1) * w * c
    w_tv = torch.sum((plane[:, 1:] - plane[:, :-1]) ** 2)
    count_w = h * (w - 1) * c
    return 2.0 * (h_tv / count_h + w_tv / count_w)


def tv_loss_density(params, meta: KPlaneMeta) -> torch.Tensor:
    cd = meta.density_n_comp
    total = 0.0
    for p in params["planes_space"]:
        total = total + _tv(p[..., :cd], False) * 1e-2
    if meta.num_keyframes > 1:
        for p in params["planes_time"]:
            total = total + _tv(p[..., :cd], True) * 1e-2
    return total


def tv_loss_app(params, meta: KPlaneMeta) -> torch.Tensor:
    cd = meta.density_n_comp
    total = 0.0
    for p in params["planes_space"]:
        total = total + _tv(p[..., cd:], False) * 1e-2
    return total

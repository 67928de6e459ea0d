"""Keyframe K-plane dynamic radiance field: the render (eval and training,
dense or turbo), the alpha mask (occupancy volume) that prunes it, and the
plane regularizers.

Port of ``nvfi_tpu/fields/kplane.py``.  Three *space* planes (xy, xz, yz)
times three *space-time* planes (zt, yt, xt), density and appearance channels
merged in one channels-last plane per orientation (density first); samples
off a keyframe are advected back to the nearest keyframe time through the
velocity field with RK2 over a static step count.

Ported here: ``KPlaneMeta`` and its derived step counts, ``init_params``,
the coordinate helpers, ``field_features`` (kernel K1 plus the app basis;
DensityLinear: K1 at ``density_n_comp = 0`` and the ``basis_mat_density``
decode), ``feature2density`` (every density decoder, with the per-sample
times ``aux``), ``integrate_pos``, the box, NDC and contracted samplings
(``sample_ray``, ``sample_ray_ndc``, ``sample_ray_contracted``) and
``render_rays`` (every shader; kernel K2 for compositing), with
``alpha_state`` pruning (``sample_alpha``, kernel K3, for eval;
``sample_occupied``, kernel K4, for training with
``train_occupancy_prune``) and turbo: the block-sparse sample axis
(``block_budget`` < 1, its picks through kernel K5) and per-ray top-K
shading (``shade_fraction`` < 1, on K2's colourless arm), motion transfer
(``transfer_vel``: every sample advected back to t = 0) and the
segmentation head (``mask_params``, a MaskField composited along the ray);
the mask build ``compute_dense_alpha`` / ``update_alpha_mask`` over
``density_feature`` (kernel K1d; DensityLinear: kernel K1d.raw), in its
transfer arm too, and ``corner_dilate``; the stage transitions ``upsample``
and ``shrink``; ``density_l1`` and the TV losses.  A
training render runs under autograd: K1 and K2 carry their backward kernels
(K1b, K2b, and K2b's colourless arm under top-K), and what JAX draws from
its key (the stratified jitter, the background coin) comes in as arguments.
``compute_dtype = "bfloat16"`` is the JAX package's mixed precision: the
render casts the MLP and decoder leaves to bf16 for its compute
(``cast_compute``; the planes stay float32, and the gradients land in float32
on the masters), and K1, K1d and K1b run their bf16 arms (K1 and K1d on
bf16 copies of the planes, made once per plane version).
Options that select another path raise ``NotImplementedError`` naming the
ROADMAP.md item that will port them; none silently takes another path.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.compositing import _Clip01, composite, composite_weights
from ..ops.gather import pick_rows
from ..ops import occupancy
from ..ops.grid_sample import (MAT_SPACE, MAT_TIME, plane_product, plane_product_density,
                               plane_product_density_raw)
from ..ops.resize import max_pool3d_same, resize_bilinear_ac
from .mlp import linear_init
from .shaders import DENSITY_DATA_DIM, init_shader, make_density_decoder, make_shader
from . import mask_field
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
    JAX rounds the gathered rows, and the lookup kernels read bf16 copies of
    the planes, the same values, that ``grid_sample.bf16_planes`` makes once
    per plane version."""
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

class ChannelShard:
    """This rank's slice ``[lo, hi)`` of the ``channels`` merged plane
    channels on the mesh's model axis (``parallel.mesh.shard_scene_params``),
    and ``reduce(tensor)``, which sums a float32 tensor in place over the
    model axis.

    While a shard is entered (:func:`channel_shard`) the planes in the
    params are the slice, and the lookups and regularizers give the whole
    answer on every rank of the model axis: each computes its channels'
    partial in float32 (:func:`field_partials`, :func:`density_partial`) and
    one sum over the axis adds them, as XLA's collectives do for JAX's
    channel-sharded planes.  The other leaves are whole; a rank reads the
    rows of ``basis_mat`` and ``basis_mat_density`` that belong to its
    channels."""

    def __init__(self, lo: int, hi: int, channels: int, reduce=None):
        if not 0 <= lo < hi <= channels:
            raise ValueError(f"ChannelShard: [{lo}, {hi}) is not a slice of {channels} channels")
        self.lo, self.hi, self.channels, self.reduce = lo, hi, channels, reduce

    def density_channels(self, meta: "KPlaneMeta") -> int:
        """Cd_m: the density channels of the slice, the first of its planes."""
        return min(max(meta.density_n_comp - self.lo, 0), self.hi - self.lo)

    def density_rows(self, meta: "KPlaneMeta") -> slice:
        """The rows of ``basis_mat_density`` of the slice's density channels."""
        return slice(self.lo, self.lo + self.density_channels(meta))

    def app_rows(self, meta: "KPlaneMeta") -> slice:
        """The rows of ``basis_mat`` of the slice's app channels."""
        cd = meta.density_n_comp
        return slice(max(self.lo, cd) - cd, max(self.hi, cd) - cd)


_SHARD = contextvars.ContextVar("nvfi_torch_channel_shard", default=None)


@contextlib.contextmanager
def channel_shard(shard: ChannelShard | None):
    """Run the lookups and regularizers on a channel slice of the planes
    (``shard``; None: whole planes) inside the block."""
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


def current_shard() -> ChannelShard | None:
    return _SHARD.get()


def _check_channels(params, meta: KPlaneMeta, shard: ChannelShard | None, where: str):
    """The planes must hold the slice's channels, or all of them: a sliced
    plane outside its shard would read as a narrower field."""
    have = params["planes_space"][0].shape[-1]
    want = meta.density_n_comp + meta.app_n_comp if shard is None else shard.hi - shard.lo
    if have != want or (shard is not None and shard.channels != meta.density_n_comp
                        + meta.app_n_comp):
        raise ValueError(f"{where}: the planes hold {have} channels, the "
                         f"{'shard' if shard is not None else 'meta'} wants {want} (a "
                         "channel-sharded plane is read only inside kplane.channel_shard)")


class _SumOverModel(torch.autograd.Function):
    """Forward: the channel partials summed over the model axis; backward:
    the cotangent as it comes (every model rank holds the same whole
    cotangent, and its partial's share of it is the whole of it)."""

    @staticmethod
    def forward(ctx, partial, shard):
        out = partial.detach().clone()
        shard.reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromModel(torch.autograd.Function):
    """Forward: the coordinates as they are; backward: their cotangent
    summed over the model axis (each rank's K1b gives its channels' share
    of ``grad_xyz``), so the velocity net upstream sees the whole of it on
    every rank."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.shard.reduce(g)
        return g, None


def _decode_density(params, fused_d: torch.Tensor, rows: slice = slice(None)) -> torch.Tensor:
    """The DensityLinear decode of the fused density channels (P, Cd):
    ``fused_d @ basis_mat_density`` in float32 (JAX ``jnp.dot(...,
    preferred_element_type=float32)``).  A bf16 basis (a cast render) meets
    the channels rounded to bf16; a float32 basis (the mask build's uncast
    params) meets them in float32, where XLA keeps the chain's last product
    unrounded.  ``rows``: the basis rows of a shard's channels."""
    w = params["basis_mat_density"]["w"][rows]
    if w.dtype == torch.bfloat16:
        fused_d = fused_d.to(torch.bfloat16)
    return fused_d.float() @ w.float()


def field_partials(params, meta: KPlaneMeta, xyzt: torch.Tensor, shard: ChannelShard):
    """One slice's share of :func:`field_features` on (P, 4) coords, before
    the sum over the model axis: the density partial (P, Dd) and the app
    partial (P, app_dim), both float32.  K1 runs on the slice's planes with
    its Cd_m density channels (DensityLinear: at 0, the first Cd_m products
    decoded with their rows of ``basis_mat_density``); the app partial is the
    slice's app channels times their rows of ``basis_mat``, accumulated in
    float32 (in bf16 the sum is rounded once, after the reduction).  A slice
    without app channels gives zeros."""
    cd_m = shard.density_channels(meta)
    linear = meta.density_mode != "Density"
    density, app = plane_product(params["planes_space"], params["planes_time"], xyzt,
                                 0 if linear else cd_m, compute_dtype=_compute_dtype(meta))
    if linear:
        density, app = _decode_density(params, app[:, :cd_m], shard.density_rows(meta)), \
            app[:, cd_m:]
    else:
        density = density[:, None]
    app = app.float() @ params["basis_mat"]["w"][shard.app_rows(meta)].float()
    return density, app


def field_features(params, meta: KPlaneMeta, xyzt: torch.Tensor):
    """Density feature (..., Dd) and app feature (..., app_dim) from one pass
    of kernel K1 (the JAX ``_plane_product`` + ``_decode_density``), then the
    app basis as a plain matmul, as the JAX package leaves it to XLA.  Density
    mode: the kernel sums the density channels (Dd = 1, float32).
    DensityLinear: K1 runs at ``density_n_comp = 0``, so every channel comes
    out as a product (in the compute dtype), and the first Cd are decoded by
    :func:`_decode_density` (Dd = 2).  In bf16 the app basis is a bf16
    matmul.

    Inside :func:`channel_shard` the planes are a channel slice: the rank's
    :func:`field_partials`, packed into one buffer, are summed over the model
    axis in one reduction (the app feature rounded to the compute dtype after
    it); the coordinates' cotangent is summed over the axis in the backward."""
    batch = xyzt.shape[:-1]
    xyzt = xyzt.reshape(-1, 4).contiguous()
    shard = current_shard()
    _check_channels(params, meta, shard, "field_features")
    if shard is not None:
        density, app = field_partials(params, meta, _FromModel.apply(xyzt, shard), shard)
        dd = density.shape[-1]
        whole = _SumOverModel.apply(torch.cat([density, app], -1), shard)
        density, app = whole[:, :dd], whole[:, dd:].to(_compute_dtype(meta))
        return density.reshape(*batch, -1), app.reshape(*batch, -1)
    cd = meta.density_n_comp
    linear = meta.density_mode != "Density"
    density, app = plane_product(params["planes_space"], params["planes_time"], xyzt,
                                 0 if linear else cd, compute_dtype=_compute_dtype(meta))
    if linear:
        density, app = _decode_density(params, app[:, :cd]), app[:, cd:]
    app = app @ params["basis_mat"]["w"].to(app.dtype)
    return density.reshape(*batch, -1), app.reshape(*batch, -1)


def density_partial(params, meta: KPlaneMeta, xyzt: torch.Tensor,
                    shard: ChannelShard | None = None) -> torch.Tensor:
    """:func:`density_feature`'s (P, Dd) float32 on (P, 4) coords from the
    planes in ``params``, whole or (``shard``) the slice's partial before the
    sum over the model axis: K1d on the Cd_m density channels (at 0 no
    launch, zeros), or K1d.raw decoded with the slice's rows of
    ``basis_mat_density``."""
    cd = meta.density_n_comp if shard is None else shard.density_channels(meta)
    args = (params["planes_space"], params["planes_time"], xyzt, cd)
    if meta.density_mode == "Density":
        return plane_product_density(*args, compute_dtype=_compute_dtype(meta))[:, None]
    rows = slice(None) if shard is None else shard.density_rows(meta)
    return _decode_density(params, plane_product_density_raw(
        *args, compute_dtype=_compute_dtype(meta)), rows)


def density_feature(params, meta: KPlaneMeta, xyzt: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> density feature (..., Dd) float32 from the density channels
    of the merged planes alone (the JAX ``density_feature`` slices them out
    before the gather), in the arm of the compute dtype: kernel K1d, their
    sum (Density, Dd = 1), or kernel K1d.raw, their products decoded by
    :func:`_decode_density` (DensityLinear, Dd = 2).  In bf16 the chain's last
    product is taken in float32, as XLA takes it in JAX's
    ``density_feature``, so the value differs from :func:`field_features`'
    density, which rounds that product to bf16.  No gradient.  Inside
    :func:`channel_shard` the slices' :func:`density_partial` are summed over
    the model axis (a slice without density channels adds zeros)."""
    batch = xyzt.shape[:-1]
    shard = current_shard()
    _check_channels(params, meta, shard, "density_feature")
    density = density_partial(params, meta, xyzt.reshape(-1, 4).contiguous(), shard)
    if shard is not None:
        density = density.detach().clone()
        shard.reduce(density)
    return density.reshape(*batch, -1)


def feature2density(meta: KPlaneMeta, density_features: torch.Tensor, aux=None) -> torch.Tensor:
    """Decode (``aux``: the per-sample times, which DensityLinear reads) and
    activate the density feature."""
    x = make_density_decoder(meta.density_mode)(density_features, aux)
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


def _linspace(start: float, stop: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """(1, n) float32 on ``like``'s device: ``n`` points from start to stop,
    made in float64 on the host (the same on every device)."""
    return torch.as_tensor(np.linspace(start, stop, n).astype(np.float32),
                           device=like.device)[None, :]


def jitter_width(meta: KPlaneMeta, n_samples: int | None = None) -> int:
    """Columns of a ray's training jitter in ``meta.ray_sampling`` (what JAX
    draws from the stratified key): box 1 (the ray's offset in steps), ndc
    ``n_samples`` (one a sample), contracted ``n_samples + 2`` (the inner
    draw's ``S - S // 2 + 1`` columns, then the outer draw's ``S // 2 + 1``)."""
    S = meta.n_samples if n_samples is None else n_samples
    return {"box": 1, "ndc": S, "contracted": S + 2}[meta.ray_sampling]


def sample_ray_ndc(meta: KPlaneMeta, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   n_samples: int, jitter: torch.Tensor | None = None):
    """NDC sampling: linear in z over ``near_far``; a training render moves
    each sample by ``jitter`` (N, S) in [0, 1) of a step.  Returns (pts
    (N,S,3), z_vals (N,S), valid (N,S): inside the aabb)."""
    near, far = meta.near_far
    interpx = _linspace(near, far, n_samples, rays_o)
    if jitter is not None:
        interpx = interpx + jitter * ((far - near) / n_samples)
    interpx = interpx.expand(rays_o.shape[0], n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    a = meta.aabb_np
    valid = torch.all((pts >= _f32(a[0], pts)) & (pts <= _f32(a[1], pts)), dim=-1)
    return pts, interpx, valid


def sample_ray_contracted(meta: KPlaneMeta, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          n_samples: int, jitter: torch.Tensor | None = None):
    """Unbounded-scene sampling with scene contraction: half the samples
    linear over [near, 2], half in inverse depth out to far, then the points
    beyond max-norm 1 contracted to ``(2 - 1/|x|) x/|x|``.  ``jitter`` (N,
    S + 2) in [0, 1): the inner draw's columns, then the outer draw's (JAX
    draws them from the two halves of its key); the last column of each is
    zeroed, as JAX zeroes it.  Every sample is valid."""
    near, far = meta.near_far
    N = rays_o.shape[0]
    inner_n = n_samples - n_samples // 2
    outer_n = n_samples // 2

    ix_inner = _linspace(near, 2.0, inner_n + 1, rays_o)
    rng = torch.arange(outer_n + 1, dtype=rays_o.dtype, device=rays_o.device)[None, :]
    if jitter is not None:
        last = torch.arange(jitter.shape[1], device=rays_o.device)
        keep = (last != inner_n) & (last != jitter.shape[1] - 1)  # each draw's last column
        jitter = jitter * keep.to(jitter.dtype)
        ix_inner = ix_inner + jitter[:, :inner_n + 1] * ((2.0 - near) / inner_n)
        rng = rng + jitter[:, inner_n + 1:]
    ix_inner = 0.5 * (ix_inner[:, 1:] + ix_inner[:, :-1])
    rng = torch.flip(rng, dims=[1])
    rng = 0.5 * (rng[:, 1:] + rng[:, :-1])
    ix_outer = 1.0 / (1.0 / far + (1.0 / 2.0 - 1.0 / far) * rng / outer_n)

    interpx = torch.cat([ix_inner.expand(N, inner_n), ix_outer.expand(N, outer_n)], dim=-1)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    norm = torch.amax(torch.abs(pts), dim=-1, keepdim=True)
    contracted = (2.0 - 1.0 / torch.clamp(norm, min=1.0)) * pts / torch.clamp(norm, min=1e-9)
    pts = torch.where(norm > 1.0, contracted, pts)
    valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    return pts, interpx, valid


# ---------------------------------------------------------------------------
# Full render
# ---------------------------------------------------------------------------

def _refuse_unported(meta: KPlaneMeta):
    turbo = 0.0 < meta.block_budget < 1.0 or 0.0 < meta.shade_fraction < 1.0
    # the regather arm (density_feature in the density pass, app_feature in
    # the shade pass) gives the fused arm's values in float32 and dense; in
    # bf16 or under a turbo budget it gives others
    if not meta.shade_reuse and (meta.compute_dtype == "bfloat16" or turbo):
        raise NotImplementedError("nvfi_torch.render_rays: shade_reuse=False under bf16 or a "
                                  "turbo budget (ROADMAP.md A6 (regather arm)) is not ported yet")


def _block_selection(active: torch.Tensor, B: int) -> torch.Tensor:
    """(B,) int32: the active blocks in index order, then the first inactive
    ones: the blocks ``jax.lax.top_k`` of the 0/1 score picks (among equal
    scores the lower index first; a stable sort keeps that order, which
    ``torch.topk`` does not promise)."""
    return torch.argsort((~active).to(torch.int8), stable=True)[:B].to(torch.int32)


def _pick(x: torch.Tensor, sel: torch.Tensor, SB: int) -> torch.Tensor:
    """The block-sparse render's pick (JAX ``kplane.py:861-863``): rows ``sel``
    of ``x`` (N, S, c) seen as (N * S / SB, SB * c), as (B * SB, c), through
    kernel K5 with no read-back (``sel`` selects among the table's rows)."""
    c = x.shape[-1]
    return pick_rows(x.reshape(-1, SB * c).contiguous(), sel).reshape(-1, c)


def _unpick(x_b: torch.Tensor, sel: torch.Tensor, n_blocks: int, shape) -> torch.Tensor:
    """The picked rows ``x_b`` (B * SB, c) scattered back into zeros of
    ``shape`` (N, S, c) (JAX ``.at[sel].set``): a differentiable library op."""
    rows = x_b.reshape(sel.shape[0], -1)
    out = torch.zeros(n_blocks, rows.shape[1], dtype=x_b.dtype, device=x_b.device)
    return out.index_copy(0, sel.to(torch.int64), rows).reshape(shape)


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
    """Render a batch of rays at time(s) t.

    An eval render (``training=False``) runs under ``inference_mode``; a
    training render runs under autograd, so that a loss on its outputs
    back-propagates to ``params`` (through K2b and K1b on the card).

    Turbo (the JAX package's ``block_budget`` and ``shade_fraction`` below 1,
    box sampling only):
      * the block-sparse sample axis (``0 < block_budget < 1``): the sample
        axis is padded to whole blocks of ``meta.sample_block`` samples
        (padded samples invalid), and only the blocks that hold a valid
        sample, at most ``B`` of them, are advected, looked up (K1) and
        decoded: three picks a chunk through K5, the results scattered back
        into zeros.  Active blocks past ``B`` are dropped and counted in
        ``dropped_blocks``;
      * per-ray top-K shading (``0 < shade_fraction < 1`` and more than 512
        samples): the colourless arm of K2 gives weight, acc and depth, each
        ray shades its K highest-weight samples above rayMarch_weight_thres
        on the density pass's app rows, and the colour is their weighted sum.
        Samples above the threshold past K are dropped and counted in
        ``dropped_shade``.
    With both counts 0 the result equals the dense render's.

    Args:
      params: on ``device`` (init_params / params_from_numpy / checkpoint.load).
      t: scalar or (N,) per-ray times.
      rays_o, rays_d: (N, 3) arrays or tensors; directions unnormalized.
      alpha_state: optional occupancy mask on ``device`` (``update_alpha_mask``
        / ``checkpoint.alpha_state_from_numpy``).  Eval: samples whose
        trilinear mask value is 0 get zero density (K3).  Training: used only
        with ``meta.train_occupancy_prune``, through the dilated nearest test
        (K4).  Under a block budget the test decides which blocks run;
        otherwise every sample is still advected, looked up and shaded.
      advect: False skips the RK2 advection; valid only when every t of the
        batch is exactly a keyframe time (the advected positions would be
        discarded anyway).
      transfer_vel: motion transfer: every sample is advected from t back to
        t = 0 (``meta.transfer_adv_steps`` steps) and the field is read there;
        a sample at t = 0 is not advected, so that frame equals the
        non-transfer one.
      mask_params: MaskField params (``fields.mask_field``) on ``device``;
        with ``meta.mask_dim`` > 0 the head's output at each sample's
        advected position is composited into ``mask`` (N, mask_dim).
      adv_steps: static RK2 step count (default ``meta.transfer_adv_steps``
        under transfer, ``meta.snap_steps`` when training, where the snap
        leaves |offset| <= Delta/2, else ``meta.render_adv_steps``).
      jitter: required when training, in [0, 1): (N, ``jitter_width(meta)``),
        the per-ray stratified offset of box sampling (N, 1), the per-sample
        offsets of NDC sampling (N, S), or the two draws of contracted
        sampling (N, S + 2).
      bg_coin: required when training without ``white_bg``: True composites
        this batch over white (JAX's training coin flip).
    Returns:
      dict with rgb (N,3), depth (N,), acc (N,), weight (N,S), mask
      (N, mask_dim) with a head, else zeros (N, 3), z_vals (N,S) (S padded to
      whole blocks under a block budget) and the JAX package's
      budget-exactness counts ``dropped_blocks`` and ``dropped_shade``, 0-d
      float32 tensors on ``device`` (0 on the dense branch; reading one
      waits for the card).  All float32: in bf16 the velocity net, the
      field's app basis and the shader run on ``cast_compute(params)``, and
      sigma, the positions and the shaded colour are float32 again before
      compositing, as in the JAX package.
    """
    sparse = 0.0 < meta.block_budget < 1.0
    if sparse and meta.ray_sampling != "box":
        # ndc / contracted sample positions depend on n_samples, so padding the
        # axis to whole blocks would shift every sample (the JAX package's rule)
        raise ValueError(f"block_budget < 1 requires ray_sampling == 'box' "
                         f"(got {meta.ray_sampling!r})")
    _refuse_unported(meta)
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
        N, orig_S = rays_o.shape[0], meta.n_samples
        SB = meta.sample_block
        # the block-sparse axis: whole blocks; the padded samples are invalid and
        # the last real sample keeps its zero dist, as on the dense axis
        S = -(-orig_S // SB) * SB if sparse else orig_S
        if jitter is not None:
            jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev).reshape(
                N, jitter_width(meta, S))

        sampler = {"box": sample_ray, "ndc": sample_ray_ndc,
                   "contracted": sample_ray_contracted}[meta.ray_sampling]
        pts, z_vals, valid = sampler(meta, rays_o, rays_d, S, jitter)
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1)
        if S != orig_S:
            s_idx = torch.arange(S, device=dev)
            valid = valid & (s_idx < orig_S)[None, :]
            dists = dists * (s_idx < orig_S - 1)[None, :].to(dists.dtype)
        viewdirs = rays_d
        if meta.ray_sampling != "box":
            # the step is scaled by |d| and the view directions are normalized
            # (JAX kplane.py:762-767)
            d_norm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
            dists = dists * d_norm
            viewdirs = rays_d / d_norm

        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        t = (t.reshape(-1, 1, 1) if t.dim() > 0 else t).expand(N, S, 1)
        xyz = normalize_coord(meta, pts)
        if transfer_vel:
            # motion transfer: every sample is advected back to the canonical
            # t = 0 frame (JAX kplane.py:775-777), so the keyframe test below
            # becomes isclose(t, 0)
            base_times = torch.zeros_like(t)
        else:
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
        if meta.use_vel and advect:
            if adv_steps is not None:
                n_steps = adv_steps
            elif transfer_vel:
                n_steps = meta.transfer_adv_steps
            else:
                n_steps = meta.snap_steps if training else meta.render_adv_steps

        def density_pass(xyz, t, base_times):
            """Advect, look up (K1) and decode: sigma, the positions, app."""
            if meta.use_vel and advect:
                advected = integrate_pos(cp, meta, xyz, t, base_times, n_steps=n_steps)
                xyz_eval = torch.where(torch.isclose(t, base_times), xyz, advected)
                bt = base_times
            else:
                xyz_eval = xyz
                bt = t
            xyzt_eval = torch.cat([xyz_eval, normalize_time(meta, bt)], dim=-1)
            sigma_feat, app = field_features(cp, meta, xyzt_eval)
            aux = {"times": t[..., 0], "time_offset": (t - base_times)[..., 0]}
            return feature2density(meta, sigma_feat, aux), xyz_eval, app

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        dropped_blocks = dropped_shade = zero
        # pass 1: advect the samples and evaluate the field
        if sparse:
            # the in-box (and, with a mask, occupied) blocks under a static budget
            # of B blocks; a skipped block is all invalid, so exactly 0
            nb = S // SB
            total_b = N * nb
            active = valid.reshape(total_b, SB).any(-1)
            B = min(total_b, max(8, (int(meta.block_budget * total_b) + 7) // 8 * 8))
            sel = _block_selection(active, B)
            dropped_blocks = torch.clamp(active.sum().to(torch.float32) - B, min=0.0)
            sigma_b, xyz_eval_b, app_b = density_pass(
                _pick(xyz, sel, SB), _pick(t, sel, SB), _pick(base_times, sel, SB))
            sigma = _unpick(sigma_b, sel, total_b, (N, S))
            xyz_eval = _unpick(xyz_eval_b, sel, total_b, (N, S, 3))
            app_feat = _unpick(app_b, sel, total_b, (N, S, app_b.shape[-1]))
        else:
            sigma, xyz_eval, app_feat = density_pass(xyz, t, base_times)
        sigma = torch.where(valid, sigma, 0.0)

        shader = make_shader(meta.shading_mode, meta.view_pe, meta.pos_pe, meta.fea_pe)
        over_white = white_bg or (training and bool(bg_coin))
        dist = (dists * meta.distance_scale).contiguous()
        far = meta.near_far[1]
        frac = meta.shade_fraction
        # the shade budget counts the unpadded samples, so that the padding does
        # not change which samples the top-K truncates
        top_k = 0.0 < frac < 1.0 and N * orig_S > 512
        if top_k:
            # pass 2, per-ray top-K: the colourless K2, then each ray shades its K
            # highest-weight samples above the threshold (JAX's app_mask
            # compaction); the colour is their weighted sum
            weight, acc, depth = composite_weights(sigma.contiguous(), dist,
                                                   z_vals.contiguous(), far)
            app_mask = weight > meta.raymarch_weight_thres
            K = min(S, max(16, (int(orig_S * frac) + 7) // 8 * 8))
            w_top, sel = torch.topk(torch.where(app_mask, weight, 0.0), K, dim=1)
            dropped_shade = (app_mask.sum() - (w_top > meta.raymarch_weight_thres).sum()).to(
                torch.float32)

            def take(x):  # (N, S, c) -> (N, K, c)
                return torch.gather(x, 1, sel[..., None].expand(N, K, x.shape[-1]))

            xyz_sel = take(xyz_eval)
            aux_sel = {"times": take(t)[..., 0], "time_offset": take(t - base_times)[..., 0]}
            rgb_sel = shader(cp["shader"], xyz_sel, viewdirs[:, None, :].expand(N, K, 3),
                             take(app_feat), aux_sel).float()
            rgb = torch.sum(w_top[..., None] * rgb_sel, dim=1)
            if over_white:
                rgb = rgb + (1.0 - acc[..., None])
            rgb = _Clip01.apply(rgb)
        else:
            # pass 2: shade every sample, then composite (K2); the kernel zeroes the
            # colour of samples at or below rayMarch_weight_thres, as app_mask does
            aux = {"times": t[..., 0], "time_offset": (t - base_times)[..., 0]}
            rgb_pts = shader(cp["shader"], xyz_eval, viewdirs[:, None, :].expand(N, S, 3),
                             app_feat, aux).float()
            weight, acc, rgb, depth = composite(
                sigma.contiguous(), dist, z_vals.contiguous(), rgb_pts.contiguous(),
                meta.raymarch_weight_thres, over_white, far,
            )
        # the segmentation head composited along the ray (JAX kplane.py:992-1002)
        # reads the advected position: under transfer, the canonical t = 0 one
        if meta.mask_dim > 0 and mask_params is not None:
            if top_k:
                m_sel = mask_field.apply(mask_params, xyz_sel.float())
                mask_map = torch.sum(w_top[..., None] * m_sel, dim=1)
            else:
                m = mask_field.apply(mask_params, xyz_eval.float())
                m = torch.where((weight > meta.raymarch_weight_thres)[..., None], m, 0.0)
                mask_map = torch.sum(weight[..., None] * m, dim=-2)
        else:
            mask_map = torch.zeros(N, 3, dtype=rgb.dtype, device=dev)
        return {"rgb": rgb, "depth": depth, "acc": acc, "weight": weight, "mask": mask_map,
                "z_vals": z_vals, "dropped_blocks": dropped_blocks,
                "dropped_shade": dropped_shade}


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
    (old checkpoints).  Kernel K4 reads the state's ``occupied`` bits of the
    dilated volume (``ops.occupancy.occupied_bits``)."""
    dil = alpha_state.get("dilated")
    if dil is None:
        return sample_alpha(alpha_state, xyz_norm, meta) > 0
    return occupancy.occupancy_nearest(dil, alpha_state.get("occupied"), xyz_norm.contiguous(),
                                       *_mask_boxes(alpha_state, meta))


@torch.inference_mode()
def dense_alpha_chunk(params, meta: KPlaneMeta, xyz_c: torch.Tensor, tval: float, n_steps: int,
                      transfer: bool = False):
    """Alpha of one step_size of density at normalized points (n, 3), all at
    time ``tval``: advect to the keyframe (``transfer``: to t = 0), look the
    density up (K1d), decode.  The params are not cast, as in the JAX
    package: in bf16 the velocity net runs in float32 and only the density
    lookup takes its bf16 arm."""
    t = torch.full((xyz_c.shape[0], 1), tval, dtype=torch.float32, device=xyz_c.device)
    base = torch.zeros_like(t) if transfer else snap_to_keyframe(meta, t)
    prev = integrate_pos(params, meta, xyz_c, t, base, n_steps=n_steps)
    xyzt = torch.cat([prev, normalize_time(meta, base)], dim=-1)
    aux = {"times": t[..., 0], "time_offset": (t - base)[..., 0]}
    sigma = feature2density(meta, density_feature(params, meta, xyzt), aux)
    return 1.0 - torch.exp(-sigma * meta.step_size)


@torch.inference_mode()
def compute_dense_alpha(params, meta: KPlaneMeta, grid_size: tuple, transfer: bool = False,
                        n_times: int = 60, chunk: int = 262144, device="cuda"):
    """Max-over-time dense alpha grid.

    Sweeps t over ``i / n_times`` and advects the grid points to their
    keyframe before the density lookup (K1d); ``transfer`` (the motion
    transfer mask) advects them to t = 0 with ``meta.transfer_adv_steps``.  The grid coordinates are made
    on the host with numpy and moved to ``device`` in fixed-size chunks, the
    last one padded with zeros; each chunk keeps a running max over the times.
    Returns (alpha (gx,gy,gz) tensor on ``device``, dense_xyz (gx,gy,gz,3)
    numpy array of world coords).
    """
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
        # of one post-snap offset, only t > tmax the full extrapolation bound;
        # the transfer sweep takes the [0, 1] bound at every time, as JAX does
        if transfer:
            n_steps = meta.transfer_adv_steps
        else:
            n_steps = meta.snap_steps if tval <= meta.tmax + 1e-6 else meta.render_adv_steps
        for c in range(chunks.shape[0]):
            torch.maximum(alpha[c],
                          dense_alpha_chunk(params, meta, chunks[c], tval, n_steps, transfer),
                          out=alpha[c])
    return alpha.reshape(-1)[:total].reshape(gx, gy, gz), dense_xyz


@torch.inference_mode()
def update_alpha_mask(params, meta: KPlaneMeta, grid_size: tuple, transfer: bool = False,
                      device="cuda"):
    """Build the binary occupancy volume and the proposed shrunk aabb
    (``transfer``: of the motion transfer render, from the density at t = 0).

    Returns (alpha_state, new_aabb (2,3) numpy).  ``alpha_state`` holds
    tensors on ``device``: ``volume`` (D,H,W) = (gz,gy,gx) so that x indexes
    W, the ``aabb`` (2,3) the mask was built in, ``dilated``, the
    corner-dilated volume of ``sample_occupied``, ``bits``, the cell bits of
    ``sample_alpha`` (``ops.occupancy.occupancy_bits``), and ``occupied``, the
    occupied bits of ``dilated`` that ``sample_occupied`` reads
    (``ops.occupancy.occupied_bits``); the two bit arrays are derived, never
    saved.
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
    dilated = corner_dilate(vol)
    alpha_state = {
        "volume": vol,
        "aabb": torch.as_tensor(meta.aabb_np, device=vol.device),
        "dilated": dilated,
        "bits": occupancy.occupancy_bits(vol),
        "occupied": occupancy.occupied_bits(dilated),
    }
    return alpha_state, new_aabb


# ---------------------------------------------------------------------------
# Stage transitions: upsample and shrink
# ---------------------------------------------------------------------------

def _new_leaf(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of a plane, a leaf of its own: a crop is a
    view that would pin the old plane, and K1 / K1b take their 16-byte plans
    only on contiguous, aligned rows."""
    return x.detach().clone(memory_format=torch.contiguous_format).requires_grad_(True)


@torch.no_grad()
def upsample(params: dict, meta: KPlaneMeta, res_target: tuple, new_keyframes: int):
    """Resize every plane to a new resolution and keyframe count
    (``resize_bilinear_ac``, align_corners=True).  Returns (params, meta);
    the planes are new leaves, the other params are the same tensors."""
    res_target = tuple(int(r) for r in res_target)
    new_params = dict(params)

    def up_space(plane, i):
        m0, m1 = MAT_SPACE[i]
        return _new_leaf(resize_bilinear_ac(plane, (res_target[m1], res_target[m0]), axes=(0, 1)))

    def up_time(plane, i):
        m0, _ = MAT_TIME[i]
        return _new_leaf(resize_bilinear_ac(plane, (new_keyframes, res_target[m0]), axes=(0, 1)))

    new_params["planes_space"] = [up_space(p, i) for i, p in enumerate(params["planes_space"])]
    new_params["planes_time"] = [up_time(p, i) for i, p in enumerate(params["planes_time"])]
    return new_params, replace(meta, grid_size=res_target, num_keyframes=int(new_keyframes))


@torch.no_grad()
def shrink(params: dict, meta: KPlaneMeta, new_aabb: np.ndarray):
    """Crop the planes to a tightened aabb, snapped to the cropped voxels.
    A 'sur' velocity gate is re-normalized to the new aabb, so it keeps
    covering the same world box.  Returns (params, meta); the planes are new
    contiguous leaves."""
    a = meta.aabb_np
    units = meta.units
    gs = np.asarray(meta.grid_size)
    xyz_min, xyz_max = np.asarray(new_aabb)
    t_l = np.round(np.round((xyz_min - a[0]) / units)).astype(np.int64)
    b_r = np.round((xyz_max - a[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, gs)
    t_l = np.clip(t_l, 0, None)

    new_params = dict(params)

    def crop_space(plane, i):
        m0, m1 = MAT_SPACE[i]
        return _new_leaf(plane[t_l[m1]:b_r[m1], t_l[m0]:b_r[m0], :])

    def crop_time(plane, i):
        m0, _ = MAT_TIME[i]
        return _new_leaf(plane[:, t_l[m0]:b_r[m0], :])

    new_params["planes_space"] = [crop_space(p, i) for i, p in enumerate(params["planes_space"])]
    new_params["planes_time"] = [crop_time(p, i) for i, p in enumerate(params["planes_time"])]

    # the aabb snapped to the cropped voxel boundaries
    t_l_r = t_l / (gs - 1)
    b_r_r = (b_r - 1) / (gs - 1)
    correct = np.zeros((2, 3), dtype=np.float32)
    correct[0] = (1 - t_l_r) * a[0] + t_l_r * a[1]
    correct[1] = (1 - b_r_r) * a[0] + b_r_r * a[1]

    new_size = tuple(int(v) for v in (b_r - t_l))
    new_aabb_t = tuple(tuple(float(v) for v in row) for row in correct)
    gate = meta.vel_gate
    if gate.mode == "sur" and gate.world:
        sur = np.asarray(gate.world, dtype=np.float64)
        nb = (sur - correct[0]) * 2.0 / (correct[1] - correct[0]) - 1.0
        gate = gate._replace(bounds=(tuple(nb[0].tolist()), tuple(nb[1].tolist())))
    return new_params, replace(meta, grid_size=new_size, aabb=new_aabb_t, vel_gate=gate)


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------

def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; ``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def _plane_mean_sum(values, count: int, shard: ChannelShard | None) -> torch.Tensor:
    """``torch.mean`` of a plane's channels, or on a slice (``shard``) its
    channels' sum over the whole plane's ``count`` (the sum over the model
    axis then gives the mean)."""
    return torch.mean(values) if shard is None else torch.sum(values) / count


def _over_model(total, shard: ChannelShard | None):
    """A regularizer's slice partials summed over the model axis (identity
    backward: each slice's channels take their own share)."""
    return total if shard is None else _SumOverModel.apply(total, shard)


def density_l1(params, meta: KPlaneMeta) -> torch.Tensor:
    """L1 of the density channels; the time planes are penalized toward 1.

    The time planes start as ones, where |1 - p| sits at its kink: JAX's
    derivative there (+1) moves every density channel of them from the
    first step, so the port takes it too.  Inside :func:`channel_shard` each
    slice sums its density channels over the whole count and the sum over
    the model axis gives the mean."""
    shard = current_shard()
    cd = meta.density_n_comp
    cd_m = cd if shard is None else shard.density_channels(meta)
    total = 0.0
    for p in params["planes_space"]:
        total = total + _plane_mean_sum(abs_jax(p[..., :cd_m]), p[..., 0].numel() * cd, shard)
    for p in params["planes_time"]:
        total = total + _plane_mean_sum(abs_jax(1.0 - p[..., :cd_m]), p[..., 0].numel() * cd,
                                        shard)
    return _over_model(total, shard)


def _tv(plane: torch.Tensor, t_axis: bool, channels: int | None = None) -> torch.Tensor:
    """Plain first-difference TV of an (H, W, C) plane; a time plane weighs
    its keyframe axis x3 (and counts H - 2 rows there, as the JAX package).
    ``channels``: the whole plane's C where ``plane`` holds a slice of it
    (its share of the TV over the whole count)."""
    h, w, c = plane.shape
    c = c if channels is None else channels
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
    shard = current_shard()
    cd = meta.density_n_comp
    cd_m = cd if shard is None else shard.density_channels(meta)
    total = 0.0
    for p in params["planes_space"]:
        total = total + _tv(p[..., :cd_m], False, cd) * 1e-2
    if meta.num_keyframes > 1:
        for p in params["planes_time"]:
            total = total + _tv(p[..., :cd_m], True, cd) * 1e-2
    return _over_model(total, shard)


def tv_loss_app(params, meta: KPlaneMeta) -> torch.Tensor:
    shard = current_shard()
    cd_m = meta.density_n_comp if shard is None else shard.density_channels(meta)
    total = 0.0
    for p in params["planes_space"]:
        total = total + _tv(p[..., cd_m:], False, meta.app_n_comp) * 1e-2
    return _over_model(total, shard)

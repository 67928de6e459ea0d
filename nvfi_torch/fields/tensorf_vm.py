"""Static TensoRF fields: the VM (plane x line) and CP (line x line x line)
decompositions, their render, mask and stage transitions.

Port of ``nvfi_tpu/fields/tensorf_vm.py``.  Density is the sum over the three
(plane, line) pairs (``MAT_SPACE`` / ``VEC_MODE``) and their channels of
plane x line; appearance concatenates the three per-pair products and decodes
them through a shared linear basis.  The lookup is kernel K6 (density and
app in one pass), the mask build's density-only lookup K6d, and the
gradient of the lookup K6b (``ops.plane_line``); the render's tail, alpha,
weights and the per-ray sums, is kernel K2 (``ops.compositing.composite``)
and, under a mask at eval, the trilinear mask lookup kernel K3.  The basis
matmul and the MLP_PE shader stay plain PyTorch, as the JAX package leaves
them to XLA.  Random draws (the stratified jitter, the background coin) are
arguments.

Two behaviours of the JAX module are kept as they are (ROADMAP.md C):
``render_rays`` looks the mask up without the model's box (``sample_alpha``
with no meta) while ``update_alpha_mask`` stores the box before the shrink,
so after a shrink the eval lookup is taken in the old box; and the view
directions are the unnormalized ``rays_d``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import occupancy
from ..ops.compositing import composite
from ..ops.grid_sample import MAT_SPACE
from ..ops.plane_line import VEC_MODE, plane_line, plane_line_density
from ..ops.resize import max_pool3d_same, resize_bilinear_ac
from .kplane import _f32, _new_leaf, _tv, abs_jax, map_params, sample_alpha
from .mlp import linear_init
from .shaders import init_shader, make_shader

DECOMPOSITIONS = ("VM", "CP")


@dataclass(frozen=True)
class StaticMeta:
    """Static structure of a TensoRF scene (the JAX package's fields and
    defaults)."""

    grid_size: tuple
    aabb: tuple
    near_far: tuple
    density_n_comp: int
    app_n_comp: int
    app_dim: int
    density_shift: float
    distance_scale: float
    alpha_mask_thres: float
    raymarch_weight_thres: float
    decomposition: str = "VM"  # 'VM' | 'CP'
    fea2dense: str = "softplus"
    shading_mode: str = "MLP_PE"
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    feature_c: int = 128
    step_ratio: float = 0.5
    max_n_samples: int = 1024

    @property
    def aabb_np(self) -> np.ndarray:
        return np.asarray(self.aabb, dtype=np.float32)

    @property
    def aabb_size(self) -> np.ndarray:
        a = self.aabb_np
        return a[1] - a[0]

    @property
    def step_size(self) -> float:
        units = self.aabb_size / (np.asarray(self.grid_size) - 1)
        return float(np.mean(units) * self.step_ratio)

    @property
    def n_samples(self) -> int:
        diag = float(np.linalg.norm(self.aabb_size))
        return min(self.max_n_samples, int(diag / self.step_size) + 1)


def init_params(generator: torch.Generator, meta: StaticMeta, device="cuda") -> dict:
    """Scene params in the JAX package's layout, drawn on the CPU from
    ``generator`` and moved to ``device``: VM planes and lines N(0, 1) x 0.1,
    CP lines x 0.2, the basis without bias, the shader.  The values differ
    from JAX's for the same seed: carry JAX params across with
    ``train.checkpoint.static_params_from_numpy`` where equality matters."""
    if meta.decomposition not in DECOMPOSITIONS:
        raise ValueError(meta.decomposition)
    dev = resolve_device(device)
    gs = meta.grid_size

    def normal(scale, *shape):
        return scale * torch.randn(*shape, generator=generator)

    def line(i, c, scale):
        return normal(scale, gs[VEC_MODE[i]], c)

    params = {}
    if meta.decomposition == "VM":
        def plane(i, c):
            m0, m1 = MAT_SPACE[i]
            return normal(0.1, gs[m1], gs[m0], c)

        params["density_plane"] = [plane(i, meta.density_n_comp) for i in range(3)]
        params["density_line"] = [line(i, meta.density_n_comp, 0.1) for i in range(3)]
        params["app_plane"] = [plane(i, meta.app_n_comp) for i in range(3)]
        params["app_line"] = [line(i, meta.app_n_comp, 0.1) for i in range(3)]
        params["basis_mat"] = linear_init(generator, 3 * meta.app_n_comp, meta.app_dim,
                                          bias=False)
    else:
        params["density_line"] = [line(i, meta.density_n_comp, 0.2) for i in range(3)]
        params["app_line"] = [line(i, meta.app_n_comp, 0.2) for i in range(3)]
        params["basis_mat"] = linear_init(generator, meta.app_n_comp, meta.app_dim, bias=False)
    params["shader"] = init_shader(generator, meta.shading_mode, meta.app_dim, meta.view_pe,
                                   meta.pos_pe, meta.fea_pe, meta.feature_c)
    return map_params(lambda x: x.to(dev), params)


def normalize_coord(meta: StaticMeta, xyz: torch.Tensor) -> torch.Tensor:
    a = meta.aabb_np
    return (xyz - _f32(a[0], xyz)) * _f32(2.0 / (a[1] - a[0]), xyz) - 1.0


def _planes(params, meta: StaticMeta, kind: str):
    return params[f"{kind}_plane"] if meta.decomposition == "VM" else None


def features(params, meta: StaticMeta, xyz: torch.Tensor):
    """(..., 3) normalized -> density feature (...,) and app features
    (..., app_dim): one pass of K6, then the basis as a plain matmul."""
    batch = xyz.shape[:-1]
    density, app = plane_line(_planes(params, meta, "density"), params["density_line"],
                              _planes(params, meta, "app"), params["app_line"],
                              xyz.reshape(-1, 3).contiguous())
    app = app @ params["basis_mat"]["w"]
    return density.reshape(batch), app.reshape(*batch, -1)


def density_feature(params, meta: StaticMeta, xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) normalized -> density feature (...,) (K6d)."""
    density = plane_line_density(_planes(params, meta, "density"), params["density_line"],
                                 xyz.reshape(-1, 3).contiguous())
    return density.reshape(xyz.shape[:-1])


def app_feature(params, meta: StaticMeta, xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) normalized -> (..., app_dim) (K6's app output and the basis)."""
    return features(params, meta, xyz)[1]


def feature2density(meta: StaticMeta, x: torch.Tensor) -> torch.Tensor:
    if meta.fea2dense == "softplus":
        return F.softplus(x + meta.density_shift)
    if meta.fea2dense == "relu":
        return F.relu(x)
    if meta.fea2dense == "relu_abs":
        return torch.abs(x)
    raise ValueError(meta.fea2dense)


def sample_ray(meta: StaticMeta, rays_o: torch.Tensor, rays_d: torch.Tensor, n_samples: int,
               jitter: torch.Tensor | None = None):
    """Uniform-in-box sampling (JAX ``tensorf_vm.sample_ray``): every ray
    starts at ``near`` if any origin of the batch lies inside the box, else
    at its own box entry.  ``jitter`` (N, 1) in [0, 1) is the per-ray
    stratified offset of a training render.  Returns (pts (N,S,3), z_vals
    (N,S), valid (N,S))."""
    a = meta.aabb_np
    a0, a1 = _f32(a[0], rays_o), _f32(a[1], rays_o)
    near, far = meta.near_far
    inside_any = torch.any(torch.all((rays_o >= a0) & (rays_o <= a1), dim=-1))
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


def render_rays(params, meta: StaticMeta, rays_o, rays_d, *, white_bg: bool,
                training: bool = False, alpha_state=None, n_samples: int | None = None,
                jitter=None, bg_coin: bool | None = None, device="cuda"):
    """Static volume render (JAX ``tensorf_vm.render_rays``).

    An eval render runs under ``inference_mode``; a training render under
    autograd (K6b and K2b on the card).

    Args:
      params: on ``device`` (``init_params`` / ``static_params_from_numpy``).
      rays_o, rays_d: (N, 3); directions unnormalized (and the view
        directions of the shader as they are, as in the JAX package).
      alpha_state: optional mask (``update_alpha_mask``); at eval the samples
        whose trilinear mask value is 0 get zero density (K3).  The lookup
        takes the coords in the model's current box as the mask's own, as
        JAX's does (no meta: see the module note).
      jitter: (N, 1) in [0, 1), required when training.
      bg_coin: required when training without ``white_bg``: True composites
        this batch over white (JAX's coin flip).
    Returns:
      dict with rgb (N, 3), depth (N,), acc (N,), weight (N, S).
    """
    if training and jitter is None:
        raise ValueError("render_rays(training=True) needs jitter (N, 1)")
    if training and not white_bg and bg_coin is None:
        raise ValueError("render_rays(training=True, white_bg=False) needs bg_coin")
    if n_samples is None:
        n_samples = meta.n_samples
    with contextlib.nullcontext() if training else torch.inference_mode():
        dev = resolve_device(device)
        if params["density_line"][0].device != dev:
            raise ValueError(f"render_rays: params are on {params['density_line'][0].device}, "
                             f"device is {dev}")
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
        N = rays_o.shape[0]
        if training:
            jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev).reshape(N, 1)
        pts, z_vals, valid = sample_ray(meta, rays_o, rays_d, n_samples,
                                        jitter if training else None)
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])],
                          dim=-1)
        xyz = normalize_coord(meta, pts)
        if alpha_state is not None and not training:
            valid = valid & (sample_alpha(alpha_state, xyz) > 0)

        density, app = features(params, meta, xyz)
        sigma = torch.where(valid, feature2density(meta, density), 0.0)
        shader = make_shader(meta.shading_mode, meta.view_pe, meta.pos_pe, meta.fea_pe)
        S = z_vals.shape[1]
        rgb_pts = shader(params["shader"], xyz, rays_d[:, None, :].expand(N, S, 3), app)
        # K2: raw2alpha, the app mask (colour zeroed at or below the
        # threshold), the sums, the background and the clip
        over_white = white_bg or (training and bool(bg_coin))
        weight, acc, rgb, depth = composite(
            sigma.contiguous(), (dists * meta.distance_scale).contiguous(),
            z_vals.contiguous(), rgb_pts.contiguous(), meta.raymarch_weight_thres, over_white,
            meta.near_far[1])
        return {"rgb": rgb, "depth": depth, "acc": acc, "weight": weight}


# ---------------------------------------------------------------------------
# Stage transitions and regularizers
# ---------------------------------------------------------------------------

@torch.no_grad()
def upsample(params: dict, meta: StaticMeta, res_target: tuple):
    """Resize planes and lines to ``res_target`` (align_corners=True).
    Returns (params, meta); the planes and lines are new leaves."""
    res_target = tuple(int(r) for r in res_target)
    new_params = dict(params)
    if meta.decomposition == "VM":
        for name in ("density_plane", "app_plane"):
            new_params[name] = [
                _new_leaf(resize_bilinear_ac(p, (res_target[MAT_SPACE[i][1]],
                                                 res_target[MAT_SPACE[i][0]]), axes=(0, 1)))
                for i, p in enumerate(params[name])]
    for name in ("density_line", "app_line"):
        new_params[name] = [_new_leaf(resize_bilinear_ac(p, (res_target[VEC_MODE[i]],),
                                                         axes=(0,)))
                            for i, p in enumerate(params[name])]
    return new_params, replace(meta, grid_size=res_target)


def density_l1(params, meta: StaticMeta) -> torch.Tensor:
    """Mean |x| of the density planes (VM) and lines, with JAX's derivative
    at 0."""
    total = 0.0
    if meta.decomposition == "VM":
        for p in params["density_plane"]:
            total = total + torch.mean(abs_jax(p))
    for p in params["density_line"]:
        total = total + torch.mean(abs_jax(p))
    return total


def tv_loss_density(params, meta: StaticMeta):
    """Plane TV x 1e-2 of the density planes (VM; 0 for CP)."""
    total = 0.0
    if meta.decomposition == "VM":
        for p in params["density_plane"]:
            total = total + _tv(p, False) * 1e-2
    return total


def tv_loss_app(params, meta: StaticMeta):
    """Plane TV x 1e-2 of the app planes (VM; 0 for CP)."""
    total = 0.0
    if meta.decomposition == "VM":
        for p in params["app_plane"]:
            total = total + _tv(p, False) * 1e-2
    return total


# ---------------------------------------------------------------------------
# Alpha mask and shrink
# ---------------------------------------------------------------------------

@torch.inference_mode()
def compute_dense_alpha(params, meta: StaticMeta, grid_size: tuple, chunk: int = 262144,
                        device="cuda"):
    """Dense alpha grid ``1 - exp(-sigma * 0.01 * distance_scale)`` (the
    hard-coded 0.01 step of JAX and the reference) at the grid points of the
    box, in chunks of ``chunk`` points through K6d, the last padded with
    zeros.  Returns (alpha (gx,gy,gz) tensor on ``device``, dense_xyz
    (gx,gy,gz,3) numpy world coords)."""
    dev = resolve_device(device)
    gx, gy, gz = grid_size
    a = meta.aabb_np
    lin = [np.linspace(0.0, 1.0, g, dtype=np.float32) for g in (gx, gy, gz)]
    mesh = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1)
    dense_xyz = a[0] * (1 - mesh) + a[1] * mesh
    flat = ((dense_xyz.reshape(-1, 3) - a[0]) * (2.0 / (a[1] - a[0])) - 1.0).astype(np.float32)
    total = flat.shape[0]
    chunk = min(chunk, total)
    pad = (-total) % chunk
    padded = np.concatenate([flat, np.zeros((pad, 3), np.float32)]) if pad else flat
    chunks = torch.as_tensor(padded, device=dev).reshape(-1, chunk, 3)
    out = []
    for c in range(chunks.shape[0]):
        sigma = feature2density(meta, density_feature(params, meta, chunks[c]))
        out.append(1.0 - torch.exp(-sigma * 0.01 * meta.distance_scale))
    alpha = torch.cat(out)[:total]
    return alpha.reshape(gx, gy, gz), dense_xyz


@torch.inference_mode()
def update_alpha_mask(params, meta: StaticMeta, grid_size: tuple, device="cuda"):
    """The binary occupancy volume (D,H,W) = (gz,gy,gx) and the proposed
    shrunk aabb (JAX ``tensorf_vm.update_alpha_mask``).  Returns (alpha_state,
    new_aabb (2,3) numpy); the state holds ``volume``, the ``aabb`` the mask
    was built in (the box before the shrink that follows) and ``bits``, the
    volume's cell bits that K3 reads (``ops.occupancy.occupancy_bits``)."""
    alpha, dense_xyz = compute_dense_alpha(params, meta, grid_size, device=device)
    alpha = torch.clamp(alpha, 0, 1).permute(2, 1, 0)
    alpha = max_pool3d_same(alpha, kernel=3)
    vol = (alpha >= _f32(meta.alpha_mask_thres, alpha)).to(torch.float32).contiguous()
    occ = vol.cpu().numpy() > 0.5
    if occ.any():
        valid_xyz = dense_xyz.transpose(2, 1, 0, 3)[occ]
        new_aabb = np.stack([valid_xyz.min(0), valid_xyz.max(0)])
    else:
        new_aabb = meta.aabb_np.copy()
    state = {"volume": vol, "aabb": torch.as_tensor(meta.aabb_np, device=vol.device),
             "bits": occupancy.occupancy_bits(vol)}
    return state, new_aabb


@torch.no_grad()
def shrink(params: dict, meta: StaticMeta, new_aabb):
    """Crop planes and lines to a tightened aabb, snapped to the voxel
    boundaries (JAX ``tensorf_vm.shrink``, its double round kept).  Returns
    (params, meta); the crops are new contiguous leaves."""
    a = meta.aabb_np
    gs = np.asarray(meta.grid_size)
    units = meta.aabb_size / (gs - 1)
    xyz_min, xyz_max = np.asarray(new_aabb)
    t_l = np.round(np.round((xyz_min - a[0]) / units)).astype(np.int64)
    b_r = np.round((xyz_max - a[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, gs)
    t_l = np.clip(t_l, 0, None)

    new_params = dict(params)
    if meta.decomposition == "VM":
        for name in ("density_plane", "app_plane"):
            new_params[name] = [
                _new_leaf(p[t_l[MAT_SPACE[i][1]]:b_r[MAT_SPACE[i][1]],
                            t_l[MAT_SPACE[i][0]]:b_r[MAT_SPACE[i][0]], :])
                for i, p in enumerate(params[name])]
    for name in ("density_line", "app_line"):
        new_params[name] = [_new_leaf(p[t_l[VEC_MODE[i]]:b_r[VEC_MODE[i]], :])
                            for i, p in enumerate(params[name])]

    t_l_r = t_l / (gs - 1)
    b_r_r = (b_r - 1) / (gs - 1)
    correct = np.zeros((2, 3), dtype=np.float32)
    correct[0] = (1 - t_l_r) * a[0] + t_l_r * a[1]
    correct[1] = (1 - b_r_r) * a[0] + b_r_r * a[1]
    new_meta = replace(meta, grid_size=tuple(int(v) for v in (b_r - t_l)),
                       aabb=tuple(tuple(float(v) for v in row) for row in correct))
    return new_params, new_meta

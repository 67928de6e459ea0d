"""The train step and the staged trainer (port of ``nvfi_tpu/train/trainer.py``).

Ported: the hyper-parameters (``TrainHP``), the schedules, the pinhole rays
of a training batch, the per-iteration loss (``make_loss_fn``: the
random-time and keyframe render batches in ray chunks, each from one frame
or, with ``multi_frame``, every ray from a frame of its own,
the L1 / TV / PDE regularizers with their decayed weights, the velocity
probe), ``make_train_step`` = the loss's gradient + the per-group Adam
update, for the modes ``static``, ``static_dynamic``, ``dynamic`` and
``vel``, and the stage loop around it (``Trainer``): the coarse-to-fine
upsamples, the alpha-mask events with their shrink, the L1 weight switch,
turbo's budget probes, the exactness counters, checkpoints and resume.

Two things differ from the JAX original by construction:

* **Random draws are inputs.**  What JAX draws from its key inside the loss
  (pixel ids, per-chunk jitter and background coin, the PDE points, times
  and selection noise, the probe points) comes in as a :class:`TrainDraws`;
  :func:`draw_train_inputs` makes one on the device from a
  ``torch.Generator``.  The ``Trainer`` picks its frames with JAX's numpy
  generator, so both packages train on the same frames.
* **The gradient is taken chunk by chunk.**  ``jax.checkpoint`` + ``scan``
  bound the activation memory of a step to one ray chunk; here each chunk's
  share of the loss is back-propagated as soon as it is computed, which
  accumulates into the leaves' ``.grad``.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..eval.metrics import mse2psnr
from ..fields import kplane
from ..fields import velocity as vel_mod
from ..physics.pde import vel_pde_loss
from . import checkpoint, optim
from . import turbo as turbo_mod
from .supervisor import touch

MODES = ("static", "static_dynamic", "dynamic", "vel")
PROBE_POINTS = 2048  # the velocity-health probe's sample count


def n_to_reso(n_voxels: int, aabb: np.ndarray) -> list:
    """Voxel count -> per-axis resolution.  The float floor matters: 8e6
    voxels in [-2, 2]^3 give 199, not 200, per axis."""
    xyz_min, xyz_max = np.asarray(aabb, dtype=np.float64)
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1 / 3)
    return [int(v) for v in ((xyz_max - xyz_min) / voxel_size)]


def exp_schedule(v0: int, v1: int, n: int) -> list:
    """Exp-spaced schedule from v0 to v1 in n steps, the initial value dropped."""
    return [int(round(v)) for v in np.exp(np.linspace(np.log(v0), np.log(v1), n + 1))][1:]


@dataclass
class TrainHP:
    """Hyper-parameters of the reference ``cfg.experiment`` block (the JAX
    package's names and defaults)."""

    lr_grid: float = 0.02
    lr_net: float = 1e-3
    lr_vel: float = 1e-3
    lr_decay_target_ratio: float = 0.1
    lr_decay_iters: int = -1
    lr_upsample_reset: bool = True
    train_iters: int = 30000
    n_rays: int = 2048
    point_batch: int = 131072  # renderer.batch_size: ray chunks hold about this many samples
    L1_weight_initial: float = 8e-4
    L1_weight_reset: float = 4e-4
    TV_weight_density: float = 1.0
    TV_weight_app: float = 1.0
    vel_reg_weight: float = 1.0
    vel_reg_no_decay: bool = False  # hold the PDE weight instead of decaying it
    vel_reg_n_pts: int = 262144
    vel_occupied_budget: int = 32768  # Jacobian point budget
    pde_mask_filter: bool = False  # filter the PDE points by the alpha volume alone
    pde_prefilter: bool = True  # the alpha volume routes the Jacobian budget
    upsamp_list: tuple = (2000, 4000, 6000, 8000, 10000)
    update_alphamask_list: tuple = ()
    n_voxel_init: int = 262144
    n_voxel_final: int = 8000000
    num_keyframes_end: int = 16
    white_bg: bool = True
    multi_frame: bool = False
    ndc: bool = False
    ndc_near: float = 1.0  # the NDC projection's near plane
    save_every: int = 5000
    print_every: int = 500
    validate_every: int = 1000

    @property
    def lr_factor(self) -> float:
        iters = self.lr_decay_iters if self.lr_decay_iters > 0 else self.train_iters
        return self.lr_decay_target_ratio ** (1.0 / iters)

    @classmethod
    def from_cfg(cls, cfg) -> "TrainHP":
        e = cfg.experiment
        return cls(
            lr_grid=float(e.lr_grid),
            lr_net=float(e.lr_net),
            lr_vel=float(e.get("lr_vel", e.lr_net)),
            lr_decay_target_ratio=float(e.lr_decay_target_ratio),
            lr_decay_iters=int(e.lr_decay_iters),
            lr_upsample_reset=bool(e.lr_upsample_reset),
            train_iters=int(e.train_iters),
            n_rays=int(cfg.renderer.n_rays),
            point_batch=int(cfg.renderer.get("batch_size", 131072)),
            # [sic] the reference's spelling of the key
            L1_weight_initial=float(e.get("L1_weight_inital", 0.0)),
            L1_weight_reset=float(e.get("L1_weight_reset", 0.0)),
            TV_weight_density=float(e.TV_weight_density),
            TV_weight_app=float(e.TV_weight_app),
            vel_reg_weight=float(e.vel_reg_weight),
            vel_reg_no_decay=bool(e.get("vel_reg_no_decay", False)),
            vel_reg_n_pts=int(e.vel_reg_n_pts),
            vel_occupied_budget=int(e.get("vel_occupied_budget", 32768)),
            pde_mask_filter=bool(e.get("pde_mask_filter", False)),
            pde_prefilter=bool(e.get("pde_prefilter", True)),
            upsamp_list=tuple(cfg.nvfi.upsamp_list),
            update_alphamask_list=tuple(cfg.nvfi.update_AlphaMask_list),
            n_voxel_init=int(cfg.nvfi.N_voxel_init),
            n_voxel_final=int(cfg.nvfi.N_voxel_final),
            num_keyframes_end=int(cfg.nvfi.num_keyframes_end),
            white_bg=bool(cfg.dataset.white_background),
            multi_frame=bool(e.get("multi_frame_batch", False)),
            ndc=bool(cfg.renderer.get("ndc", False)),
            ndc_near=float(cfg.renderer.get("ndc_near", 1.0)),
            save_every=int(e.save_every),
            print_every=int(e.print_every),
            validate_every=int(e.validate_every),
        )


def decay_scales(lr_factor: float, upsample_reset: bool, opt_step, global_step):
    """Learning-rate decay positions: (grid/net scale, velocity scale).

    With ``upsample_reset`` the grid/net groups restart their exponential
    decay at each stage (``opt_step`` counts from the stage start); without
    it they follow the global decay.  The velocity group always follows the
    global decay."""
    base = lr_factor ** (opt_step if upsample_reset else global_step)
    return base, lr_factor ** global_step


def ray_chunking(meta: kplane.KPlaneMeta, hp: TrainHP) -> tuple[int, int]:
    """(rays per chunk, chunks per batch): about ``point_batch`` samples a
    chunk, lowered until it divides ``n_rays`` (the JAX package's rule).
    Under a block budget only about that share of a chunk's samples reaches
    the density pass, so the chunk grows by ``min(2, 1 / max(budget, 0.25))``
    (at bat's budgets: 256 rays a chunk, not 128)."""
    point_batch = hp.point_batch
    if 0.0 < meta.block_budget < 1.0:
        point_batch = int(point_batch * min(2.0, 1.0 / max(meta.block_budget, 0.25)))
    ray_chunk = max(1, point_batch // max(meta.n_samples, 1))
    while hp.n_rays % ray_chunk:
        ray_chunk -= 1
    return ray_chunk, hp.n_rays // ray_chunk


def _pixel_dirs(H: int, W: int, focal: float, ii, jj):
    """Camera-space directions of pixels (ii, jj), OpenGL convention (as
    ``render.rays.ray_bundle`` makes them on the host)."""
    x = (jj.to(torch.float32) - W * 0.5) / focal
    y = -(ii.to(torch.float32) - H * 0.5) / focal
    return torch.stack([x, y, -torch.ones_like(x)], dim=-1)


def _rays_from_pose(pose: torch.Tensor, H: int, W: int, focal: float, ii, jj):
    """Pinhole rays of one camera at pixels (ii, jj)."""
    ray_d = _pixel_dirs(H, W, focal, ii, jj) @ pose[:3, :3].T
    ray_o = pose[:3, 3].expand(ray_d.shape)
    return ray_o, ray_d


def _rays_from_poses(poses: torch.Tensor, H: int, W: int, focal: float, ii, jj):
    """Pinhole rays at pixels (ii, jj), each of its own camera: ``poses``
    (n, 4, 4), one a ray."""
    ray_d = torch.einsum("nj,nij->ni", _pixel_dirs(H, W, focal, ii, jj), poses[:, :3, :3])
    return poses[:, :3, 3], ray_d


@dataclass
class TrainDraws:
    """The random numbers of one training iteration (what the JAX package
    draws from its key inside the loss).  The ``*_t`` fields belong to the
    random-time batch, the ``*_0`` fields to the keyframe batch; a field a
    mode does not use may be None.  A multi-frame batch (``hp.multi_frame``)
    also draws each ray's frame (``frames_*``, from the frame pool of its
    batch) and its pixel ids with replacement (JAX's ``randint``,
    ``nvfi_tpu/train/trainer.py:238-240``); a single-frame batch draws
    distinct pixels and no frames."""

    pix_t: torch.Tensor | None  # (n_rays,) flat pixel ids
    pix_0: torch.Tensor | None
    jitter_t: torch.Tensor | None  # (n_chunks, ray_chunk, 1) in [0, 1)
    jitter_0: torch.Tensor | None
    coin_t: list | None  # n_chunks bools: composite this chunk over white
    coin_0: list | None  # (read only without white_bg)
    pde_points: torch.Tensor | None  # (n, 3) in [0, 1)
    pde_times: torch.Tensor | None  # (n, 1) in [0, 1)
    pde_noise: torch.Tensor | None  # (n,) in [0, 1)
    probe_x: torch.Tensor | None  # (2048, 3) in [-1, 1)
    probe_t: torch.Tensor | None  # (2048, 1) in [0, 1)
    frames_t: torch.Tensor | None = None  # (n_rays,) frame of each ray (multi-frame)
    frames_0: torch.Tensor | None = None


def draw_train_inputs(generator: torch.Generator, meta: kplane.KPlaneMeta, hp: TrainHP,
                      H: int, W: int, vel_pts: int | None = None, pool_all=None,
                      pool_key=None) -> TrainDraws:
    """One iteration's draws from ``generator``, on the generator's device.
    A multi-frame batch draws its frames from a pool of frame indices:
    ``pool_all`` for the random-time batch, ``pool_key`` (the frames at a
    keyframe time) for the keyframe batch."""
    dev = generator.device
    ray_chunk, n_chunks = ray_chunking(meta, hp)
    n_pde = vel_pts if vel_pts is not None else hp.vel_reg_n_pts
    if hp.multi_frame and (pool_all is None or pool_key is None):
        raise ValueError("multi-frame draws need pool_all and pool_key")

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    def batch(pool):
        """(frames, pixel ids) of one batch."""
        if not hp.multi_frame:
            return None, torch.randperm(H * W, generator=generator, device=dev)[: hp.n_rays]
        pool = torch.as_tensor(pool, dtype=torch.int64, device=dev)
        pick = torch.randint(len(pool), (hp.n_rays,), generator=generator, device=dev)
        return pool[pick], torch.randint(H * W, (hp.n_rays,), generator=generator, device=dev)

    def coins():
        return None if hp.white_bg else (uniform(n_chunks) < 0.5).tolist()

    frames_t, pix_t = batch(pool_all)
    frames_0, pix_0 = batch(pool_key)
    return TrainDraws(
        pix_t=pix_t, pix_0=pix_0,
        jitter_t=uniform(n_chunks, ray_chunk, 1), jitter_0=uniform(n_chunks, ray_chunk, 1),
        coin_t=coins(), coin_0=coins(),
        pde_points=uniform(n_pde, 3), pde_times=uniform(n_pde, 1), pde_noise=uniform(n_pde),
        probe_x=uniform(PROBE_POINTS, 3) * 2.0 - 1.0, probe_t=uniform(PROBE_POINTS, 1),
        frames_t=frames_t, frames_0=frames_0,
    )


def make_loss_fn(meta: kplane.KPlaneMeta, hp: TrainHP, mode: str, H: int, W: int,
                 focal: float, vel_pts: int | None = None, use_alpha: bool = False,
                 device="cuda"):
    """Build the per-iteration loss (renders + regularizers).

    The returned function has the signature
      (params, draws, frame_idx, key_frame_idx, global_step, poses (F,4,4),
       images (F,H,W,3), times (F,), l1_base, l1_step0, alpha_state)
      -> (loss, metrics)
    ``frame_idx``, ``key_frame_idx`` and ``global_step`` are host ints,
    ``l1_base`` and ``l1_step0`` host floats.  With ``hp.multi_frame`` each
    ray of a batch comes from its own frame, ``draws.frames_t`` /
    ``frames_0``, at that frame's time (``nvfi_tpu/train/trainer.py:236-252``),
    and ``frame_idx`` / ``key_frame_idx`` go unused.  Every share of the loss that
    carries a graph (the leaves of ``params`` require grad and autograd is
    on) is back-propagated as soon as it is computed, ray chunk by ray chunk:
    the gradient accumulates into the ``.grad`` of the leaves and the
    returned loss is detached.  Under ``torch.no_grad()`` the function only
    evaluates.  The metrics always carry ``dropped_blocks`` and
    ``dropped_shade``, summed over the chunks as ``render_rays`` reports them
    (0 on the dense branch): 0-d tensors on the device, never read back here.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if hp.ndc or meta.ray_sampling == "ndc":
        raise NotImplementedError("nvfi_torch.trainer: ndc training rays (ROADMAP.md A3) are "
                                  "not ported yet")
    n_rays = hp.n_rays
    n_pde = vel_pts if vel_pts is not None else hp.vel_reg_n_pts
    lr_factor = hp.lr_factor
    dynamic = mode in ("static_dynamic", "dynamic", "vel")
    keyframes = mode in ("static", "static_dynamic")
    use_pde = meta.use_vel and dynamic and hp.vel_reg_weight > 0
    ray_chunk, n_chunks = ray_chunking(meta, hp)

    def add(total, term):
        """Fold one share of the loss into the running total; its graph, if
        it has one, is consumed right away."""
        if term.requires_grad:
            term.backward()
        return total + term.detach()

    def render_batch(params, pix, jitter, coins, frames, poses, images, times, alpha_state,
                     advect):
        """One batch: from frame ``frames`` (an int: one pose, one time) or,
        multi-frame, each ray from its own (a tensor: per-ray poses, and a
        per-ray time that reaches the keyframe snap, the advection and the
        lookup of that ray alone)."""
        ii, jj = pix // W, pix % W
        rays = _rays_from_poses if hp.multi_frame else _rays_from_pose
        ray_o, ray_d = rays(poses[frames], H, W, focal, ii, jj)
        target, t = images[frames, ii, jj], times[frames]
        mse, dropped, dshade = 0.0, 0.0, 0.0
        for c in range(n_chunks):
            rows = slice(c * ray_chunk, (c + 1) * ray_chunk)
            out = kplane.render_rays(
                params, meta, t[rows] if t.dim() else t, ray_o[rows], ray_d[rows],
                white_bg=hp.white_bg, training=True, advect=advect,
                alpha_state=alpha_state if use_alpha else None, jitter=jitter[c],
                bg_coin=None if hp.white_bg else coins[c], device=device)
            sse = torch.sum((out["rgb"] - target[rows]) ** 2)
            mse = add(mse, sse / (n_rays * 3))
            dropped = dropped + out["dropped_blocks"]
            dshade = dshade + out["dropped_shade"]
        return mse, dropped, dshade

    def loss_fn(params, draws: TrainDraws, frame_idx, key_frame_idx, global_step, poses,
                images, times, l1_base, l1_step0, alpha_state):
        gs = float(global_step)
        reg_scale = lr_factor ** (gs + 1.0)
        zero = torch.zeros((), device=poses.device)
        loss, rgb_loss_t, rgb_loss_0 = zero, zero, zero
        dropped, dshade = 0.0, 0.0

        multi = hp.multi_frame  # the frames of both batches are in the draws
        if dynamic:
            rgb_loss_t, d, ds = render_batch(params, draws.pix_t, draws.jitter_t, draws.coin_t,
                                             draws.frames_t if multi else frame_idx, poses,
                                             images, times, alpha_state, True)
            loss, dropped, dshade = loss + rgb_loss_t, dropped + d, dshade + ds
        if keyframes:
            # keyframe batch: its times are exact keyframes, so the advection
            # is a statically known no-op and is skipped
            rgb_loss_0, d, ds = render_batch(params, draws.pix_0, draws.jitter_0, draws.coin_0,
                                             draws.frames_0 if multi else key_frame_idx, poses,
                                             images, times, alpha_state, False)
            loss, dropped, dshade = loss + rgb_loss_0, dropped + d, dshade + ds
        metrics = {"rgb_loss_t": rgb_loss_t, "rgb_loss_0": rgb_loss_0,
                   "dropped_blocks": dropped, "dropped_shade": dshade}

        if keyframes:
            if hp.L1_weight_initial > 0 or (hp.L1_weight_reset > 0 and hp.update_alphamask_list):
                # the weight decays per iteration like the lr and is replaced
                # by L1_weight_reset at the first alpha-mask update: (l1_base,
                # l1_step0) are switched by the caller at that stage event
                l1 = kplane.density_l1(params, meta)
                loss = add(loss, l1_base * lr_factor ** (gs + 1.0 - l1_step0) * l1)
                metrics["l1"] = l1.detach()
            if hp.TV_weight_density > 0:
                tv_d = kplane.tv_loss_density(params, meta)
                loss = add(loss, hp.TV_weight_density * reg_scale * tv_d)
                metrics["tv_density"] = tv_d.detach()
            if hp.TV_weight_app > 0:
                tv_a = kplane.tv_loss_app(params, meta)
                loss = add(loss, hp.TV_weight_app * reg_scale * tv_a)
                metrics["tv_app"] = tv_a.detach()

        if use_pde:
            masked = use_alpha and alpha_state is not None
            pde = vel_pde_loss(
                params, meta, draws.pde_points, draws.pde_times, draws.pde_noise,
                occupied_budget=min(hp.vel_occupied_budget, n_pde),
                alpha_state=alpha_state if (masked and hp.pde_mask_filter) else None,
                prefilter_state=alpha_state if (masked and hp.pde_prefilter
                                                and not hp.pde_mask_filter) else None)
            pde_scale = 1.0 if hp.vel_reg_no_decay else reg_scale
            loss = add(loss, hp.vel_reg_weight * pde_scale * pde)
            metrics["vel_pde"] = pde.detach()

        if meta.use_vel and dynamic:
            # velocity-health probe: mean gated |v| in normalized units over
            # uniform (x, t); a dead field reads ~0
            with torch.no_grad():
                v = vel_mod.gated_velocity(params["vel"], meta.vel_gate, draws.probe_x,
                                           draws.probe_t)
                metrics["vel_mag"] = torch.linalg.norm(v, dim=-1).mean()

        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def init_counters(device="cpu") -> dict:
    """Running max over steps of the per-step dropped_blocks / dropped_shade
    exactness counts that the loss reports: 0-d float32 zeros on ``device``.
    They stay on the device (:func:`update_counters` reads nothing back); the
    caller reads them when it wants to."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("dropped_blocks", "dropped_shade")}


def update_counters(counters: dict, metrics: dict) -> dict:
    """Fold one step's counts into the running max, on the metrics' device."""
    out = {}
    for k, v in counters.items():
        if k in metrics:
            m = torch.as_tensor(metrics[k], dtype=torch.float32)
            v = torch.maximum(torch.as_tensor(v, dtype=torch.float32).to(m.device), m)
        out[k] = v
    return out


def _optimizer_update(params, grads, opt_state, hp: TrainHP, mode: str, global_step: int):
    """Per-group Adam update with the reference's decay semantics."""
    lr_tree = optim.make_lr_tree(params, hp.lr_grid, hp.lr_net, hp.lr_vel)
    if mode == "vel":
        # velocity-only: zero the lr of everything except the velocity net
        lr_tree = {k: kplane.map_params(lambda _: 0.0, v) if k != "vel" else v
                   for k, v in lr_tree.items()}
    lr_scale, vel_scale = decay_scales(hp.lr_factor, hp.lr_upsample_reset,
                                       float(opt_state["step"]), float(global_step))
    if "vel" in lr_tree:
        lr_tree["vel"] = kplane.map_params(lambda lr: lr * vel_scale / lr_scale, lr_tree["vel"])
    return optim.apply_updates(params, grads, opt_state, lr_tree, lr_scale)


def make_train_step(meta: kplane.KPlaneMeta, hp: TrainHP, mode: str, H: int, W: int,
                    focal: float, vel_pts: int | None = None, use_alpha: bool = False,
                    device="cuda"):
    """Build the per-iteration step for one stage.

    The returned function has the signature
      (params, opt_state, counters, draws, frame_idx, key_frame_idx,
       global_step, poses (F,4,4), images (F,H,W,3), times (F,), l1_base,
       l1_step0, alpha_state) -> (params, opt_state, counters, metrics)
    ``params`` and ``opt_state`` are updated in place and returned; the
    metrics are 0-dim tensors on the device (reading one waits for the card).
    """
    loss_fn = make_loss_fn(meta, hp, mode, H, W, focal, vel_pts, use_alpha, device)

    def train_step(params, opt_state, counters, draws, frame_idx, key_frame_idx, global_step,
                   poses, images, times, l1_base, l1_step0, alpha_state):
        leaves = [p for p in optim.tree_leaves(params) if p is not None]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        _, metrics = loss_fn(params, draws, frame_idx, key_frame_idx, global_step, poses, images,
                             times, l1_base, l1_step0, alpha_state)
        grads = kplane.map_params(lambda p: p.grad, params)
        counters = update_counters(counters, metrics)
        params, opt_state = _optimizer_update(params, grads, opt_state, hp, mode, global_step)
        for p in leaves:
            p.grad = None
        return params, opt_state, counters, metrics

    return train_step


class Trainer:
    """The stage loop around ``make_train_step`` and its host-side schedule.

    ``draws``, if given, is called as ``draws(step, meta, hp)`` for each
    iteration's :class:`TrainDraws` (the tests hand in JAX's); by default
    they come from :func:`draw_train_inputs` on ``self.generator``.  Every
    stage event is printed and appended to ``self.events`` (its iteration,
    kind, the grid, keyframes, aabb and mask resolution after it, the mask's
    occupancy, turbo's budgets and the seconds of its parts).
    """

    def __init__(self, cfg, dataset, mode: str = "static_dynamic", logdir: str | None = None,
                 mesh=None, seed: int | None = None, spmd: str = "auto", device="cuda",
                 draws=None):
        if mesh is not None or spmd != "auto":
            raise NotImplementedError("nvfi_torch.Trainer: meshes and the shard_map step "
                                      "(ROADMAP.md A10: parallel) are not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hp = TrainHP.from_cfg(cfg)
        self.mode = mode
        self.all_imgs, self.all_poses, self.all_times, self.counts, _, _, hwf = dataset[:7]
        self.H, self.W, self.focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        self.logdir = logdir
        if logdir:
            os.makedirs(logdir, exist_ok=True)
        self._draws = draws
        self.events = []

        aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                         np.asarray(cfg.nvfi.bbox_z)], axis=-1)
        res0 = n_to_reso(self.hp.n_voxel_init, aabb)
        near_far = (float(cfg.dataset.near), float(cfg.dataset.far))
        self.meta = kplane.meta_from_cfg(cfg.nvfi, aabb, res0, near_far)
        if self.hp.ndc:
            # NDC training rays: make_loss_fn refuses them (ROADMAP.md A3)
            assert self.meta.ray_sampling == "box", (
                "renderer.ndc and nvfi.contract_ray are mutually exclusive")
            self.meta = replace(self.meta, ray_sampling="ndc")
        # turbo (nvfi.turbo): the dense path until the first alpha-mask event,
        # then occupancy pruning and the block-sparse sample axis with budgets
        # from the host-side probe (_reprobe_turbo), certified by the
        # dropped_blocks running max (_check_counters)
        self.turbo = bool(cfg.nvfi.get("turbo", False))
        self.turbo_budget = float(cfg.nvfi.get("turbo_budget", 0.0))  # 0: probe
        self._shade_cap = float(self.meta.shade_fraction)
        self._shade_follow_probe = bool(cfg.nvfi.get("shade_follow_probe", False))
        if self.turbo:
            self.meta = replace(self.meta, train_occupancy_prune=False, block_budget=1.0)
        seed = int(cfg.experiment.randomseed) if seed is None else seed
        self.rng = np.random.RandomState(seed)  # the frame choices, as the JAX package's
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = kplane.init_params(torch.Generator().manual_seed(seed), self.meta,
                                         device=self.device)
        self.alpha_state = None
        self.opt_state = None
        self.counters = init_counters(self.device)
        self.global_step = 0
        # the L1 weight (base, step0), switched at the first alpha-mask event
        self.l1_base = self.hp.L1_weight_initial
        self.l1_step0 = 0

        # voxel and keyframe upsample schedules
        n_up = len(self.hp.upsamp_list)
        self.n_voxel_list = exp_schedule(self.hp.n_voxel_init, self.hp.n_voxel_final, n_up)
        self.keyframe_list = exp_schedule(self.meta.num_keyframes, self.hp.num_keyframes_end,
                                          n_up)

        self.reso_mask = tuple(self.meta.grid_size)
        self.split = "init" if mode == "static" else "train"
        self._upload_buffers(self.split)
        self._step_cache = {}
        self._check_train_times()

    # -- helpers --------------------------------------------------------------

    def _timed(self, fn, *args, **kwargs):
        """(fn's result, its seconds), the device synchronized on both sides."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else lambda _: None
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(self.device)
        return out, time.perf_counter() - t0

    def _upload_buffers(self, split):
        dev = self.device
        self.poses_buf = torch.as_tensor(
            np.stack([np.asarray(p, dtype=np.float32) for p in self.all_poses[split]])).to(dev)
        self.images_buf = torch.as_tensor(
            np.asarray(self.all_imgs[split], dtype=np.float32)).to(dev)
        self.times_buf = torch.as_tensor(
            np.asarray(self.all_times[split], dtype=np.float32)).to(dev)

    def _reprobe_turbo(self, tag: str) -> float | None:
        """Probe the block and shade budgets for the current meta and mask
        (at alpha events, upsamples and restore; a resumed run must not keep
        a checkpoint's budgets).  Returns the probe's seconds, None where
        turbo is off or not engaged yet."""
        if not (self.turbo and self.meta.train_occupancy_prune and self.alpha_state is not None):
            return None
        t0 = time.perf_counter()
        poses = np.stack([np.asarray(p, dtype=np.float32) for p in self.all_poses[self.split]])
        budget, shade = turbo_mod.measure_block_budget(
            self.meta, self.alpha_state, poses, self.H, self.W, self.focal, self.hp.n_rays,
            with_shade=True)
        sec = time.perf_counter() - t0
        if self.turbo_budget:
            budget = self.turbo_budget
        # the probed shade bound covers every above-threshold sample; by
        # default it is capped at the config's shade_fraction, whose
        # truncation the dropped_shade running max counts
        shade = turbo_mod.shade_cap_policy(shade, self._shade_cap, self._shade_follow_probe)
        self.meta = replace(self.meta, block_budget=float(budget), shade_fraction=shade)
        self._step_cache = {}
        print(f"[turbo] {tag}: block_budget={self.meta.block_budget:.3f} "
              f"shade_fraction={self.meta.shade_fraction:.3f}", flush=True)
        return sec

    def _check_counters(self, tag: str, reset: bool = False) -> dict:
        """Read the running-max exactness counters back and report them.

        ``dropped_blocks`` > 0 means the block budget dropped active samples
        in some step since the last reset (the run left the dense math);
        ``dropped_shade`` is the truncation the shade cap accepted.  Returns
        {'max_dropped_blocks', 'max_dropped_shade'}; ``reset`` (at stage
        events) restarts the running max."""
        db = float(self.counters["dropped_blocks"])
        ds = float(self.counters["dropped_shade"])
        if db > 0:
            print(f"[turbo] !!! EXACTNESS VIOLATION at {tag}: the block budget "
                  f"({self.meta.block_budget:.3f}) dropped up to {db:.0f} active sample-blocks "
                  "in a step since the last stage boundary; raise nvfi.turbo_budget or "
                  "re-probe", flush=True)
        if reset:
            if ds > 0:
                print(f"[turbo] stage truncation at {tag}: max dropped_shade={ds:.0f} "
                      f"samples/step (accepted by shade cap {self.meta.shade_fraction:.3f})",
                      flush=True)
            self.counters = init_counters(self.device)
        return {"max_dropped_blocks": db, "max_dropped_shade": ds}

    def _check_train_times(self):
        """Training advects with one RK2 step, which needs every train time
        within dt_max of its keyframe; checked again at every upsample (the
        keyframe count, and so dt_max, changes)."""
        t = np.asarray(self.all_times[self.split], dtype=np.float32)
        if not len(t):
            return
        delta = self.meta.time_scale_factor
        base = np.round(np.clip(t / delta, 0, self.meta.num_keyframes - 1)) * delta
        off = float(np.max(np.abs(t - base)))
        assert off <= self.meta.dt_max + 1e-5, (
            f"max train-time offset {off:.4f} exceeds dt_max {self.meta.dt_max:.4f} (a "
            "training frame lies past tmax); the one-step training advection would truncate "
            "its motion")

    def _get_step_fn(self, vel_pts):
        """The step of the current stage, built once per (meta, vel_pts,
        use_alpha) until a stage event clears the cache."""
        use_alpha = bool(self.meta.train_occupancy_prune and self.alpha_state is not None)
        key = (self.meta, vel_pts, use_alpha)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.meta, self.hp, self.mode, self.H, self.W, self.focal, vel_pts,
                use_alpha=use_alpha, device=self.device)
        return self._step_cache[key]

    def _keyframe_frames(self):
        """Train-frame indices whose time hits a keyframe exactly."""
        t = np.asarray(self.all_times[self.split], dtype=np.float32)
        delta = self.meta.time_scale_factor
        base = np.round(np.clip(t / delta, 0, self.meta.num_keyframes - 1)) * delta
        valid = np.where(np.isclose(t, base))[0]
        return valid if len(valid) else np.arange(len(t))

    def _frame_pools(self, key_frames):
        """The frame pools of a multi-frame step: every train frame, and the
        frames at a keyframe time (rebuilt when the keyframes change)."""
        return (torch.arange(self.counts[self.split], device=self.device),
                torch.as_tensor(key_frames, dtype=torch.int64, device=self.device))

    def _next_draws(self, it: int, vel_pts, pools):
        if self._draws is not None:
            return self._draws(it, self.meta, self.hp)
        return draw_train_inputs(self.generator, self.meta, self.hp, self.H, self.W, vel_pts,
                                 *pools)

    def _log_event(self, it: int, kind: str, seconds: dict):
        occ = (None if self.alpha_state is None
               else float(self.alpha_state["volume"].mean()))
        event = {"it": it, "kind": kind, "grid": tuple(self.meta.grid_size),
                 "keyframes": self.meta.num_keyframes,
                 "aabb": [list(r) for r in self.meta.aabb], "reso_mask": tuple(self.reso_mask),
                 "occupancy": occ, "block_budget": self.meta.block_budget,
                 "shade_fraction": self.meta.shade_fraction, "seconds": seconds}
        self.events.append(event)
        secs = " ".join(f"{k}={v:.3f}s" for k, v in seconds.items())
        print(f"[stage] it={it} {kind}: grid {event['grid']}, keyframes {event['keyframes']}, "
              f"aabb {event['aabb']}, reso_mask {event['reso_mask']}, occupancy "
              f"{'-' if occ is None else f'{occ:.4f}'}, block_budget {self.meta.block_budget:.4f},"
              f" shade_fraction {self.meta.shade_fraction:.4f}; {secs}", flush=True)

    # -- the stage loop -------------------------------------------------------

    def train(self, iters: int | None = None, log_fn=None, vel_pts: int | None = None,
              val_fn=None, progress: bool = False, progress_refresh: int = 10):
        """Run the staged schedule up to ``iters`` iterations (the config's
        ``train_iters`` by default), from ``self.global_step``.

        ``log_fn(metrics)`` every ``print_every`` iterations and at the last;
        ``val_fn(trainer, it)`` every ``validate_every``; ``progress``: a tqdm
        bar with the PSNRs and the loss."""
        hp = self.hp
        iters = hp.train_iters if iters is None else iters
        step_fn = self._get_step_fn(vel_pts)
        opt_state = self.opt_state
        if opt_state is None:
            opt_state = optim.init_state(self.params)
        key_frames = self._keyframe_frames()
        pools = self._frame_pools(key_frames)
        n_frames = self.counts[self.split]
        metrics = {}
        t_start = time.time()
        # liveness heartbeat: every few steps a device round trip, then a
        # fresh mtime on <logdir>/heartbeat proves steps are completing
        hb_path = os.path.join(self.logdir, "heartbeat") if self.logdir else None
        hb_every = 10
        pbar = None
        if progress:
            import tqdm

            pbar = tqdm.tqdm(total=iters, initial=self.global_step, miniters=progress_refresh,
                             file=sys.stdout)
        for it in range(self.global_step, iters):
            frame_idx = self.rng.randint(n_frames)
            key_idx = int(key_frames[self.rng.randint(len(key_frames))])
            draws = self._next_draws(it, vel_pts, pools)
            self.params, opt_state, self.counters, metrics = step_fn(
                self.params, opt_state, self.counters, draws, frame_idx, key_idx, it,
                self.poses_buf, self.images_buf, self.times_buf, self.l1_base, self.l1_step0,
                self.alpha_state)
            # advance before the stage events and saves: a checkpoint written
            # below holds the state after iteration `it` (its events
            # included), so a resumed run continues at it + 1
            self.global_step = it + 1

            if hb_path is not None and it % hb_every == 0:
                float(metrics["loss"])
                touch(hb_path)

            if pbar is not None:
                pbar.update(1)
                if it % progress_refresh == 0:
                    pbar.set_description(
                        f"Iter {it:05d}: psnr = "
                        f"{mse2psnr(float(metrics.get('rgb_loss_0', 0.0)) or 1.0):.2f}|"
                        f"{mse2psnr(float(metrics.get('rgb_loss_t', 0.0)) or 1.0):.2f}"
                        f" loss = {float(metrics['loss']):.6f}")
            if log_fn and (it % hp.print_every == 0 or it == iters - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m["psnr_t"] = mse2psnr(m.get("rgb_loss_t", 0.0) or 1.0)
                m["psnr_0"] = mse2psnr(m.get("rgb_loss_0", 0.0) or 1.0)
                m["it"] = it
                m["elapsed"] = time.time() - t_start
                m.update(self._check_counters(f"it={it}"))
                log_fn(m)

            if val_fn and hp.validate_every > 0 and it % hp.validate_every == 0 and it:
                val_fn(self, it)

            # -- stage events ------------------------------------------------
            if it in hp.update_alphamask_list and self.mode in ("static", "static_dynamic"):
                self._check_counters(f"alpha-stage@{it}", reset=True)
                # the mask takes the current grid's resolution only while its
                # volume is under 256^3; past it the last one is kept
                if int(np.prod(self.meta.grid_size)) < 256 ** 3:
                    self.reso_mask = tuple(self.meta.grid_size)
                (self.alpha_state, new_aabb), mask_s = self._timed(
                    kplane.update_alpha_mask, self.params, self.meta, self.reso_mask,
                    device=self.device)
                (self.params, self.meta), shrink_s = self._timed(
                    kplane.shrink, self.params, self.meta, new_aabb)
                seconds = {"mask": mask_s, "shrink": shrink_s}
                if it == hp.update_alphamask_list[0]:
                    # the L1 weight switches to its reset value and decays on
                    self.l1_base = hp.L1_weight_reset
                    self.l1_step0 = it + 1
                if self.turbo:
                    self.meta = replace(self.meta, train_occupancy_prune=True)
                    occ = float(self.alpha_state["volume"].mean())
                    print(f"[turbo] stage@{it}: occupancy={occ:.3f}", flush=True)
                    probe_s = self._reprobe_turbo(f"stage@{it}")
                    if probe_s is not None:
                        seconds["probe"] = probe_s
                self._step_cache = {}
                step_fn = self._get_step_fn(vel_pts)
                opt_state = optim.init_state(self.params)
                self._log_event(it, "alpha", seconds)

            if it in hp.upsamp_list and self.mode in ("static", "static_dynamic"):
                self._check_counters(f"upsample@{it}", reset=True)
                n_vox = self.n_voxel_list.pop(0)
                res_cur = n_to_reso(n_vox, self.meta.aabb_np)
                kf_cur = self.keyframe_list.pop(0)
                (self.params, self.meta), up_s = self._timed(
                    kplane.upsample, self.params, self.meta, res_cur, kf_cur)
                seconds = {"upsample": up_s}
                key_frames = self._keyframe_frames()
                pools = self._frame_pools(key_frames)
                self._check_train_times()
                # the sample axis and block count changed: the budgets of the
                # last event are stale
                probe_s = self._reprobe_turbo(f"upsample@{it}")
                if probe_s is not None:
                    seconds["probe"] = probe_s
                self._step_cache = {}
                step_fn = self._get_step_fn(vel_pts)
                # Adam restarts at each stage, as does the lr decay by default
                opt_state = optim.init_state(self.params)
                self._log_event(it, "upsample", seconds)

            if self.logdir and ((it != 0 and it % hp.save_every == 0) or it == iters - 1):
                self.save(os.path.join(self.logdir, f"model_{it:05d}"), opt_state)

        if pbar is not None:
            pbar.close()
        self.opt_state = opt_state
        return metrics

    # -- checkpoints ------------------------------------------------------------

    def save(self, path: str, opt_state=None):
        """``path.npz`` + ``path.json`` with the JAX package's ``extra`` keys,
        so a checkpoint resumes in either package."""
        checkpoint.save(
            path, self.params, self.meta, opt_state, self.alpha_state,
            extra={
                "global_step": self.global_step,
                "n_voxel_list": self.n_voxel_list,
                "keyframe_list": self.keyframe_list,
                "mode": self.mode,
                "l1_base": self.l1_base,
                "l1_step0": self.l1_step0,
                "reso_mask": list(self.reso_mask),
            })

    def restore(self, path: str):
        """Load a checkpoint of either package and continue from it: the
        schedules still to run, the L1 state and the mask resolution come
        from its ``extra``; turbo's budgets are probed anew.  Returns the
        checkpoint's optimizer state (None if it has none)."""
        params, meta, opt_state, alpha_state, extra = checkpoint.load(path, device=self.device)
        self.params = params
        self.meta = meta
        self.alpha_state = alpha_state
        if opt_state is not None:
            self.opt_state = opt_state
        self.global_step = int(extra.get("global_step", 0))
        self.n_voxel_list = list(extra.get("n_voxel_list", []))
        self.keyframe_list = list(extra.get("keyframe_list", []))
        self.l1_base = float(extra.get("l1_base", self.hp.L1_weight_initial))
        self.l1_step0 = int(extra.get("l1_step0", 0))
        self.reso_mask = tuple(int(v) for v in extra.get("reso_mask", self.meta.grid_size))
        self._step_cache = {}
        probe_s = self._reprobe_turbo(f"restore@{self.global_step}")
        if probe_s is not None:
            self._log_event(self.global_step - 1, "restore", {"probe": probe_s})
        return opt_state

"""The train step (port of ``nvfi_tpu/train/trainer.py``).

Ported: the hyper-parameters (``TrainHP``), the schedules, the pinhole rays
of a training batch, the per-iteration loss (``make_loss_fn``: the
random-time and keyframe render batches in ray chunks,
the L1 / TV / PDE regularizers with their decayed weights, the velocity
probe) and ``make_train_step`` = the loss's gradient + the per-group Adam
update, for the modes ``static``, ``static_dynamic``, ``dynamic`` and
``vel``.  The stage loop around it (``Trainer``: upsampling, the alpha-mask
events, shrinking) is ROADMAP.md A5.

Two things differ from the JAX original by construction:

* **Random draws are inputs.**  What JAX draws from its key inside the loss
  (pixel ids, per-chunk jitter and background coin, the PDE points, times
  and selection noise, the probe points) comes in as a :class:`TrainDraws`;
  :func:`draw_train_inputs` makes one on the device from a
  ``torch.Generator``.
* **The gradient is taken chunk by chunk.**  ``jax.checkpoint`` + ``scan``
  bound the activation memory of a step to one ray chunk; here each chunk's
  share of the loss is back-propagated as soon as it is computed, which
  accumulates into the leaves' ``.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import kplane
from ..fields import velocity as vel_mod
from ..physics.pde import vel_pde_loss
from . import optim

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
    """Hyper-parameters of the reference ``cfg.experiment`` block that the
    train step reads (the JAX package's names and defaults; the stage loop's
    fields come with it, ROADMAP.md A5)."""

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
    update_alphamask_list: tuple = ()
    white_bg: bool = True
    multi_frame: bool = False
    ndc: bool = False

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
            update_alphamask_list=tuple(cfg.nvfi.update_AlphaMask_list),
            white_bg=bool(cfg.dataset.white_background),
            multi_frame=bool(e.get("multi_frame_batch", False)),
            ndc=bool(cfg.renderer.get("ndc", False)),
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


def _rays_from_pose(pose: torch.Tensor, H: int, W: int, focal: float, ii, jj):
    """Pinhole rays at pixels (ii, jj), OpenGL convention (as
    ``render.rays.ray_bundle`` makes them on the host)."""
    x = (jj.to(torch.float32) - W * 0.5) / focal
    y = -(ii.to(torch.float32) - H * 0.5) / focal
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    ray_d = dirs @ pose[:3, :3].T
    ray_o = pose[:3, 3].expand(ray_d.shape)
    return ray_o, ray_d


@dataclass
class TrainDraws:
    """The random numbers of one training iteration (what the JAX package
    draws from its key inside the loss).  The ``*_t`` fields belong to the
    random-time batch, the ``*_0`` fields to the keyframe batch; a field a
    mode does not use may be None."""

    pix_t: torch.Tensor | None  # (n_rays,) distinct flat pixel ids
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


def draw_train_inputs(generator: torch.Generator, meta: kplane.KPlaneMeta, hp: TrainHP,
                      H: int, W: int, vel_pts: int | None = None) -> TrainDraws:
    """One iteration's draws from ``generator``, on the generator's device."""
    dev = generator.device
    ray_chunk, n_chunks = ray_chunking(meta, hp)
    n_pde = vel_pts if vel_pts is not None else hp.vel_reg_n_pts

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    def pixels():
        return torch.randperm(H * W, generator=generator, device=dev)[: hp.n_rays]

    def coins():
        return None if hp.white_bg else (uniform(n_chunks) < 0.5).tolist()

    return TrainDraws(
        pix_t=pixels(), pix_0=pixels(),
        jitter_t=uniform(n_chunks, ray_chunk, 1), jitter_0=uniform(n_chunks, ray_chunk, 1),
        coin_t=coins(), coin_0=coins(),
        pde_points=uniform(n_pde, 3), pde_times=uniform(n_pde, 1), pde_noise=uniform(n_pde),
        probe_x=uniform(PROBE_POINTS, 3) * 2.0 - 1.0, probe_t=uniform(PROBE_POINTS, 1),
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
    ``l1_base`` and ``l1_step0`` host floats.  Every share of the loss that
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
    if hp.multi_frame:
        raise NotImplementedError("nvfi_torch.trainer: multi_frame batches (ROADMAP.md A4) are "
                                  "not ported yet")
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

    def render_batch(params, pix, jitter, coins, pose, image, t, alpha_state, advect):
        ii, jj = pix // W, pix % W
        ray_o, ray_d = _rays_from_pose(pose, H, W, focal, ii, jj)
        target = image[ii, jj]
        mse, dropped, dshade = 0.0, 0.0, 0.0
        for c in range(n_chunks):
            rows = slice(c * ray_chunk, (c + 1) * ray_chunk)
            out = kplane.render_rays(
                params, meta, t, ray_o[rows], ray_d[rows], white_bg=hp.white_bg, training=True,
                advect=advect, alpha_state=alpha_state if use_alpha else None,
                jitter=jitter[c], bg_coin=None if hp.white_bg else coins[c], device=device)
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

        if dynamic:
            rgb_loss_t, d, ds = render_batch(params, draws.pix_t, draws.jitter_t, draws.coin_t,
                                             poses[frame_idx], images[frame_idx],
                                             times[frame_idx], alpha_state, True)
            loss, dropped, dshade = loss + rgb_loss_t, dropped + d, dshade + ds
        if keyframes:
            # keyframe batch: its times are exact keyframes, so the advection
            # is a statically known no-op and is skipped
            rgb_loss_0, d, ds = render_batch(params, draws.pix_0, draws.jitter_0, draws.coin_0,
                                             poses[key_frame_idx], images[key_frame_idx],
                                             times[key_frame_idx], alpha_state, False)
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

"""Static TensoRF training: the VM / CP field on one frame's pixels with the
coarse-to-fine stage loop (port of ``nvfi_tpu/train/static.py``).

Each iteration renders ``n_rays`` distinct pixels of one train frame in one
batch (``fields.tensorf_vm.render_rays``: K6, the shader, K2; backward K2b
and K6b), adds the decayed L1 and TV regularizers and takes a per-group Adam
step whose learning rate decays from the stage's start.  The stage events
are those of the JAX trainer: an alpha mask with its shrink at the
iterations of ``update_AlphaMask_list`` and an upsample at those of
``upsamp_list``, each followed by a fresh Adam state.

As in the keyframe trainer, what JAX draws from its key inside the loss (the
pixel ids, the per-ray jitter, the background coin) comes in as a
:class:`StaticDraws`; :func:`draw_static_inputs` makes one on the device from
a ``torch.Generator``, and the frames are picked with JAX's numpy generator.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..eval.metrics import mse2psnr
from ..fields import tensorf_vm
from ..fields.kplane import map_params
from . import optim
from .trainer import TrainHP, _rays_from_pose, exp_schedule, n_to_reso


def static_meta_from_cfg(cfg, aabb, grid_size, near_far) -> tensorf_vm.StaticMeta:
    n = cfg.nvfi
    return tensorf_vm.StaticMeta(
        grid_size=tuple(int(g) for g in grid_size),
        aabb=tuple(tuple(float(v) for v in row) for row in np.asarray(aabb)),
        near_far=tuple(float(v) for v in near_far),
        density_n_comp=int(n.density_n_comp[0]),
        app_n_comp=int(n.appearance_n_comp[0]),
        app_dim=int(n.app_dim),
        density_shift=float(n.density_shift),
        distance_scale=float(n.distance_scale),
        alpha_mask_thres=float(n.alphaMask_thres),
        raymarch_weight_thres=float(n.rayMarch_weight_thres),
        decomposition="CP" if "CP" in str(n.model_name) else "VM",
        fea2dense=str(n.fea2denseAct),
        shading_mode=str(n.shadingMode),
        pos_pe=int(n.pos_pe),
        view_pe=int(n.view_pe),
        fea_pe=int(n.fea_pe),
        feature_c=int(n.featureC),
        step_ratio=float(n.step_ratio),
        max_n_samples=int(n.max_n_samples),
    )


@dataclass
class StaticDraws:
    """The random numbers of one static iteration (JAX's ``k_pix`` and
    ``k_render`` draws)."""

    pix: torch.Tensor  # (n_rays,) distinct flat pixel ids
    jitter: torch.Tensor  # (n_rays, 1) in [0, 1)
    coin: bool | None  # composite over white (read only without white_bg)


def draw_static_inputs(generator: torch.Generator, hp: TrainHP, H: int, W: int) -> StaticDraws:
    """One iteration's draws from ``generator``, on its device."""
    dev = generator.device
    pix = torch.randperm(H * W, generator=generator, device=dev)[: hp.n_rays]
    jitter = torch.rand(hp.n_rays, 1, generator=generator, device=dev)
    coin = None if hp.white_bg else bool(torch.rand((), generator=generator, device=dev) < 0.5)
    return StaticDraws(pix=pix, jitter=jitter, coin=coin)


def make_static_loss_fn(meta: tensorf_vm.StaticMeta, hp: TrainHP, H: int, W: int, focal: float,
                        device="cuda"):
    """The loss of one iteration: ``(params, draws, frame_idx, global_step,
    poses (F,4,4), images (F,H,W,3)) -> (loss, metrics)``; ``frame_idx`` and
    ``global_step`` are host ints.  The loss carries its graph; the metrics
    are detached 0-d tensors."""
    lr_factor = hp.lr_factor

    def loss_fn(params, draws: StaticDraws, frame_idx, global_step, poses, images):
        ii, jj = draws.pix // W, draws.pix % W
        ray_o, ray_d = _rays_from_pose(poses[frame_idx], H, W, focal, ii, jj)
        target = images[frame_idx][ii, jj]
        out = tensorf_vm.render_rays(params, meta, ray_o, ray_d, white_bg=hp.white_bg,
                                     training=True, jitter=draws.jitter, bg_coin=draws.coin,
                                     device=device)
        rgb_loss = torch.mean((out["rgb"] - target) ** 2)
        reg_scale = lr_factor ** (float(global_step) + 1.0)
        loss = rgb_loss
        if hp.L1_weight_initial > 0:
            loss = loss + hp.L1_weight_initial * reg_scale * tensorf_vm.density_l1(params, meta)
        if hp.TV_weight_density > 0:
            loss = loss + hp.TV_weight_density * reg_scale * tensorf_vm.tv_loss_density(params,
                                                                                         meta)
        if hp.TV_weight_app > 0:
            loss = loss + hp.TV_weight_app * reg_scale * tensorf_vm.tv_loss_app(params, meta)
        return loss, {"loss": loss.detach(), "rgb_loss_0": rgb_loss.detach()}

    return loss_fn


def make_static_step(meta: tensorf_vm.StaticMeta, hp: TrainHP, H: int, W: int, focal: float,
                     device="cuda"):
    """The step of one stage: ``(params, opt_state, draws, frame_idx,
    global_step, poses, images) -> (params, opt_state, metrics)``.  The
    loss's gradient, then Adam with grids at lr_grid, the rest at lr_net and
    the decay ``lr_factor ** opt_state['step']`` (restarted at each event).
    ``params`` and ``opt_state`` are updated in place and returned."""
    loss_fn = make_static_loss_fn(meta, hp, H, W, focal, device)

    def step(params, opt_state, draws, frame_idx, global_step, poses, images):
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = loss_fn(params, draws, frame_idx, global_step, poses, images)
        loss.backward()
        grads = map_params(lambda p: p.grad, params)
        lr_tree = optim.make_lr_tree(params, hp.lr_grid, hp.lr_net)
        params, opt_state = optim.apply_updates(params, grads, opt_state, lr_tree,
                                                hp.lr_factor ** float(opt_state["step"]))
        for p in leaves:
            p.grad = None
        return params, opt_state, metrics

    return step


class StaticTrainer:
    """TensoRF VM / CP training of the static model with the coarse-to-fine
    schedule (JAX ``StaticTrainer``).

    ``draws``, if given, is called as ``draws(step, meta, hp)`` for each
    iteration's :class:`StaticDraws` (the tests hand in JAX's); by default
    they come from :func:`draw_static_inputs` on ``self.generator``.  Every
    stage event is printed and appended to ``self.events`` (its iteration,
    kind, the grid and aabb after it, the mask's occupancy and the seconds
    of its parts)."""

    def __init__(self, cfg, dataset, seed: int | None = None, device="cuda", draws=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hp = TrainHP.from_cfg(cfg)
        (self.all_imgs, self.all_poses, self.all_times, self.counts, _, _,
         hwf) = dataset[:7]
        self.H, self.W, self.focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        self._draws = draws
        self.events = []

        aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                         np.asarray(cfg.nvfi.bbox_z)], axis=-1)
        res0 = n_to_reso(self.hp.n_voxel_init, aabb)
        near_far = (float(cfg.dataset.near), float(cfg.dataset.far))
        self.meta = static_meta_from_cfg(cfg, aabb, res0, near_far)
        seed = int(cfg.experiment.randomseed) if seed is None else seed
        self.rng = np.random.RandomState(seed)  # the frame choices, as the JAX package's
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = tensorf_vm.init_params(torch.Generator().manual_seed(seed), self.meta,
                                             device=self.device)
        self.global_step = 0
        self.alpha_state = None
        self.opt_state = None
        self.n_voxel_list = exp_schedule(self.hp.n_voxel_init, self.hp.n_voxel_final,
                                         len(self.hp.upsamp_list))

        self.split = "init" if self.counts.get("init") else "train"
        self.poses_buf = torch.as_tensor(np.stack(
            [np.asarray(p, np.float32) for p in self.all_poses[self.split]])).to(self.device)
        self.images_buf = torch.as_tensor(
            np.asarray(self.all_imgs[self.split], np.float32)).to(self.device)

    def _timed(self, fn, *args, **kwargs):
        """(fn's result, its seconds), the device synchronized on both sides."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else lambda _: None
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(self.device)
        return out, time.perf_counter() - t0

    def _log_event(self, it: int, kind: str, seconds: dict):
        occ = None if self.alpha_state is None else float(self.alpha_state["volume"].mean())
        event = {"it": it, "kind": kind, "grid": tuple(self.meta.grid_size),
                 "aabb": [list(r) for r in self.meta.aabb], "occupancy": occ,
                 "seconds": seconds}
        self.events.append(event)
        secs = " ".join(f"{k}={v:.3f}s" for k, v in seconds.items())
        print(f"[stage] it={it} {kind}: grid {event['grid']}, aabb {event['aabb']}, occupancy "
              f"{'-' if occ is None else f'{occ:.4f}'}; {secs}", flush=True)

    def _next_draws(self, it: int) -> StaticDraws:
        if self._draws is not None:
            return self._draws(it, self.meta, self.hp)
        return draw_static_inputs(self.generator, self.hp, self.H, self.W)

    def train(self, iters: int | None = None, log_fn=None):
        """Run the schedule up to ``iters`` iterations (the config's
        ``train_iters`` by default) from ``self.global_step``; ``log_fn(m)``
        every ``print_every`` iterations and at the last, with the loss,
        ``rgb_loss_0``, ``psnr_0``, ``it`` and ``elapsed``.  Returns the last
        step's metrics."""
        hp = self.hp
        iters = hp.train_iters if iters is None else iters
        step_fn = make_static_step(self.meta, hp, self.H, self.W, self.focal, self.device)
        opt_state = optim.init_state(self.params)
        n_frames = self.counts[self.split]
        metrics = {}
        t0 = time.time()
        for it in range(self.global_step, iters):
            frame_idx = self.rng.randint(n_frames)
            self.params, opt_state, metrics = step_fn(
                self.params, opt_state, self._next_draws(it), frame_idx, it, self.poses_buf,
                self.images_buf)
            if log_fn and (it % hp.print_every == 0 or it == iters - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m.update(it=it, psnr_0=mse2psnr(m["rgb_loss_0"] or 1.0),
                         elapsed=time.time() - t0)
                log_fn(m)
            if it in hp.update_alphamask_list:
                # the alpha mask at the grid's resolution (at most 200 a side),
                # then the shrink to its occupied box
                reso_mask = tuple(min(g, 200) for g in self.meta.grid_size)
                (self.alpha_state, new_aabb), mask_s = self._timed(
                    tensorf_vm.update_alpha_mask, self.params, self.meta, reso_mask,
                    device=self.device)
                (self.params, self.meta), shrink_s = self._timed(
                    tensorf_vm.shrink, self.params, self.meta, new_aabb)
                step_fn = make_static_step(self.meta, hp, self.H, self.W, self.focal,
                                           self.device)
                opt_state = optim.init_state(self.params)
                self._log_event(it, "alpha", {"mask": mask_s, "shrink": shrink_s})
            if it in hp.upsamp_list:
                res = n_to_reso(self.n_voxel_list.pop(0), self.meta.aabb_np)
                (self.params, self.meta), up_s = self._timed(
                    tensorf_vm.upsample, self.params, self.meta, res)
                step_fn = make_static_step(self.meta, hp, self.H, self.W, self.focal,
                                           self.device)
                opt_state = optim.init_state(self.params)
                self._log_event(it, "upsample", {"upsample": up_s})
            self.global_step = it + 1
        self.opt_state = opt_state
        return metrics

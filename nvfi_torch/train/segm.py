"""Unsupervised 3D instance segmentation: the MaskField distilled from a
frozen scene's motion field (port of ``nvfi_tpu/train/segm.py``).

Each iteration:

1. stratified-sample the volume (``n_sample_res`` cells a side) and keep the
   points whose t = 0 opacity exceeds ``alphaMask_thres * alpha_scale``
   (the density through kernel K1d);
2. balance foreground and background by the surround box, where the scene
   has one;
3. resample a fixed ``point_budget`` with replacement, so every step has one
   shape;
4. advect the kept points forward from t = 0 to a random t in
   [min_t, tmax] through the frozen velocity field: the displacement is the
   flow that supervises the step;
5. one Adam step of the MaskField on the rigid-fit ``dynamic_loss`` (plus the
   KNN ``smooth_loss`` from ``smooth_iter`` on).

The host side draws from ``np.random.RandomState(seed)`` exactly as the JAX
package does, so both packages sample the same points from the same scene.
A step's inputs (``xyz``, ``flow``, ``lr``) go straight into ``seg_step``,
so a test can compare a step from identical inputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..fields import kplane, mask_field
from ..fields.kplane import map_params
from ..utils.seg_loss import dynamic_loss, entropy_loss, smooth_loss
from . import checkpoint
from .optim import tree_leaves

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # the reference's segmentation Adam
ALPHA_STEP = 0.01  # the step length of the t = 0 opacity test


def sample_volume_points(rng: np.random.RandomState, bounds: np.ndarray, n: int,
                         perturb: bool = True) -> np.ndarray:
    """Stratified 3D grid sampling: bounds (3, 2) -> (n, n, n, 3) float32 points."""
    t_vals = np.linspace(0.0, 1.0, n + 1)[:, None]
    xyz_vals = bounds[:, 0] * (1 - t_vals) + bounds[:, 1] * t_vals
    lower, upper = xyz_vals[:-1], xyz_vals[1:]
    if perturb:
        pts = lower + (upper - lower) * rng.rand(n, 3)
    else:
        pts = 0.5 * (lower + upper)
    x, y, z = np.meshgrid(pts[:, 0], pts[:, 1], pts[:, 2], indexing="ij")
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def balanced_sample(rng: np.random.RandomState, xyz: np.ndarray,
                    object_bounds: np.ndarray) -> np.ndarray:
    """Keep as many background points (outside ``object_bounds`` (3, 2)) as
    foreground ones, drawn without replacement."""
    fg = np.all((xyz > object_bounds[:, 0]) & (xyz < object_bounds[:, 1]), axis=-1)
    xyz_fg, xyz_bg = xyz[fg], xyz[~fg]
    if len(xyz_bg) > len(xyz_fg) and len(xyz_fg) > 0:
        idx = rng.choice(len(xyz_bg), len(xyz_fg), replace=False)
        xyz_bg = xyz_bg[idx]
    return np.concatenate([xyz_fg, xyz_bg], axis=0)


def normalize_coord_np(meta: kplane.KPlaneMeta, xyz: np.ndarray) -> np.ndarray:
    """``kplane.normalize_coord`` on host arrays, in the JAX package's numpy
    arithmetic (float32 in, float32 out)."""
    a = meta.aabb_np
    return (xyz - a[0]) * (2.0 / (a[1] - a[0])) - 1.0


class SegmTrainer:
    """Trains a MaskField against a frozen NVFi scene.

    ``params`` (on ``device``) and ``meta`` are the scene's; ``mask_params``
    defaults to a MaskField drawn from ``torch.Generator().manual_seed(seed)``
    (4 layers, 128 wide, ``segmentation.n_object`` slots); pass JAX's, made
    with ``checkpoint.params_from_numpy``, to start where it starts."""

    def __init__(self, cfg, params, meta: kplane.KPlaneMeta, seed: int = 0,
                 point_budget: int = 8192, mask_params=None, device="cuda",
                 fit_dtype: torch.dtype | None = torch.float64):
        self.device = resolve_device(device)
        self.fit_dtype = fit_dtype  # the rigid fit's (seg_loss.dynamic_loss); None: JAX's
        self.cfg = cfg
        self.scene_params = params
        self.meta = meta
        self.rng = np.random.RandomState(seed)
        self.point_budget = point_budget

        seg = cfg.segmentation
        self.n_object = int(seg.n_object)
        self.n_iters = int(seg.n_iters)
        self.smooth_iter = int(seg.smooth_iter)
        self.lrate = float(seg.lrate)
        self.lrate_decay = float(seg.lrate_decay)
        self.lrate_decay_step = int(seg.lrate_decay_step)
        self.loss_smooth_w = float(seg.loss_smooth_w)
        self.alpha_scale = float(seg.alpha_scale)
        self.n_sample_res = int(seg.n_sample_res)
        self.min_t = float(seg.min_t)

        if mask_params is None:
            mask_params = mask_field.init(torch.Generator().manual_seed(seed), n_layer=4,
                                          n_dim=128, input_dim=3, skips=(),
                                          mask_dim=self.n_object, device=self.device)
        self.mask_params = mask_params
        # the surround box, unnormalized, balances foreground and background
        if meta.vel_gate.mode == "sur":
            b = np.asarray(meta.vel_gate.bounds)
            a = meta.aabb_np
            self.object_bounds = ((b + 1.0) * (a[1] - a[0]) / 2.0 + a[0]).T  # (3, 2)
        else:
            self.object_bounds = None
        self.init_opt()

    # -- the device side ---------------------------------------------------

    @torch.inference_mode()
    def alpha_at_t0(self, xyz_norm: torch.Tensor) -> torch.Tensor:
        """Opacity of a 0.01 step at normalized points (n, 3) at t = 0 (K1d)."""
        t0 = torch.zeros((*xyz_norm.shape[:-1], 1), dtype=torch.float32, device=xyz_norm.device)
        xyzt = torch.cat([xyz_norm, kplane.normalize_time(self.meta, t0)], dim=-1)
        feat = kplane.density_feature(self.scene_params, self.meta, xyzt)
        sigma = kplane.feature2density(self.meta, feat)
        return 1.0 - torch.exp(-sigma * ALPHA_STEP)

    @torch.inference_mode()
    def flow_to(self, xyz_norm: torch.Tensor, t_target: float) -> torch.Tensor:
        """Displacement of normalized points (n, 3) advected forward from t = 0
        to ``t_target`` (RK2, ``meta.max_adv_steps`` steps)."""
        t0 = torch.zeros((xyz_norm.shape[0], 1), dtype=torch.float32, device=xyz_norm.device)
        t = torch.full_like(t0, np.float32(t_target))
        # integrate_pos advects from its t to its base time: here 0 -> t
        xyz2 = kplane.integrate_pos(self.scene_params, self.meta, xyz_norm, t0, t,
                                    n_steps=self.meta.max_adv_steps)
        return xyz2 - xyz_norm

    def init_opt(self):
        """Zero Adam state (the state of a fresh ``train``)."""
        leaves = tree_leaves(self.mask_params)
        self.opt_m = [torch.zeros_like(p) for p in leaves]
        self.opt_v = [torch.zeros_like(p) for p in leaves]
        self.step = 0

    def losses(self, mask_params, xyz: torch.Tensor, flow: torch.Tensor, use_smooth: bool):
        """(loss, metrics) of the MaskField ``mask_params`` on one batch; the
        smooth and entropy terms are metrics too, so they are computed every
        step, and carry a graph only where the loss uses them."""
        mask = mask_field.apply(mask_params, xyz)
        l_dyn, _ = dynamic_loss(xyz[None], mask[None], flow[None], self.fit_dtype)
        with torch.no_grad():
            l_ent = entropy_loss(mask[None])
        if use_smooth:
            l_smooth = smooth_loss(xyz[None], mask[None], k=4, radius=0.01)
            loss = l_dyn + self.loss_smooth_w * l_smooth
        else:
            with torch.no_grad():
                l_smooth = smooth_loss(xyz[None], mask[None], k=4, radius=0.01)
            loss = l_dyn
        return loss, {"dynamic": l_dyn.detach(), "smooth": l_smooth.detach(),
                      "entropy": l_ent, "loss": loss.detach()}

    def grads(self, xyz: torch.Tensor, flow: torch.Tensor, use_smooth: bool):
        """(grads of the loss for the leaves of ``mask_params`` in
        ``tree_leaves`` order, metrics)."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.mask_params)]
        it = iter(leaves)
        loss, metrics = self.losses(map_params(lambda _: next(it), self.mask_params), xyz, flow,
                                    use_smooth)
        return list(torch.autograd.grad(loss, leaves)), metrics

    @torch.no_grad()
    def adam_update(self, grads, lr: float):
        """One Adam(0.9, 0.999) step of ``mask_params`` from ``grads``, in the
        JAX package's bias-corrected form and in float32."""
        self.step += 1
        f32 = {"dtype": torch.float32, "device": self.device}
        t = torch.tensor(float(self.step), **f32)
        bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, **f32), t)
        bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, **f32), t)
        lr = torch.tensor(lr, **f32)
        new = []
        for i, (p, g) in enumerate(zip(tree_leaves(self.mask_params), grads)):
            m = ADAM_B1 * self.opt_m[i] + (1 - ADAM_B1) * g
            v = ADAM_B2 * self.opt_v[i] + (1 - ADAM_B2) * g * g
            new.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
            self.opt_m[i], self.opt_v[i] = m, v
        it = iter(new)
        self.mask_params = map_params(lambda _: next(it), self.mask_params)

    def seg_step(self, xyz: torch.Tensor, flow: torch.Tensor, lr: float, use_smooth: bool):
        """One step of the MaskField on normalized points ``xyz`` (n, 3) and
        their ``flow`` (n, 3).  Returns the metrics as 0-d tensors (no
        read-back)."""
        grads, metrics = self.grads(xyz, flow, use_smooth)
        self.adam_update(grads, lr)
        return metrics

    # -- the host side -----------------------------------------------------

    def sample_points(self) -> np.ndarray:
        """Stratified grid -> occupancy filter -> balance -> fixed budget:
        (point_budget, 3) float32 normalized points."""
        meta = self.meta
        bounds = meta.aabb_np.T  # (3, 2)
        xyz = sample_volume_points(self.rng, bounds, self.n_sample_res).reshape(-1, 3)
        xyz_norm = normalize_coord_np(meta, xyz)
        alpha = self.alpha_at_t0(torch.as_tensor(xyz_norm, device=self.device)).cpu().numpy()
        keep = alpha > (meta.alpha_mask_thres * self.alpha_scale)
        xyz = xyz[keep]
        if len(xyz) == 0:
            xyz = sample_volume_points(self.rng, bounds, 8).reshape(-1, 3)
        if self.object_bounds is not None:
            xyz = balanced_sample(self.rng, xyz, self.object_bounds)
        idx = self.rng.choice(len(xyz), self.point_budget, replace=True)
        return normalize_coord_np(meta, xyz[idx]).astype(np.float32)

    def learning_rate(self, it: int) -> float:
        return self.lrate * (self.lrate_decay ** (it / self.lrate_decay_step))

    def train(self, logdir: str | None = None, log_fn=None, iters: int | None = None):
        """Run ``iters`` (default ``segmentation.n_iters``) iterations from a
        fresh Adam state; ``log_fn`` gets the metrics at iteration 1 and every
        50th, a checkpoint goes to ``logdir`` every ``save_freq``.  Returns
        the last metrics (0-d tensors)."""
        self.init_opt()
        iters = iters if iters is not None else self.n_iters
        metrics = {}
        for it in range(1, iters + 1):
            xyz = torch.as_tensor(self.sample_points(), device=self.device)
            t = self.min_t + (self.meta.tmax - self.min_t) * self.rng.rand()
            flow = self.flow_to(xyz, t)
            metrics = self.seg_step(xyz, flow, self.learning_rate(it),
                                    use_smooth=it >= self.smooth_iter)
            if log_fn and (it % 50 == 0 or it == 1):
                log_fn({"it": it, **{k: float(v) for k, v in metrics.items()}})
            if logdir and it % int(self.cfg.segmentation.save_freq) == 0:
                self.save(os.path.join(logdir, f"mask_{it:06d}"))
        return metrics

    def save(self, path: str):
        checkpoint.save(path, self.mask_params, self.meta, extra={"n_object": self.n_object})

    def restore(self, path: str):
        params, _, _, _, extra = checkpoint.load(path, device=self.device)
        self.mask_params = params
        return extra

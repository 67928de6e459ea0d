"""Evaluation harness: render a split and compute image metrics.

Port of ``nvfi_tpu/eval/harness.py:21-24, 60-135``: rebuild the alpha mask,
render every pose of the split at its time with the mask pruning the samples,
save PNGs, and report MSE / PSNR / SSIM.  The test split extends past the
training tmax, so this measures future-frame extrapolation.
``save_gif_time_sweep`` waits for the trainer slice (ROADMAP.md A5).
"""

from __future__ import annotations

import os

import numpy as np

from ..device import resolve_device
from ..fields import kplane
from ..render import rays as rays_mod
from ..render.renderer import render_image
from ..utils.viz import visualize_depth
from . import metrics as metrics_mod


def save_png(path: str, img: np.ndarray):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def render_split(
    params,
    meta: kplane.KPlaneMeta,
    dataset,
    split: str = "test",
    *,
    white_bg: bool,
    alpha_state=None,
    update_alpha: bool = True,
    transfer_vel: bool = False,
    savedir: str | None = None,
    chunk: int = 4096,
    mask_params=None,
    alpha_grid: int = 200,
    max_views: int = 0,
    sparse_budget: float | None = None,
    device="cuda",
):
    """Render all views of a split; returns (preds (N,H,W,3), metrics dict).

    ``dataset`` is the loaders' tuple (images, poses and times per split,
    counts, two unused entries, (H, W, focal), ...).  The meta's training-time
    turbo budgets are reset (``kplane.eval_exact_meta``): the renders are
    dense-exact.  Unless ``alpha_state`` is given or ``update_alpha`` is off,
    the mask is built first at ``min(g, alpha_grid)`` per axis.
    """
    if sparse_budget:
        raise NotImplementedError("nvfi_torch.render_split: sparse_budget (ROADMAP.md A6: "
                                  "block-sparse sampling) is not ported yet")
    dev = resolve_device(device)
    all_imgs, all_poses, all_times, counts, _, _, (H, W, focal) = dataset[:7]
    meta = kplane.eval_exact_meta(meta)
    if update_alpha and alpha_state is None:
        alpha_state, _ = kplane.update_alpha_mask(
            params, meta, tuple(min(g, alpha_grid) for g in meta.grid_size),
            transfer=transfer_vel, device=dev,
        )
    if savedir:
        os.makedirs(savedir, exist_ok=True)

    n_views = counts[split] if not max_views else min(counts[split], max_views)
    preds = []
    for idx in range(n_views):
        cam = rays_mod.Camera(
            all_poses[split][idx], H, W, focal,
            near=meta.near_far[0], far=meta.near_far[1],
        )
        out = render_image(
            params, meta, float(all_times[split][idx]),
            cam.rays_o.reshape(H, W, 3), cam.rays_d.reshape(H, W, 3),
            white_bg=white_bg, transfer_vel=transfer_vel, alpha_state=alpha_state,
            chunk=chunk, mask_params=mask_params, device=dev,
        )
        if out.get("dropped", 0.0) > 0:
            raise RuntimeError(f"inexact eval render (view {idx}): {int(out['dropped'])} "
                               "active blocks/shade samples dropped")
        preds.append(out["rgb"])
        if savedir:
            save_png(os.path.join(savedir, f"r_{idx:03d}.png"), out["rgb"])
            # depth panel, near/far-normalized jet colormap
            save_png(os.path.join(savedir, f"r_{idx:03d}_depth.png"),
                     visualize_depth(out["depth"], minmax=meta.near_far)[0])
    preds = np.stack(preds)
    gts = np.asarray(all_imgs[split][:n_views], dtype=np.float32)
    errors = metrics_mod.estim_error(preds, gts)
    if savedir:
        metrics_mod.save_error(errors, savedir)
    return preds, errors

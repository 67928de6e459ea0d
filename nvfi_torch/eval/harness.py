"""Evaluation harness: render a split and compute image metrics.

Port of ``nvfi_tpu/eval/harness.py``: rebuild the alpha mask, render every
pose of the split at its time with the mask pruning the samples, save PNGs,
and report MSE / PSNR / SSIM.  The test split extends past the training
tmax, so this measures future-frame extrapolation.  ``save_gif_time_sweep``
renders one pose over t in [0, 1] into a GIF.  PNGs and GIFs go through the
port's own writers (``utils/png.py``, ``utils/gif.py``).
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np

from ..device import resolve_device
from ..fields import kplane
from ..render import rays as rays_mod
from ..render.renderer import render_image
from ..utils.gif import write_gif
from ..utils.png import write_png
from ..utils.viz import visualize_depth
from . import metrics as metrics_mod


def save_png(path: str, img: np.ndarray):
    """An (H, W, 3) or (H, W, 4) image in [0, 1] as an 8-bit PNG."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_gif_time_sweep(
    params, meta: kplane.KPlaneMeta, dataset, path: str, *, white_bg: bool,
    n_frames: int = 16, view: int = 0, max_res: int = 128, chunk: int = 4096,
    transfer_vel: bool = False, alpha_state=None, device="cuda",
):
    """Render a fixed val (else test) pose swept over t in [0, 1], at most
    ``max_res`` pixels a side, and save the frames as a GIF.  Returns the
    (T, H, W, 3) frame stack."""
    dev = resolve_device(device)
    meta = kplane.eval_exact_meta(meta)
    _, all_poses, _, counts, _, _, (H, W, focal) = dataset[:7]
    split = "val" if counts.get("val") else "test"
    stride = max(1, int(np.ceil(max(H, W) / max_res)))
    Hs, Ws, fs = H // stride, W // stride, focal / stride
    cam = rays_mod.Camera(all_poses[split][view], Hs, Ws, fs,
                          near=meta.near_far[0], far=meta.near_far[1])
    frames = []
    for t in np.linspace(0.0, 1.0, n_frames):
        out = render_image(
            params, meta, float(t),
            cam.rays_o.reshape(Hs, Ws, 3), cam.rays_d.reshape(Hs, Ws, 3),
            white_bg=white_bg, chunk=chunk, transfer_vel=transfer_vel,
            alpha_state=alpha_state, device=dev,
        )
        frames.append(out["rgb"])
    frames = np.stack(frames)
    write_gif(path, (np.clip(frames, 0, 1) * 255).astype(np.uint8))
    return frames


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
    the mask is built first at ``min(g, alpha_grid)`` per axis.  With
    ``sparse_budget`` the frames render on the block-sparse sample axis at
    that ``block_budget`` (after the mask build); a frame that drops an
    active block raises ``RuntimeError``, so a split's numbers are always
    the dense render's.
    """
    dev = resolve_device(device)
    all_imgs, all_poses, all_times, counts, _, _, (H, W, focal) = dataset[:7]
    meta = kplane.eval_exact_meta(meta)
    if update_alpha and alpha_state is None:
        alpha_state, _ = kplane.update_alpha_mask(
            params, meta, tuple(min(g, alpha_grid) for g in meta.grid_size),
            transfer=transfer_vel, device=dev,
        )
    if sparse_budget:
        meta = replace(meta, block_budget=float(sparse_budget))
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
            raise RuntimeError(
                f"inexact eval render (view {idx}): {int(out['dropped'])} "
                f"active blocks/shade samples dropped at block_budget="
                f"{meta.block_budget}, shade_fraction={meta.shade_fraction}; "
                "raise the budget or pass sparse_budget=0 for the dense path")
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

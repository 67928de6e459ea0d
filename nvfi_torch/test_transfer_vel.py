"""Dynamic motion transfer with the port: scene B's velocity field grafted
into scene A (port of ``test_transfer_vel.py``).

  python -m nvfi_torch.test_transfer_vel [--config A.yaml] [--config2 B.yaml]
      [--checkpoint N] [--checkpoint2 N] [--full_res] [--synthetic]
      [--alpha_grid N] [--n_views N] [--scene_dir D] [--scene_dir2 D]
      [--device cuda|cpu]

The graft is one dict assignment, ``params_a["vel"] = params_b["vel"]``.  The
alpha mask is built once in transfer mode (every grid point advected from t
back to the canonical t = 0 frame) and the test split rendered with
``transfer_vel=True``.  At t = 0 the transfer render advects by a zero
offset, so the grafted scene must reproduce the host's own t = 0 geometry
whatever the donor: the PSNR by view, with that view marked, tells "the
donor's motion applied" from "a broken render".  Last, the time-sweep GIF
of the grafted scene.  The flags are the JAX driver's; each config defaults
to its scene directory's ``config.yaml``; the run is on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="the host scene's config (default: <scene_dir>/config.yaml)")
    parser.add_argument("--config2", type=str, default="",
                        help="the donor scene's config (default: <scene_dir2>/config.yaml)")
    parser.add_argument("--checkpoint", type=int, default=-1)
    parser.add_argument("--checkpoint2", type=int, default=-1)
    parser.add_argument("--full_res", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--alpha_grid", type=int, default=200)
    parser.add_argument("--n_views", type=int, default=0)
    parser.add_argument("--scene_dir", type=str, default="",
                        help="override host-scene checkpoint dir")
    parser.add_argument("--scene_dir2", type=str, default="",
                        help="override donor-scene checkpoint dir")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def load_scene(cfg, step, scene_dir, device):
    from .train import checkpoint
    from .train_segm import scene_logdir

    logdir = scene_logdir(cfg, scene_dir)
    path = checkpoint.find_checkpoint(logdir, step)
    if not path:
        raise FileNotFoundError(f"no checkpoint under {logdir}")
    params, meta, _, _, _ = checkpoint.load(path, device=device)
    return params, meta


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns {'params', 'meta', 'dataset',
    'alpha_state', 'preds', 'errors', 'psnr', 'gif'}."""
    args = parse_args(argv)
    from .device import resolve_device
    from .eval.harness import render_split, save_gif_time_sweep
    from .eval.metrics import psnr as psnr_fn
    from .fields import kplane
    from .train_segm import scene_config, scene_logdir

    device = resolve_device(args.device)
    cfg = scene_config(args.config, args.scene_dir)
    cfg2 = scene_config(args.config2, args.scene_dir2)
    if args.full_res:
        cfg.dataset.half_res = False

    params, meta = load_scene(cfg, args.checkpoint, args.scene_dir, device)
    params2, _ = load_scene(cfg2, args.checkpoint2, args.scene_dir2, device)
    # velocity grafting: swap the velocity subtree
    params = dict(params)
    params["vel"] = params2["vel"]

    if args.synthetic:
        from .data import make_synthetic_scene

        dataset = make_synthetic_scene(
            n_train=8, n_val=2, n_test=8, H=64, W=64,
            tmax_frac=float(cfg.nvfi.tmax),
            white_background=bool(cfg.dataset.white_background),
            objects=str(cfg.dataset.get("synthetic_objects", "bat")),
        )[:7]
    else:
        from .data import load_blender_data

        dataset = load_blender_data(
            basedir=str(cfg.dataset.basedir), half_res=bool(cfg.dataset.half_res),
            testskip=int(cfg.dataset.test_skip),
            white_background=bool(cfg.dataset.white_background))

    savedir = os.path.join(scene_logdir(cfg, args.scene_dir), "transfer", "test_img")
    white_bg = bool(cfg.dataset.white_background)
    # the transfer-mode alpha mask, built once and shared with the GIF sweep
    alpha_state, _ = kplane.update_alpha_mask(
        params, meta, tuple(min(g, args.alpha_grid) for g in meta.grid_size), transfer=True,
        device=device)
    preds, errors = render_split(
        params, meta, dataset, "test", white_bg=white_bg, transfer_vel=True, savedir=savedir,
        alpha_state=alpha_state, alpha_grid=args.alpha_grid, max_views=args.n_views,
        device=device)
    print("[transfer]", errors)

    times = np.asarray(dataset[2]["test"], np.float32)[: len(preds)]
    psnrs = []
    for i, t in enumerate(times):
        p = psnr_fn(preds[i], np.asarray(dataset[0]["test"][i], np.float32))
        psnrs.append(p)
        tag = "  <- t=0 host-geometry check" if abs(float(t)) < 1e-6 else ""
        print(f"[transfer] view {i} t={t:.3f} psnr={p:.2f}{tag}")

    gif = os.path.join(os.path.dirname(savedir), "transfer_sweep.gif")
    save_gif_time_sweep(params, meta, dataset, gif, white_bg=white_bg, transfer_vel=True,
                        alpha_state=alpha_state, view=0, device=device)
    print(f"[transfer] time-sweep GIF -> {gif}")
    return {"params": params, "meta": meta, "dataset": dataset, "alpha_state": alpha_state,
            "preds": preds, "errors": errors, "psnr": psnrs, "gif": gif}


if __name__ == "__main__":
    main()

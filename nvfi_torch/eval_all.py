"""Every quality number of a trained synthetic scene in one run, with the port
(port of ``scripts/eval_all.py``).

  python -m nvfi_torch.eval_all --scene_dir D [--config <yaml>] [--checkpoint N]
      [--res 128] [--frames 128] [--alpha_grid 128] [--protocol orbit|heldout]
      [--device cuda|cpu]

In order: the test split's PSNR by view, split at the training tmax into
interpolation and extrapolation; the split's aggregate image metrics; the
velocity end-point error against the scene's exact rigid field at t = 0.2,
0.5 and 0.7, and the RK2 advection error from t = 0.5 back to 0.  The
config defaults to the one the trainer wrote into the scene directory
(``config.yaml``), else ``configs/synth/bat.yaml``.  ``--protocol orbit`` is
the 360-degree novel-view sweep, ``heldout`` the two fixed held-out cameras
(rig scenes).  The lines printed are the JAX script's; the run is on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # None: the config the trainer wrote into the scene directory, so that a
    # checkpoint is never scored against another scene's ground truth
    parser.add_argument("--config", default=None)
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--checkpoint", type=int, default=-1)
    parser.add_argument("--res", type=int, default=128)
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--alpha_grid", type=int, default=128)
    parser.add_argument("--protocol", choices=("orbit", "heldout"), default="orbit")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


VELOCITY_TIMES = (0.2, 0.5, 0.7)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns {'psnr' (by view), 'times',
    'interp', 'extrap' (the two means), 'errors', 'velocity' ({t: the
    velocity_epe dict}), 'advection', 'preds', 'meta'}."""
    args = parse_args(argv)
    from .config import load_config
    from .data import make_synthetic_scene
    from .device import resolve_device
    from .eval.harness import render_split
    from .eval.metrics import psnr
    from .eval.velocity_eval import advection_error, velocity_epe
    from .train import checkpoint

    device = resolve_device(args.device)
    config_path = args.config
    if config_path is None:
        dumped = os.path.join(args.scene_dir, "config.yaml")
        config_path = dumped if os.path.exists(dumped) else "configs/synth/bat.yaml"
        print(f"[eval_all] using config {config_path}")
    cfg = load_config(config_path)
    path = checkpoint.find_checkpoint(args.scene_dir, args.checkpoint)
    if not path:
        raise FileNotFoundError(f"no checkpoint under {args.scene_dir}")
    params, meta, _, _, extra = checkpoint.load(path, device=device)
    print(f"[eval_all] {path} grid={meta.grid_size} K={meta.num_keyframes} "
          f"step={extra.get('global_step')}")

    dataset = make_synthetic_scene(
        n_train=args.frames, n_val=4, n_test=8, H=args.res, W=args.res,
        tmax_frac=float(cfg.nvfi.tmax),
        white_background=bool(cfg.dataset.white_background),
        objects=str(cfg.dataset.get("synthetic_objects", "bat")),
        heldout_test=(args.protocol == "heldout"),
    )
    objects = dataset[7]["objects"]

    preds, errors = render_split(
        params, meta, dataset[:7], "test",
        white_bg=bool(cfg.dataset.white_background), alpha_grid=args.alpha_grid, device=device)
    times = dataset[2]["test"]
    tmax = float(cfg.nvfi.tmax)
    psnrs, interp, extrap = [], [], []
    for i, t in enumerate(times):
        p = psnr(preds[i], dataset[0]["test"][i])
        psnrs.append(p)
        (interp if t <= tmax else extrap).append(p)
        print(f"[view {i}] t={t:.3f} psnr={p:.2f}")
    print(f"[test] aggregate: {errors}")
    print(f"[test] interpolation (t<=tmax) PSNR: {np.mean(interp):.2f}  "
          f"extrapolation (t>tmax) PSNR: {np.mean(extrap):.2f}")

    velocity = {}
    for t in VELOCITY_TIMES:
        velocity[t] = velocity_epe(params, meta, objects, t)
        print(f"[velocity t={t}]", velocity[t])
    advection = advection_error(params, meta, objects, 0.0, 0.5)
    print("[advection 0->0.5]", advection)
    return {"psnr": psnrs, "times": np.asarray(times), "interp": float(np.mean(interp)),
            "extrap": float(np.mean(extrap)), "errors": errors, "velocity": velocity,
            "advection": advection, "preds": preds, "meta": meta}


if __name__ == "__main__":
    main()

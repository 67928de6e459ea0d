"""Novel views along a spiral at arbitrary times with the port (port of
``render_video.py``).

  python -m nvfi_torch.render_video [--config <yaml>] [--scene_dir D]
      [--checkpoint N] [--synthetic] [--synth_res 128] [--n_frames 40]
      [--fps 10] [--radius 4] [--outdir O] [--alpha_grid 128] [--depth]
      [--device cuda|cpu]

Frame i looks from ``_spherical_pose(theta_i, -30, radius)``, theta swept
over a full turn, at t_i swept over [0, 1]: the frames past the training
tmax extrapolate the motion (up to ``meta.render_adv_steps`` RK2 steps).
The checkpoint renders dense-exact (``eval_exact_meta``) through one alpha
mask built at ``min(grid, --alpha_grid)``.  Writes ``r_NNN.png`` (and
``d_NNN.png`` with ``--depth``) and ``video.gif`` under ``--outdir`` (default
``<scene_dir>/render_path``), through the port's own PNG and GIF writers.
The flags are the JAX script's; ``--config`` defaults to the scene
directory's ``config.yaml``; the run is on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="the scene's config (default: <scene_dir>/config.yaml)")
    parser.add_argument("--checkpoint", type=int, default=-1)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synth_res", type=int, default=128)
    parser.add_argument("--n_frames", type=int, default=40)
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--radius", type=float, default=4.0)
    parser.add_argument("--outdir", type=str, default="")
    parser.add_argument("--alpha_grid", type=int, default=128)
    parser.add_argument("--depth", action="store_true", help="also save depth maps")
    parser.add_argument("--scene_dir", type=str, default="",
                        help="override the checkpoint dir (default: <logdir>/<project>/<name>, "
                             "as the other scripts)")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns {'frames' (T, H, W, 3) uint8,
    'times', 'outdir', 'meta', 'alpha_state'}."""
    args = parse_args(argv)
    from .data.blender import _spherical_pose
    from .device import resolve_device
    from .fields import kplane
    from .render import rays as rays_mod
    from .render import renderer
    from .test_transfer_vel import load_scene
    from .train_segm import scene_config, scene_logdir
    from .utils.gif import write_gif
    from .utils.png import write_png
    from .utils.viz import visualize_depth

    device = resolve_device(args.device)
    cfg = scene_config(args.config, args.scene_dir)
    logdir = scene_logdir(cfg, args.scene_dir)
    params, meta = load_scene(cfg, args.checkpoint, args.scene_dir, device)
    meta = kplane.eval_exact_meta(meta)  # strip the training turbo budgets
    print(f"[video] scene {logdir} grid {meta.grid_size} K {meta.num_keyframes}")

    H = W = args.synth_res
    focal = 0.5 * W / np.tan(0.5 * 0.6911112)

    outdir = args.outdir or os.path.join(logdir, "render_path")
    os.makedirs(outdir, exist_ok=True)

    alpha_state, _ = kplane.update_alpha_mask(
        params, meta, tuple(min(g, args.alpha_grid) for g in meta.grid_size), device=device)

    frames = []
    thetas = np.linspace(-180, 180, args.n_frames, endpoint=False)
    times = np.linspace(0.0, 1.0, args.n_frames)
    for i, (th, t) in enumerate(zip(thetas, times)):
        pose = _spherical_pose(float(th), -30.0, args.radius)
        cam = rays_mod.Camera(pose, H, W, focal, near=meta.near_far[0], far=meta.near_far[1])
        out = renderer.render_image(
            params, meta, float(t), cam.rays_o.reshape(H, W, 3), cam.rays_d.reshape(H, W, 3),
            white_bg=bool(cfg.dataset.white_background), alpha_state=alpha_state,
            device=device)
        img = (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(outdir, f"r_{i:03d}.png"), img)
        if args.depth:
            d, _ = visualize_depth(out["depth"])
            write_png(os.path.join(outdir, f"d_{i:03d}.png"), (d * 255).astype(np.uint8))
        frames.append(img)
        print(f"[video] frame {i + 1}/{args.n_frames}", flush=True)

    frames = np.stack(frames)
    write_gif(os.path.join(outdir, "video.gif"), frames, delay_cs=round(100 / args.fps))
    print(f"[video] wrote {outdir}/video.gif")
    return {"frames": frames, "times": times, "outdir": outdir, "meta": meta,
            "alpha_state": alpha_state}


if __name__ == "__main__":
    main()

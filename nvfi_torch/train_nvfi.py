"""Train / evaluate an NVFi scene with the port (port of ``train_nvfi.py``).

  python -m nvfi_torch.train_nvfi --config configs/synth/bat.yaml
      [--static|--static_dynamic|--vel] [--checkpoint N] [--resume] [--not_train]
      [--eval_test] [--eval_val] [--validate] [--full_res] [--iters N]
      [--synthetic] [--device cuda|cpu] [key value ...]

The flags, the dot-path overrides, the log directory (``config.yaml``,
``metrics.jsonl``, ``model_NNNNN`` checkpoints, the time-sweep GIF and the
eval PNGs) and the modes are those of the JAX package's ``train_nvfi.py``.
It runs on the card unless ``--device cpu`` is given.  What the port does not run yet is refused with
``NotImplementedError`` naming its ROADMAP.md item: ``--supervise`` and
``--profile`` (A11), ``--devices`` > 1 (A10) and the static TensoRF models
(a ``model_name`` without ``Keyframe``, A7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_dataset(cfg, args):
    """The analytic synthetic scene (``--synthetic``, or no dataset on
    disk), else the blender loader."""
    if args.synthetic or not os.path.exists(
            os.path.join(cfg.dataset.basedir, "transforms_train.json")):
        from .data import make_synthetic_scene

        if not args.synthetic:
            print(f"[data] {cfg.dataset.basedir} not found -> synthetic scene")
        return make_synthetic_scene(
            n_train=args.synth_frames, n_val=4, n_test=8,
            H=args.synth_res, W=args.synth_res,
            tmax_frac=float(cfg.nvfi.tmax),
            white_background=bool(cfg.dataset.white_background),
            objects=str(cfg.dataset.get("synthetic_objects", "bat")),
        )[:7]
    from .data import load_blender_data

    return load_blender_data(
        basedir=cfg.dataset.basedir,
        half_res=bool(cfg.dataset.half_res),
        testskip=int(cfg.dataset.test_skip),
        white_background=bool(cfg.dataset.white_background),
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=int, default=0)
    parser.add_argument("--not_train", action="store_true")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--validate", action="store_true",
                        help="render a val view every validate_every iters")
    parser.add_argument("--eval_val", action="store_true")
    parser.add_argument("--eval_test", action="store_true")
    parser.add_argument("--full_res", action="store_true")
    parser.add_argument("--static", action="store_true")
    parser.add_argument("--vel", action="store_true")
    parser.add_argument("--static_dynamic", action="store_true")
    parser.add_argument("--iters", type=int, default=0, help="override train_iters")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synth_res", type=int, default=96)
    parser.add_argument("--synth_frames", type=int, default=48)
    parser.add_argument("--devices", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--logdir", type=str, default="")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint from --logdir and continue "
                             "training in place")
    parser.add_argument("--profile", type=int, default=0,
                        help="trace the first N train steps (not ported: ROADMAP.md A11)")
    parser.add_argument("--supervise", action="store_true",
                        help="stall detection and auto-resume (not ported: ROADMAP.md A11)")
    parser.add_argument("--stall_timeout", type=float, default=720.0)
    parser.add_argument("opts", nargs="*", help="dot-path config overrides: key value ...")
    return parser.parse_args(argv)


def refuse_unported(args, cfg):
    if args.supervise:
        raise NotImplementedError("nvfi_torch.train_nvfi: --supervise (ROADMAP.md A11: "
                                  "operability) is not ported yet")
    if args.profile:
        raise NotImplementedError("nvfi_torch.train_nvfi: --profile (ROADMAP.md A11: "
                                  "operability) is not ported yet")
    if args.devices > 1:
        raise NotImplementedError("nvfi_torch.train_nvfi: --devices > 1 (ROADMAP.md A10: "
                                  "parallel) is not ported yet")
    if "Keyframe" not in str(cfg.nvfi.model_name):
        raise NotImplementedError(f"nvfi_torch.train_nvfi: model {cfg.nvfi.model_name} "
                                  "(ROADMAP.md A7: static TensoRF) is not ported yet")


def main(argv=None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` by default).  Returns
    {'trainer', 'dataset', 'eval'}: the trainer after its run, the dataset
    tuple and the eval split's metrics (None without --eval_test / --eval_val)."""
    args = parse_args(argv)
    from .config import load_config
    from .device import resolve_device

    cfg = load_config(args.config, args.opts or None)
    if args.full_res:
        cfg.dataset.half_res = False
    refuse_unported(args, cfg)
    device = resolve_device(args.device)

    mode = "static" if args.static else "vel" if args.vel else "static_dynamic" \
        if args.static_dynamic else "dynamic"

    logdir = args.logdir or os.path.join(
        str(cfg.experiment.logdir), str(cfg.wandb.project), str(cfg.wandb.name))
    if args.checkpoint:
        logdir = os.path.join(logdir, "from_checkpoint")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yaml"), "w") as f:
        f.write(cfg.dump())

    dataset = build_dataset(cfg, args)
    print(f"[data] H W focal = {dataset[6]}; train frames = {dataset[3]['train']}")

    from .train import checkpoint as ckpt_mod
    from .train.trainer import Trainer

    trainer = Trainer(cfg, dataset, mode=mode, logdir=logdir, device=device)

    if args.checkpoint or args.not_train or args.resume:
        # a numbered checkpoint, or (eval-only, --resume) the latest
        base = os.path.dirname(logdir) if args.checkpoint and logdir.endswith(
            "from_checkpoint") else logdir
        path = ckpt_mod.find_checkpoint(base, args.checkpoint or -1)
        if path:
            trainer.restore(path)
            print(f"[ckpt] restored {path} at step {trainer.global_step}")
        elif args.not_train:
            print(f"[ckpt] WARNING: no checkpoint under {base}; evaluating fresh init")

    wandb = None
    if args.wandb:
        try:
            import wandb as _wandb

            _wandb.init(project=str(cfg.wandb.project), name=str(cfg.wandb.name),
                        config=cfg.to_dict(), notes=str(cfg.wandb.get("notes", "")))
            wandb = _wandb
        except ImportError:
            print("[wandb] package not installed; falling back to JSONL metrics")

    white_bg = bool(cfg.dataset.white_background)
    if not args.not_train:
        metrics_f = open(os.path.join(logdir, "metrics.jsonl"), "a")

        def log(m):
            vm = f" |v|={m['vel_mag']:.4f}" if "vel_mag" in m else ""
            print(f"[train] it={m['it']} loss={m['loss']:.5f} psnr0={m['psnr_0']:.2f} "
                  f"psnr_t={m['psnr_t']:.2f}{vm} ({m['elapsed']:.0f}s)", flush=True)
            metrics_f.write(json.dumps(m) + "\n")
            metrics_f.flush()
            if wandb:
                wandb.log(m, step=m["it"])

        val_fn = None
        if args.validate and dataset[3].get("val"):
            from .eval.harness import save_png
            from .eval.metrics import psnr as psnr_fn
            from .render import rays as rays_mod
            from .render.renderer import render_image
            from .utils.viz import visualize_depth

            def val_fn(tr, it):
                H, W, focal = dataset[6]
                idx = it // max(cfg.experiment.validate_every, 1) % dataset[3]["val"]
                cam = rays_mod.Camera(dataset[1]["val"][idx], H, W, focal,
                                      near=tr.meta.near_far[0], far=tr.meta.near_far[1])
                out = render_image(tr.params, tr.meta, float(dataset[2]["val"][idx]),
                                   cam.rays_o.reshape(H, W, 3), cam.rays_d.reshape(H, W, 3),
                                   white_bg=white_bg, device=device)
                p = psnr_fn(out["rgb"], dataset[0]["val"][idx])
                print(f"[val] it={it} view={idx} psnr={p:.2f}", flush=True)
                depth_vis, _ = visualize_depth(out["depth"], minmax=tr.meta.near_far)
                save_png(os.path.join(logdir, f"val_{it:06d}.png"), out["rgb"])
                save_png(os.path.join(logdir, f"val_{it:06d}_depth.png"), depth_vis)
                if wandb:
                    wandb.log({"val_psnr": p,
                               "validation/rgb": wandb.Image(np.asarray(out["rgb"])),
                               "validation/depth": wandb.Image(np.asarray(depth_vis))},
                              step=it)

        trainer.train(
            iters=args.iters or None, log_fn=log, val_fn=val_fn,
            progress=sys.stdout.isatty(),
            progress_refresh=int(cfg.get("pbar", {}).get("progress_refresh_rate", 10)),
        )
        metrics_f.close()
        trainer.save(os.path.join(logdir, f"model_{trainer.global_step - 1:05d}"))

        if dataset[3].get("val"):
            # the time-sweep video of a fixed val pose
            try:
                from .eval.harness import save_gif_time_sweep

                gif_path = os.path.join(logdir, "time_sweep.gif")
                frames = save_gif_time_sweep(trainer.params, trainer.meta, dataset, gif_path,
                                             white_bg=white_bg, device=device)
                print(f"[video] {frames.shape[0]}-frame time sweep -> {gif_path}", flush=True)
                if wandb:
                    wandb.log({"validation/video": wandb.Video(
                        (np.clip(frames, 0, 1) * 255).astype(np.uint8).transpose(0, 3, 1, 2),
                        fps=8, format="gif")})
            except Exception as e:
                print(f"[video] skipped: {e}", flush=True)

    errors = None
    if args.eval_test or args.eval_val:
        from .eval.harness import render_split

        split = "test" if args.eval_test else "val"
        _, errors = render_split(trainer.params, trainer.meta, dataset, split,
                                 white_bg=white_bg,
                                 savedir=os.path.join(logdir, f"{split}_img"), device=device)
        print(f"[eval:{split}]", errors)
    return {"trainer": trainer, "dataset": dataset, "eval": errors}


if __name__ == "__main__":
    main()

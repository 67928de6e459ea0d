"""Train the unsupervised 3D instance-segmentation MaskField with the port
(port of ``train_segm.py``).

  python -m nvfi_torch.train_segm [--config <yaml>] [--checkpoint N] [--iters N]
      [--logdir D] [--point_budget N] [--scene_dir D] [--device cuda|cpu]
      [key value ...]

Loads a frozen NVFi checkpoint (written by either package's ``train_nvfi``)
and distills its motion field into a per-point K-way MaskField
(``train.segm.SegmTrainer``).  The flags are the JAX driver's; the config
defaults to the scene directory's ``config.yaml`` (which ``train_nvfi``
writes), dot-path overrides follow as in ``train_nvfi``, and the run is on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os


def scene_logdir(cfg, scene_dir: str = "") -> str:
    """The scene's log directory: ``scene_dir`` or the config's own."""
    return scene_dir or os.path.join(str(cfg.experiment.logdir), str(cfg.wandb.project),
                                     str(cfg.wandb.name))


def scene_config(config: str, scene_dir: str, opts=None):
    """``config``, else the scene directory's ``config.yaml``."""
    from .config import load_config

    path = config or os.path.join(scene_dir, "config.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config: pass --config or a --scene_dir holding config.yaml "
                                f"({path})")
    return load_config(path, opts or None)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="the scene's config (default: <scene_dir>/config.yaml)")
    parser.add_argument("--checkpoint", type=int, default=-1)
    parser.add_argument("--iters", type=int, default=0)
    parser.add_argument("--logdir", type=str, default="")
    parser.add_argument("--point_budget", type=int, default=8192)
    parser.add_argument("--scene_dir", type=str, default="",
                        help="override the NVFi checkpoint directory")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (the default) or 'cpu'")
    parser.add_argument("opts", nargs="*", help="dot-path config overrides: key value ...")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI on ``argv``; returns the trainer after its run."""
    args = parse_args(argv)
    from .device import resolve_device
    from .train import checkpoint
    from .train.segm import SegmTrainer

    device = resolve_device(args.device)
    cfg = scene_config(args.config, args.scene_dir, args.opts)
    logdir_scene = scene_logdir(cfg, args.scene_dir)
    path = checkpoint.find_checkpoint(logdir_scene, args.checkpoint)
    if not path:
        raise FileNotFoundError(f"no NVFi checkpoint under {logdir_scene}")
    params, meta, _, _, _ = checkpoint.load(path, device=device)
    print(f"[segm] scene ckpt {path}, grid {meta.grid_size}, K {meta.num_keyframes}")

    logdir = args.logdir or os.path.join(
        "logs_segm", f"{cfg.wandb.name}_k={cfg.segmentation.n_object}")
    os.makedirs(logdir, exist_ok=True)

    trainer = SegmTrainer(cfg, params, meta, point_budget=args.point_budget, device=device)
    trainer.train(
        logdir=logdir,
        log_fn=lambda m: print(
            f"[segm] it={m['it']} dyn={m['dynamic']:.4f} smooth={m['smooth']:.4f} "
            f"ent={m['entropy']:.4f}", flush=True),
        iters=args.iters or None,
    )
    trainer.save(os.path.join(logdir, "mask_final"))
    print(f"[segm] saved {logdir}/mask_final")
    return trainer


if __name__ == "__main__":
    main()

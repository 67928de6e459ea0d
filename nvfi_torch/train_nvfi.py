"""Train / evaluate an NVFi scene with the port (port of ``train_nvfi.py``).

  python -m nvfi_torch.train_nvfi --config configs/synth/bat.yaml
      [--static|--static_dynamic|--vel] [--checkpoint N] [--resume] [--not_train]
      [--eval_test] [--eval_val] [--validate] [--full_res] [--iters N]
      [--synthetic] [--profile N] [--supervise [--stall_timeout S]]
      [--devices N] [--device cuda|cpu] [key value ...]

The flags, the dot-path overrides, the log directory (``config.yaml``,
``metrics.jsonl``, ``model_NNNNN`` checkpoints, the time-sweep GIF and the
eval PNGs) and the modes are those of the JAX package's ``train_nvfi.py``.
It runs on the card unless ``--device cpu`` is given.

``--supervise`` re-runs the same command as a child,
``python -u -m nvfi_torch.train_nvfi``, under ``train/supervisor.py``: a child
whose ``<logdir>/heartbeat`` goes stale or that dies is ended and started
again with ``--resume --logdir <logdir>``.  The parent never touches the
card.  ``--profile N`` traces the first N train steps with ``torch.profiler``
(host and, on the card, device activity) into a Chrome trace under
``<logdir>/profile/``; on the card a trace without device time is an error.
A ``model_name`` without ``Keyframe`` (``TensorVMSplit``, ``TensorCP``)
trains the static TensoRF field with ``train.static.StaticTrainer``, as the
JAX CLI does: one ``[static]`` line a logged iteration, no checkpoint,
nothing with ``--not_train``.

``--devices N`` (N > 1) trains on N ranks with the data-parallel step
(``Trainer(mesh=..., spmd='auto')``, as the JAX CLI's mesh): the command
starts N processes through ``parallel.launch`` (an ``nccl`` group, one card
a rank; ``--device cpu``: ``gloo`` ranks on the CPU), each runs this driver
on its rank, and rank 0 alone writes the logs, checkpoints, GIF and eval.
``--devices 0`` (the default) means every visible card, one rank without a
mesh on the CPU.  The static branch stays one process, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
                        help="wrap the first N train steps in a torch.profiler trace written "
                             "to <logdir>/profile")
    parser.add_argument("--supervise", action="store_true",
                        help="run training under the supervisor: stall detection on "
                             "<logdir>/heartbeat and auto-resume from the latest checkpoint "
                             "(nvfi_torch/train/supervisor.py)")
    parser.add_argument("--stall_timeout", type=float, default=720.0,
                        help="seconds of heartbeat silence before the supervisor ends and "
                             "resumes the run")
    parser.add_argument("opts", nargs="*", help="dot-path config overrides: key value ...")
    return parser.parse_args(argv)


def n_ranks(args, cfg) -> int:
    """The ranks a run trains on: ``--devices``, or with 0 every visible card
    (one on the CPU); the static models train in one process."""
    if "Keyframe" not in str(cfg.nvfi.model_name):
        return 1
    if args.devices:
        return args.devices
    import torch

    cuda = torch.device(args.device).type == "cuda" and torch.cuda.is_available()
    return max(1, torch.cuda.device_count()) if cuda else 1


def rank_main(mesh, argv) -> dict:
    """One rank of ``--devices N``: this driver on ``mesh``; what it returns
    is the run's summary (params on rank 0 only)."""
    from .train.checkpoint import params_to_numpy

    out = main(argv, mesh=mesh)
    tr = out["trainer"]
    return {"global_step": tr.global_step, "meta": dataclasses.asdict(tr.meta),
            "events": tr.events, "eval": out["eval"],
            "params": params_to_numpy(tr.params) if mesh.is_main else None}


def supervised_argv(argv, logdir: str):
    """``attempt -> argv`` of the supervised child: this command without
    ``--supervise`` as ``python -u -m nvfi_torch.train_nvfi`` (the module
    file run as a script would lose the package's relative imports; -u keeps
    the child's log as live as its heartbeat), with ``--resume --logdir
    <logdir>`` from attempt 1 on."""
    base = [sys.executable, "-u", "-m", "nvfi_torch.train_nvfi"] + [
        a for a in argv if a != "--supervise"]

    def build_argv(attempt):
        if attempt and "--resume" not in base:
            return base + ["--resume", "--logdir", logdir]
        return list(base)

    return build_argv


def main(argv=None, mesh=None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` by default).  Returns
    {'trainer', 'dataset', 'eval'}: the trainer after its run, the dataset
    tuple and the eval split's metrics (None without --eval_test / --eval_val);
    with --supervise {'rc', 'restarts'}: the supervised run's exit code and
    its restarts; with ``--devices`` N > 1 {'ranks', 'eval'}: each rank's
    summary (:func:`rank_main`) and rank 0's eval.  ``mesh``: the rank that
    :func:`rank_main` runs."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    from .config import load_config
    from .device import resolve_device

    cfg = load_config(args.config, args.opts or None)
    if args.full_res:
        cfg.dataset.half_res = False
    main_rank = mesh is None or mesh.is_main

    mode = "static" if args.static else "vel" if args.vel else "static_dynamic" \
        if args.static_dynamic else "dynamic"

    logdir = args.logdir or os.path.join(
        str(cfg.experiment.logdir), str(cfg.wandb.project), str(cfg.wandb.name))
    if args.checkpoint:
        logdir = os.path.join(logdir, "from_checkpoint")
    os.makedirs(logdir, exist_ok=True)
    if mesh is None:  # a rank's parent wrote it
        with open(os.path.join(logdir, "config.yaml"), "w") as f:
            f.write(cfg.dump())

    if args.supervise and mesh is None:
        # before anything touches the card, so that the parent never holds it;
        # restarts resume from the latest checkpoint in the logdir
        from .train.supervisor import run_supervised

        rc, restarts = run_supervised(supervised_argv(argv, logdir),
                                      os.path.join(logdir, "heartbeat"),
                                      stall_timeout=args.stall_timeout)
        return {"rc": rc, "restarts": restarts}

    ranks = n_ranks(args, cfg) if mesh is None else 1
    if ranks > 1:
        from .parallel.launch import launch
        # by its package name: run as `python -m`, this module is __main__
        from .train_nvfi import rank_main as run_rank

        print(f"[mesh] data axis over {ranks} ranks ({args.device})", flush=True)
        out = launch(run_rank, ranks, (argv,), device=args.device)
        return {"ranks": [r["result"] for r in out], "eval": out[0]["result"]["eval"]}

    device = mesh.device if mesh is not None else resolve_device(args.device)
    dataset = build_dataset(cfg, args)
    print(f"[data] H W focal = {dataset[6]}; train frames = {dataset[3]['train']}")

    from .train import checkpoint as ckpt_mod
    from .train.trainer import Trainer

    if "Keyframe" not in str(cfg.nvfi.model_name):
        # the static TensoRF family (TensorVMSplit / TensorCP)
        from .train.static import StaticTrainer

        trainer = StaticTrainer(cfg, dataset, device=device)

        def slog(m):
            print(f"[static] it={m['it']} loss={m['loss']:.5f} "
                  f"psnr0={m['psnr_0']:.2f} ({m['elapsed']:.0f}s)", flush=True)

        if not args.not_train:
            trainer.train(iters=args.iters or None, log_fn=slog)
        return {"trainer": trainer, "dataset": dataset, "eval": None}

    trainer = Trainer(cfg, dataset, mode=mode, logdir=logdir, device=device, mesh=mesh)

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
    if args.wandb and main_rank:
        try:
            import wandb as _wandb

            _wandb.init(project=str(cfg.wandb.project), name=str(cfg.wandb.name),
                        config=cfg.to_dict(), notes=str(cfg.wandb.get("notes", "")))
            wandb = _wandb
        except ImportError:
            print("[wandb] package not installed; falling back to JSONL metrics")

    white_bg = bool(cfg.dataset.white_background)
    if not args.not_train:
        metrics_f = open(os.path.join(logdir, "metrics.jsonl"), "a") if main_rank else None

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

        if args.profile and (args.iters or int(cfg.experiment.train_iters)) > 0:
            profile_steps(trainer, args.profile, os.path.join(logdir, "profile"), log, val_fn)
        trainer.train(
            iters=args.iters or None, log_fn=log, val_fn=val_fn,
            progress=sys.stdout.isatty(),
            progress_refresh=int(cfg.get("pbar", {}).get("progress_refresh_rate", 10)),
        )
        if metrics_f is not None:
            metrics_f.close()
        trainer.save(os.path.join(logdir, f"model_{trainer.global_step - 1:05d}"))

        if dataset[3].get("val") and main_rank:
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
    if (args.eval_test or args.eval_val) and main_rank:
        from .eval.harness import render_split

        split = "test" if args.eval_test else "val"
        _, errors = render_split(trainer.params, trainer.meta, dataset, split,
                                 white_bg=white_bg,
                                 savedir=os.path.join(logdir, f"{split}_img"), device=device)
        print(f"[eval:{split}]", errors)
    return {"trainer": trainer, "dataset": dataset, "eval": errors}


def profile_steps(trainer, n: int, trace_dir: str, log_fn, val_fn) -> str:
    """Train the next ``n`` steps under ``torch.profiler`` and write their
    Chrome trace to ``<trace_dir>/trace_<first step>.json``; returns its
    path.  On the card the trace must hold device time: a tracer that saw
    none raises (nothing here swallows a failure of the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    first = trainer.global_step
    if not trainer.is_main:  # only rank 0 traces; the others step alongside
        trainer.train(iters=first + n)
        return None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        trainer.train(iters=first + n, log_fn=log_fn, val_fn=val_fn)
        if cuda:
            torch.cuda.synchronize(trainer.device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{first:05d}.json")
    prof.export_chrome_trace(path)
    if cuda:
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if not kernels:
            raise RuntimeError("--profile: the profiler recorded no device activity on "
                               f"{trainer.device}")
    print(f"[profile] trace for {n} steps ({first}..{trainer.global_step - 1}) -> {path}",
          flush=True)
    return path


if __name__ == "__main__":
    sys.exit(main().get("rc", 0))

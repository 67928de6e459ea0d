"""Render and score instance segmentation with the port (AP@50, PQ, F1,
mIoU; port of ``test_segm_render.py``).

  python -m nvfi_torch.test_segm_render [--config <yaml>] [--checkpoint N]
      [--ckpt_segm PATH] [--synthetic] [--outdir D] [--alpha_grid N]
      [--n_views N] [--scene_dir D] [--export_points N] [--device cuda|cpu]

Renders the test views with ``transfer_vel=True``, so that all geometry is
read in the canonical t = 0 frame through the velocity field, under a
transfer alpha mask built once, composites the MaskField along each ray,
then matches the labels to the ground-truth masks (Hungarian) and scores
them.  ``--export_points N`` also writes PLY files: an N-cell volume sweep
classified by the MaskField as coloured balls, flow arrows through the
velocity field and the model's aabb, plus a PNG snapshot where matplotlib
imports.  The flags are the JAX driver's; the config defaults to the scene
directory's ``config.yaml``; the run is on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="the scene's config (default: <scene_dir>/config.yaml)")
    parser.add_argument("--checkpoint", type=int, default=-1)
    parser.add_argument("--ckpt_segm", type=str, default="")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--outdir", type=str, default="")
    parser.add_argument("--alpha_grid", type=int, default=128)
    parser.add_argument("--n_views", type=int, default=0, help="limit test views")
    parser.add_argument("--scene_dir", type=str, default="",
                        help="override the NVFi checkpoint directory")
    parser.add_argument("--export_points", type=int, default=0,
                        help="also export PLY debug files of an N-cell volume sweep")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def load_segm_dataset(cfg, synthetic: bool):
    """(images, poses, times, GT masks, (H, W, focal)) of the test views."""
    if synthetic:
        from .data import make_synthetic_scene

        data = make_synthetic_scene(
            n_train=8, n_val=2, n_test=8, H=64, W=64,
            tmax_frac=float(cfg.nvfi.tmax),
            white_background=bool(cfg.dataset.white_background),
            objects=str(cfg.dataset.get("synthetic_objects", "bat")),
        )
        return (data[0]["test"], data[1]["test"], data[2]["test"], data[7]["segm"]["test"],
                tuple(data[6]))
    from .data import load_blender_data_segm

    basedir = str(cfg.dataset.basedir).replace("data", "data_segm_allframe")
    imgs, poses, segms, times, _, _, _, (H, W, focal) = load_blender_data_segm(
        basedir, bool(cfg.dataset.half_res), int(cfg.dataset.test_skip),
        bool(cfg.dataset.white_background))
    return imgs, poses, times, segms, (H, W, focal)


def export_points(outdir, params, meta, mask_params, n, device):
    """The PLY debug files of an n-cell volume sweep (and the PNG snapshot
    where matplotlib imports).  Returns the file paths written."""
    import torch

    from .fields import kplane, mask_field
    from .train.segm import normalize_coord_np, sample_volume_points
    from .utils import point_viz as pv

    rng = np.random.RandomState(0)
    a = meta.aabb_np
    xyz = sample_volume_points(rng, np.stack([a[0], a[1]], -1), n).reshape(-1, 3)
    with torch.inference_mode():
        xyz_n = torch.as_tensor(normalize_coord_np(meta, xyz), device=device)
        t0 = torch.zeros((len(xyz), 1), dtype=torch.float32, device=device)
        xyzt = torch.cat([xyz_n, kplane.normalize_time(meta, t0)], -1)
        sigma = kplane.feature2density(meta, kplane.density_feature(params, meta, xyzt))
        keep = (1.0 - torch.exp(-sigma * 0.01) > 1e-3).cpu().numpy()
        xyz, xyz_n = xyz[keep], xyz_n[torch.as_tensor(keep, device=device)]
        labels = torch.argmax(mask_field.apply(mask_params, xyz_n), -1).cpu().numpy()
        # forward flow t0 -> mid-window through the velocity field
        bt = torch.full((len(xyz), 1), 0.5 * meta.tmax, dtype=torch.float32, device=device)
        adv = kplane.integrate_pos(params, meta, xyz_n, torch.zeros_like(bt), bt,
                                   n_steps=meta.max_adv_steps)
        flow = (adv - xyz_n).cpu().numpy() * (a[1] - a[0]) / 2.0  # world units

    paths = [os.path.join(outdir, f) for f in ("points_segm.ply", "flow_arrows.ply", "aabb.ply")]
    pv.save_ply_mesh(paths[0], pv.pc_segm_to_sphere(xyz, labels, radius=0.01))
    pv.save_ply_mesh(paths[1], pv.pc_flow_to_arrows(xyz, flow, radius=0.004))
    (bbox,) = pv.build_bbox3d(pv.bound_to_box([np.stack([a[0], a[1]], -1)]))
    pv.save_ply_mesh(paths[2], {"vertices": bbox["points"], "edges": bbox["edges"],
                                "colors": np.tile([[0.0, 1.0, 0.0]], (8, 1))})
    try:
        png = os.path.join(outdir, "points_segm.png")
        pv.snapshot_png(png, pointclouds=[pv.build_pointcloud_segm(xyz, labels)],
                        boxes=[bbox], flows=(xyz[::17], flow[::17]), lim=float(np.abs(a).max()))
        paths.append(png)
    except ImportError as e:
        print(f"[viz] PNG snapshot skipped: {e}")
    print(f"[viz] {int(keep.sum())} occupied points -> {', '.join(paths)}")
    return paths


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns {'results', 'pred_masks', 'acc',
    'alpha_state', 'meta', 'params', 'mask_params', 'views' (poses, times,
    (H, W, focal)), 'white_bg', 'outdir', 'exported'}."""
    args = parse_args(argv)
    from .device import resolve_device
    from .eval import segm_metrics as sm
    from .fields import kplane
    from .render import rays as rays_mod
    from .render.renderer import render_image
    from .train import checkpoint
    from .train_segm import scene_config, scene_logdir

    device = resolve_device(args.device)
    cfg = scene_config(args.config, args.scene_dir)
    logdir_scene = scene_logdir(cfg, args.scene_dir)
    path = checkpoint.find_checkpoint(logdir_scene, args.checkpoint)
    if not path:
        raise FileNotFoundError(f"no NVFi checkpoint under {logdir_scene}")
    params, meta, _, _, _ = checkpoint.load(path, device=device)
    meta = kplane.eval_exact_meta(meta)  # strip training turbo budgets

    segm_dir = os.path.join("logs_segm", f"{cfg.wandb.name}_k={cfg.segmentation.n_object}")
    mask_path = args.ckpt_segm or os.path.join(segm_dir, "mask_final")
    mask_params, _, _, _, extra = checkpoint.load(mask_path, device=device)
    n_object = int(extra.get("n_object", cfg.segmentation.n_object))
    meta = replace(meta, mask_dim=n_object)

    imgs, poses, times, segms, (H, W, focal) = load_segm_dataset(cfg, args.synthetic)
    outdir = args.outdir or os.path.join(segm_dir, "test_render")
    os.makedirs(outdir, exist_ok=True)

    alpha_state, _ = kplane.update_alpha_mask(
        params, meta, tuple(min(g, args.alpha_grid) for g in meta.grid_size), transfer=True,
        device=device)

    n_views = min(len(poses), args.n_views) if args.n_views else len(poses)
    pred_masks, accs = [], []
    for vid in range(n_views):
        cam = rays_mod.Camera(poses[vid], H, W, focal, near=meta.near_far[0],
                              far=meta.near_far[1])
        out = render_image(
            params, meta, float(times[vid]), cam.rays_o.reshape(H, W, 3),
            cam.rays_d.reshape(H, W, 3), white_bg=bool(cfg.dataset.white_background),
            transfer_vel=True, alpha_state=alpha_state, mask_params=mask_params, device=device)
        pred_masks.append(out["mask"])
        accs.append(out["acc"])
        np.save(os.path.join(outdir, f"r_{vid:03d}_segm.npy"), out["mask"])
    pred_masks = np.stack(pred_masks)  # (V, H, W, K)

    ap_iou, ap_matched, ap_conf, n_inst, mious = [], [], [], 0, []
    for vid in range(n_views):
        gt = np.asarray(segms[vid]).reshape(-1)
        pm = pred_masks[vid].reshape(-1, n_object)
        i, m, c, n = sm.eval_segm(gt, pm)
        ap_iou.append(i)
        ap_matched.append(m)
        ap_conf.append(c)
        n_inst += n
        mious.append(sm.clustering_miou(pm, sm.compress_label(gt)))

    AP = sm.calculate_AP(np.concatenate(ap_matched), np.concatenate(ap_conf), n_inst)
    PQ, F1, Pre, Rec = sm.calculate_PQ_F1(np.concatenate(ap_iou), np.concatenate(ap_matched),
                                          n_inst)
    results = {"AP@50": AP, "PQ@50": PQ, "F1@50": F1, "Pre@50": Pre, "Rec@50": Rec,
               "mIoU": float(np.mean(mious))}
    print(results)
    with open(os.path.join(outdir, "segm_metrics.txt"), "w") as f:
        f.write(str(results))

    exported = []
    if args.export_points:
        exported = export_points(outdir, params, meta, mask_params, int(args.export_points),
                                 device)
    return {"results": results, "pred_masks": pred_masks, "acc": np.stack(accs),
            "alpha_state": alpha_state, "meta": meta, "params": params,
            "mask_params": mask_params, "views": (poses[:n_views], times[:n_views], (H, W, focal)),
            "white_bg": bool(cfg.dataset.white_background), "outdir": outdir,
            "exported": exported}


if __name__ == "__main__":
    main()

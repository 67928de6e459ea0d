#!/usr/bin/env python3
"""Chip smoke test of the nvfi_torch port on one NVIDIA card (H100, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  env     the card's name and power limit, torch and CUDA versions; TF32 off
  build   compile nvfi_torch/csrc/*.cu with nvcc for sm_90a (one nvcc per
          source, all started together) and print the ptxas report
  K1      plane_product kernel vs plane_product_reference at the main-path
          size of the bat model (199^3 grid, K=16, 72 channels, 4096*686
          samples) in three orders: uniform coords, the ray-ordered samples of
          one render chunk at t = 0.4 (as render_rays builds them), and those
          samples shuffled; kernel, plain, library (F.grid_sample) and bound
          times and the kernel-to-library ratio at each
  K2      composite kernel vs composite_reference at (4096, 686)
  K1d     the density-only entry of the plane_product kernel at the mask
          sweep's shape (262144 points: uniform coords, and the grid-ordered
          middle chunk of the 199^3 sweep) and at the train step's (the PDE
          filter's strata): against its plain version, and equal bit for bit
          to the density output of K1
  K5      row_gather: the gather of the repository's two Pallas probes (1024
          rows of a 512 x 128 table of ones, summed) as a path of its own,
          then the kernel vs tab[idx] at that shape and at the block-sparse
          `pick` shape (rows of 64*3 floats); times through the wrapper and
          of the kernel alone
  render  the full-width bat model (configs/synth/bat.yaml, random seeded
          weights plus a seeded density blob) rendered 400x400 through
          render_image at t = 0.4 (keyframe), 0.425 (between keyframes) and
          0.9 (past tmax, 11 RK2 steps); launch counts, acc and weight
          checks, one 256-ray chunk per time against the port on the CPU,
          and a torch.profiler breakdown of one chunk
  alpha   update_alpha_mask at full width (199^3 mask grid, 60 times, 31
          chunks of 262144 points through K1d): seconds, launches, occupied
          share, new_aabb; one chunk of the sweep at t = 0.4 and t = 0.9
          against the port on the CPU
  K3, K4  occupancy_trilinear and occupancy_nearest kernels vs their plain
          versions at 4096*686 coords in [-1.1, 1.1] (K4 also at the pruned
          train step's two shapes), on the mask just built
          (which is why they follow `alpha`) with the shrunk box as its aabb;
          K3's library time is the function it computes, to_mask_coords +
          F.grid_sample
  split   eval.harness.render_split over three views (the poses and times of
          `render`, whose unmasked images are the ground truth) with the
          mask: rays/s and K1/K2/K3 launches per frame, the share of samples
          the mask leaves valid, PSNR/SSIM against the unmasked renders, and
          one 256-ray chunk per time against the port on the CPU
  K1b     plane_product_bwd kernel vs plane_product_backward_reference at
          the train chunk's shape (128 * 686 samples at one keyframe time,
          most incoming grads zero as in training), its time there with every
          grad non-zero and at the render shape; plain and library (autograd
          through six F.grid_sample) times; K1 vs its plain version at that
          shape
  K2b     composite_bwd kernel vs composite_backward_reference at (128, 686)
          and (4096, 686), both backgrounds, with rays that miss the box
          (the clip's tie), saturated samples and samples under the threshold;
          K2 as the train step runs it (storing the colour before the clip)
          vs its plain version at both shapes
  train   ten static_dynamic steps of trainer.make_train_step at full width
          (2 renders x 16 chunks of 128 rays, the PDE loss on 262144 points,
          TV/L1, Adam) against the unmasked frames at t = 0.4 (keyframe
          batch) and t = 0.425 (random-time batch), from params with a
          re-drawn shader: launch counts per step, finite grads that are
          non-zero where they must be, a lower loss on fixed draws, the grads
          of one 16-ray chunk three ways (the card through the kernels, the
          card through the plain versions, the port on the CPU), seconds per
          step, rays/s and one traced step
  train_prune  three steps with train_occupancy_prune and the mask of `alpha`
          (K4 in every chunk and in the PDE prefilter); pruned against
          unpruned loss on the same draws
The last three lines are the card line from nvidia-smi, the kernels JSON line
and the result line {"ok": true, "device": {...}}.

The numbers it prints are this card's, at its power limit; bounds use the
H100 SXM data-sheet peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 without tensor
cores).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dataclasses import replace

from nvfi_torch.config import load_config
from nvfi_torch.eval import harness
from nvfi_torch.fields import kplane, shaders
from nvfi_torch.ops import compositing, gather, grid_sample, kernels, occupancy
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import optim, trainer
from nvfi_torch.train.trainer import n_to_reso

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "synth" / "bat.yaml"
SEED = 0
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
IMAGE = 400  # bat renders at half resolution
FOCAL = 0.5 * IMAGE / np.tan(0.5 * 0.6911112070083618)  # Blender camera_angle_x
TIMES = (0.4, 0.425, 0.9)
CHUNK = 4096
ALPHA_CHUNK = 262144  # compute_dense_alpha's chunk
ALPHA_TIMES = 60
PSNR_FLOOR = 30.0  # masked against unmasked renders
# every launch counter of the port, by the kernel's name in the kernels line
COUNTERS = {
    "plane_product_fwd": grid_sample.plane_product,
    "plane_product_density_fwd": grid_sample.plane_product_density,
    "composite_fwd": compositing.composite,
    "occupancy_trilinear_fwd": occupancy.occupancy_trilinear,
    "occupancy_nearest_fwd": occupancy.occupancy_nearest,
    "row_gather_fwd": gather.row_gather,
    "plane_product_bwd": grid_sample.plane_product_backward,
    "composite_bwd": compositing.composite_backward,
}


def reset_counts():
    for wrapper in COUNTERS.values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in COUNTERS.items()}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` over ``reps`` calls, with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_close(name, got, want, rtol, atol_rel):
    """|got - want| <= atol + rtol |want|, atol scaled to want's magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        atol = atol_rel * max(float(w.abs().max()), 1e-30)
        bad = ((g - w).abs() > atol + rtol * w.abs()) | ~torch.isfinite(g)
        require(not bool(bad.any()), f"{name} output {i}: {int(bad.sum())} values off "
                f"(max err {float((g - w).abs().max()):.3e}, atol {atol:.3e}, rtol {rtol})")


# ---------------------------------------------------------------------------
# set-up: the full-width bat meta and seeded params with a density blob
# ---------------------------------------------------------------------------

def bat_train_hp():
    return trainer.TrainHP.from_cfg(load_config(str(CONFIG)))


def bat_meta():
    cfg = load_config(str(CONFIG))
    aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                     np.asarray(cfg.nvfi.bbox_z)], axis=-1)
    grid = n_to_reso(int(cfg.nvfi.N_voxel_final), aabb)
    meta = kplane.meta_from_cfg(cfg.nvfi, aabb, grid, (cfg.dataset.near, cfg.dataset.far))
    return kplane.eval_exact_meta(meta), bool(cfg.dataset.white_background)


def bat_params(meta, device):
    """Random seeded weights, then a smooth density blob written into the
    density channels of the space planes (an untrained field is empty, which
    would leave compositing and masking unexercised) and a mild seeded
    variation over the time planes."""
    gen = torch.Generator().manual_seed(SEED)
    params = kplane.init_params(gen, meta, device=device)
    rng = np.random.RandomState(SEED)
    cd = meta.density_n_comp
    # per channel a^3 exp(-|x|^2 / s^2) over the three planes; 24 channels sum
    # to ~20 at the centre, so sigma = softplus(feature - 10) is ~10 there
    amp = (20.0 / cd) ** (1.0 / 3.0) * rng.uniform(0.9, 1.1, cd)
    for i, (m0, m1) in enumerate(kplane.MAT_SPACE):
        h, w = meta.grid_size[m1], meta.grid_size[m0]
        v, u = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        blob = np.exp(-(u**2 + v**2) / (2.0 * 0.45**2))[..., None] * amp
        params["planes_space"][i][..., :cd] = torch.tensor(blob, dtype=torch.float32,
                                                             device=device)
    for p in params["planes_time"]:
        p.mul_(torch.tensor(1.0 + 0.02 * rng.randn(*p.shape), dtype=torch.float32,
                            device=p.device))
    return params


def look_at(radius, azimuth, elevation):
    c = radius * np.array([np.sin(azimuth) * np.cos(elevation), np.sin(elevation),
                           np.cos(azimuth) * np.cos(elevation)])
    z = c / np.linalg.norm(c)  # the camera looks down -z (OpenGL)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(z, x), z, c
    return pose


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")
    print("[env] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    return card


def phase_build():
    info = kernels.build(verbose=True)
    kernels.load()
    print(f"[build] {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")) \
                or line.startswith("=="):
            print(f"[build]   {line.strip()}")


def ray_ordered_xyzt(meta, o, d, t, device):
    """The samples of one render chunk as render_rays builds them at a
    keyframe time t (the advected positions are discarded there): (N*S, 4),
    ray-major."""
    o = torch.as_tensor(o, dtype=torch.float32, device=device)
    d = torch.as_tensor(d, dtype=torch.float32, device=device)
    pts, _, _ = kplane.sample_ray(meta, o, d, meta.n_samples)
    xyz = kplane.normalize_coord(meta, pts)
    tt = torch.full((*xyz.shape[:-1], 1), t, dtype=torch.float32, device=device)
    base = kplane.snap_to_keyframe(meta, tt)
    require(bool(torch.isclose(tt, base).all()), f"t={t} is not a keyframe time")
    return torch.cat([xyz, kplane.normalize_time(meta, base)], -1).reshape(-1, 4).contiguous()


def grid_ordered_xyzt(meta, t, chunk_index, device):
    """One chunk of the mask sweep's points, as compute_dense_alpha orders
    them (z fastest), at a keyframe time t: (ALPHA_CHUNK, 4)."""
    grid = tuple(min(g, 200) for g in meta.grid_size)
    a = meta.aabb_np
    lin = [np.linspace(0.0, 1.0, g, dtype=np.float32) for g in grid]
    mesh = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1).reshape(-1, 3)
    part = mesh[chunk_index * ALPHA_CHUNK:(chunk_index + 1) * ALPHA_CHUNK]
    xyz = (((a[0] * (1 - part) + a[1] * part) - a[0]) * (2.0 / (a[1] - a[0])) - 1.0)
    xyz = torch.tensor(xyz.astype(np.float32), device=device)
    base = kplane.snap_to_keyframe(meta, torch.full((xyz.shape[0], 1), t, device=device))
    return torch.cat([xyz, kplane.normalize_time(meta, base)], -1).contiguous()


def grid_sample_library(planes, xyzt, cd, density_only):
    """Library yardstick of K1/K1d (never called by the port): six
    F.grid_sample on (1, C, H, W) planes, the product chain and the density
    sum; with density_only on the density channels alone."""
    P = xyzt.shape[0]
    planes_nchw = [(p[..., :cd] if density_only else p).permute(2, 0, 1)[None].contiguous()
                   for p in planes]
    pairs = list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)
    grids = [torch.stack([xyzt[:, a], xyzt[:, b]], -1).view(1, P, 1, 2) for a, b in pairs]

    def library():
        s = [F.grid_sample(p, g, align_corners=True, padding_mode="zeros")[0, :, :, 0]
             for p, g in zip(planes_nchw, grids)]
        f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5])
        return f.sum(0) if density_only else (f[:cd].sum(0), f[cd:])

    return library


def plane_product_alone(ps, pt, xyzt, cd, density_only):
    """K1 or K1d launched straight from the library on checked tensors, with
    the wrapper's plan: the kernel's time without the wrapper's host work."""
    planes = list(ps) + list(pt)
    P, C = xyzt.shape[0], planes[0].shape[-1]
    plan = grid_sample.plane_product_plan(C, cd, [p.data_ptr() for p in planes])
    density = torch.empty(P, device=xyzt.device)
    app = torch.empty(P, C - cd, device=xyzt.device)
    hw = (ctypes.c_int * 12)(*[int(n) for p in planes for n in p.shape[:2]])
    head = (*[p.data_ptr() for p in planes], hw, xyzt.data_ptr(), P, C, cd, plan.vec, plan.run,
            plan.smem_bytes)
    lib, stream = kernels.load(), kernels.stream_ptr(xyzt.device)
    # the lambdas hold the output tensors, not only their pointers
    if density_only:
        return lambda: lib.nvfi_plane_product_density_fwd(*head, density.data_ptr(), stream)
    return lambda: lib.nvfi_plane_product_fwd(*head, density.data_ptr(), app.data_ptr(), stream)


def k1_at(tag, ps, pt, xyzt, cd):
    """K1 against its plain version on these coords, and its times."""
    P, C = xyzt.shape[0], ps[0].shape[-1]
    got = grid_sample.plane_product(ps, pt, xyzt, cd)
    want = grid_sample.plane_product_reference(ps, pt, xyzt, cd)
    torch.cuda.synchronize()
    check_close(f"K1 plane_product ({tag})", got, want, rtol=1e-5, atol_rel=1e-5)  # FMA
    err = max_err(got, want)
    del got, want
    ms = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd))
    alone_ms = time_ms(plane_product_alone(ps, pt, xyzt, cd, False))
    plain_ms = time_ms(lambda: grid_sample.plane_product_reference(ps, pt, xyzt, cd))
    library_ms = time_ms(grid_sample_library(list(ps) + list(pt), xyzt, cd, False))
    n_bytes = sum(p.numel() * 4 for p in list(ps) + list(pt)) + P * 16 + P * 4 + P * (C - cd) * 4
    n_ops = P * (6 * 7 * C + 5 * C + cd + 6 * 20)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    outside = float((xyzt[:, :3].abs() > 1).any(-1).float().mean())
    print(f"[K1] {tag}: P={P} C={C} (share of samples outside the box {outside:.3f}) "
          f"max_abs_err={err:.3e} kernel {ms:.4f} ms ({alone_ms:.4f} alone), plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} GFLOP); kernel / library {ms / library_ms:.3f}, bound / kernel "
          f"{b_ms / ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "kernel_to_library": ms / library_ms}


def phase_k1(meta, params, o, d, device):
    """K1 at the main-path size, P = 4096 * 686, in three orders: uniform
    coords (neighbours share no cell), the ray-ordered samples of one render
    chunk, and the same samples shuffled (the same cells, without the
    order)."""
    P = CHUNK * meta.n_samples
    rng = np.random.RandomState(SEED + 1)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    plan = grid_sample.plane_product_plan(ps[0].shape[-1], cd,
                                          [p.data_ptr() for p in list(ps) + list(pt)])
    print(f"[K1] launch plan: {plan}")
    require(plan.vec == 4, f"the bat planes did not take the 16-byte path: {plan}")
    xyzt = torch.tensor(rng.uniform(-1.1, 1.1, (P, 4)).astype(np.float32), device=device)
    out = {"uniform": k1_at("uniform coords", ps, pt, xyzt, cd)}
    xyzt = ray_ordered_xyzt(meta, o, d, TIMES[0], device)
    require(xyzt.shape[0] == P, f"ray-ordered shape {tuple(xyzt.shape)}")
    out["ray_ordered"] = k1_at(f"ray-ordered, {CHUNK} rays x {meta.n_samples} at t={TIMES[0]}",
                               ps, pt, xyzt, cd)
    perm = torch.tensor(rng.permutation(P), device=device)
    out["ray_ordered_shuffled"] = k1_at("the same samples shuffled", ps, pt,
                                        xyzt[perm].contiguous(), cd)
    del xyzt, perm
    entry = {"name": "plane_product_fwd", "route": "cuda",
             "source": "nvfi_torch/csrc/plane_product.cu",
             "replaces": "nvfi_tpu/fields/kplane.py:444", "plan": plan.__dict__,
             "ray_ordered": out["ray_ordered"],
             "ray_ordered_shuffled": out["ray_ordered_shuffled"]}
    entry.update(out["uniform"])  # the line's numbers: uniform coords, as in earlier runs
    return entry


def composite_inputs(N, S, step, device):
    rng = np.random.RandomState(SEED + 2)
    sigma = (np.abs(rng.randn(N, S)) * rng.uniform(0.0, 2.0, (N, 1))).astype(np.float32)
    sigma[rng.rand(N, S) < 0.4] = 0.0
    dist = np.full((N, S), step * 25.0, np.float32)
    dist[:, -1] = 0.0
    z = (2.0 + step * np.arange(S, dtype=np.float32))[None].repeat(N, 0)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return [torch.tensor(x, device=device) for x in (sigma, dist, z, rgb)]


def phase_k2(meta, white_bg, device):
    N, S = CHUNK, meta.n_samples
    args = composite_inputs(N, S, meta.step_size, device)
    extra = (meta.raymarch_weight_thres, white_bg, meta.near_far[1])
    got = compositing.composite(*args, *extra)
    want = compositing.composite_reference(*args, *extra)
    torch.cuda.synchronize()
    check_close("K2 composite", got, want, rtol=1e-4, atol_rel=1e-5)  # scan association
    err = max_err(got, want)
    ms = time_ms(lambda: compositing.composite(*args, *extra), reps=50)
    plain_ms = time_ms(lambda: compositing.composite_reference(*args, *extra), reps=20)
    n_above = int((want[0] > meta.raymarch_weight_thres).sum())
    n_bytes = N * S * (4 + 4 + 4 + 12 + 4) + N * (4 + 12 + 4)
    n_ops = N * S * 11 + n_above * 6
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K2] N={N} S={S} max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library none, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB)")
    return {"name": "composite_fwd", "route": "cuda", "source": "nvfi_torch/csrc/composite.cu",
            "replaces": "nvfi_tpu/ops/compositing.py:17", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


TRAIN_RAYS = 128  # rays of one train chunk: batch_size 131072 // 686 samples, dividing n_rays
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5  # K1b: atomics in any order; K2b: scan association
# a train chunk's per-leaf grads, as shares of each leaf's largest grad.  The
# card through the kernels against the card through the plain versions is the
# kernels' share alone (FMA contraction, the scans' association, atomics):
# 3.9e-5 at most on an H100.  Either of them against the CPU is everything
# else of the chunk (cuBLAS against the CPU's GEMMs, the device's exp and
# softplus): 4.2e-4 to 4.4e-4 on the planes and the velocity net, 4e-5 on the
# shader, the same with and without the kernels.  The limits leave about 2.5x.
KERNEL_CHUNK_GRAD_RTOL, KERNEL_CHUNK_GRAD_ATOL_REL = 1e-4, 1e-4
CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL = 1e-3, 1e-3


def plane_grad_inputs(meta, P, device, dense=False):
    """Coords at one keyframe time (every sample of a train chunk shares its
    t) and incoming grads: zero for most samples, as in training, where sigma
    is masked outside the box and rgb_pts under the weight threshold."""
    rng = np.random.RandomState(SEED + 8)
    ca = meta.app_n_comp
    xyzt = rng.uniform(-1.1, 1.1, (P, 4)).astype(np.float32)
    xyzt[:, 3] = 0.4 * 2.0 / meta.tmax - 1.0
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, ca).astype(np.float32)
    if not dense:
        gd *= rng.rand(P) < 0.5
        ga *= (rng.rand(P, 1) < 0.1) & (gd[:, None] != 0)
    return [torch.tensor(x, device=device) for x in (xyzt, gd, ga)]


def phase_k1b(meta, params, device):
    """K1b at the train chunk's shape against its plain backward; its time
    there (masked and dense grads) and at the render shape."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    planes = list(ps) + list(pt)
    C = ps[0].shape[-1]
    P = TRAIN_RAYS * meta.n_samples
    xyzt, gd, ga = plane_grad_inputs(meta, P, device)
    got_planes, got_xyz = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga)
    again, _ = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga, want_xyz=False)
    want_planes, want_xyz = grid_sample.plane_product_backward_reference(ps, pt, xyzt, cd, gd, ga)
    torch.cuda.synchronize()
    got, want = got_planes + [got_xyz], list(want_planes) + [want_xyz]
    check_close("K1b plane_product_bwd", got, want, rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL)
    err = max_err(got, want)
    rerun = max_err(again, got_planes)
    require(bool((got_xyz[:, 3] == 0).all()), "K1b wrote a gradient for the time column")
    active = int(((gd != 0) | (ga != 0).any(-1)).sum())
    print(f"[K1b] P={P} C={C}: {active} samples with a non-zero incoming grad; max_abs_err "
          f"{err:.3e} against the plain backward (rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x "
          f"max|grad|; max |plane grad| {max(float(w.abs().max()) for w in want_planes):.3e}, "
          f"max |grad_xyz| {float(want_xyz.abs().max()):.3e}); two runs of the kernel differ by "
          f"{rerun:.3e} (atomics)")
    del want, want_planes, want_xyz, again
    # the forward at this shape: K1 against its plain version on the same coords
    fwd_got = grid_sample.plane_product(ps, pt, xyzt, cd)
    fwd_want = grid_sample.plane_product_reference(ps, pt, xyzt, cd)
    check_close("K1 plane_product at the train shape", fwd_got, fwd_want, rtol=1e-5,
                atol_rel=1e-5)  # FMA contraction, as in phase K1
    fwd_err = max_err(fwd_got, fwd_want)
    print(f"[K1b] K1 (the forward) at P={P}: max_abs_err {fwd_err:.3e} against its plain version")
    del fwd_got, fwd_want

    def kernel():
        return grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga)

    ms = time_ms(kernel, reps=20)
    fwd_ms = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd), reps=20)
    zero_ms = time_ms(lambda: [torch.zeros_like(p) for p in planes], reps=20)
    no_xyz_ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga,
                                                                   want_xyz=False), reps=20)
    plain_ms = time_ms(lambda: grid_sample.plane_product_backward_reference(ps, pt, xyzt, cd, gd,
                                                                            ga), reps=5)
    # library yardstick (never called by the port): autograd through six
    # F.grid_sample on (1, C, H, W) planes, forward included as in the kernel
    planes_nchw = [p.permute(2, 0, 1)[None].contiguous().requires_grad_(True) for p in planes]
    pairs = list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)
    g_all = torch.cat([gd[None].expand(cd, P), ga.t()]).contiguous()

    def library():
        x = xyzt.detach().requires_grad_(True)
        s = [F.grid_sample(p, torch.stack([x[:, a], x[:, b]], -1).view(1, P, 1, 2),
                           align_corners=True, padding_mode="zeros")[0, :, :, 0]
             for p, (a, b) in zip(planes_nchw, pairs)]
        f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5])
        return torch.autograd.grad(f, planes_nchw + [x], g_all)

    library_ms = time_ms(library, reps=5)
    lib = library()
    lib_err = max(float((lg[0].permute(1, 2, 0) - g).abs().max())
                  for lg, g in zip(lib[:6], got_planes))
    del planes_nchw, lib
    dense = plane_grad_inputs(meta, P, device, dense=True)
    dense_ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, *dense[:1], cd,
                                                                  *dense[1:]), reps=10)
    Pr = CHUNK * meta.n_samples
    big = plane_grad_inputs(meta, Pr, device)
    render_ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, big[0], cd, *big[1:]),
                        reps=5)
    del big, dense
    plane_bytes = sum(p.numel() * 4 for p in planes)
    n_bytes = 2 * plane_bytes + P * (16 + 4 + (C - cd) * 4 + 16)
    n_ops = active * C * (6 * 7 + 12 + 48 + 84)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K1b] kernel {ms:.4f} ms (of which zeroing the six grad planes {zero_ms:.4f} ms; "
          f"without grad_xyz {no_xyz_ms:.4f} ms), plain (forward + autograd) {plain_ms:.4f} ms, "
          f"library (six F.grid_sample + autograd) {library_ms:.4f} ms (its plane grads differ "
          f"from the kernel's by {lib_err:.1e}), bound {b_ms:.4f} ms ({b_by}: "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP); every incoming grad non-zero: "
          f"{dense_ms:.4f} ms; render shape P={Pr}: {render_ms:.4f} ms; K1 (the forward) at "
          f"P={P}: {fwd_ms:.4f} ms")
    return {"name": "plane_product_bwd", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product_bwd.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:444 (its VJP)", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "dense_grads_ms": dense_ms, "render_shape_ms": render_ms, "zeroing_ms": zero_ms,
            "forward_ms_at_this_shape": fwd_ms, "forward_max_abs_err_at_this_shape": fwd_err}


def composite_grad_inputs(N, S, step, device):
    """composite_inputs with rays that miss the box (sigma == 0: rgb == 1
    exactly with a white background, the clip's tie) and saturated samples
    (alpha rounds to 1, the samples behind fall under the threshold)."""
    sigma, dist, z, rgb = composite_inputs(N, S, step, device)
    sigma[: N // 8] = 0.0
    sigma[N // 8: N // 4, S // 3] = 1e3
    rng = np.random.RandomState(SEED + 9)
    grads = [torch.tensor(rng.randn(*shape).astype(np.float32), device=device)
             for shape in ((N, 3), (N,), (N,), (N, S))]
    return [sigma, dist, z, rgb], grads


def phase_k2b(meta, white_bg, device):
    """K2b at the train chunk's shape against its plain backward, all four
    incoming grads present; its time with the train step's (g_rgb alone)."""
    S = meta.n_samples
    thres, far = meta.raymarch_weight_thres, meta.near_far[1]
    out = {}
    for N in (TRAIN_RAYS, CHUNK):
        args, grads = composite_grad_inputs(N, S, meta.step_size, device)
        for bg in (white_bg, not white_bg):
            # the forward as the train step runs it: K2 storing the colour before
            # the clip, all five outputs against the plain version
            fwd = compositing._launch_composite(*args, thres, bg, far, True)
            fwd_want = compositing.composite_reference(*args, thres, bg, far, return_raw=True)
            check_close(f"K2 composite (with rgb_raw) N={N} white_bg={bg}", fwd, fwd_want,
                        rtol=1e-4, atol_rel=1e-5)  # scan association, as in phase K2
            weight, raw = fwd[0], fwd[4]
            if bg == white_bg:
                fwd_err = max_err(fwd, fwd_want)
                require(torch.equal(torch.clamp(raw, 0.0, 1.0), fwd[2]),
                        "K2: rgb is not the clip of rgb_raw")
            got = compositing.composite_backward(*args, weight, raw, *grads, thres, bg, far)
            want = compositing.composite_backward_reference(*args, *grads, thres, bg, far)
            torch.cuda.synchronize()
            # a weight within a last place of the threshold may fall on either
            # side of it in the two versions: leave those samples out
            edge = (weight - thres).abs() <= 1e-6 * thres
            got = [got[0], torch.where(edge[..., None], 0.0, got[1])]
            want = [want[0], torch.where(edge[..., None], 0.0, want[1])]
            check_close(f"K2b composite_bwd N={N} white_bg={bg}", got, want, rtol=GRAD_RTOL,
                        atol_rel=GRAD_ATOL_REL)
            if bg == white_bg:
                err = max_err(got, want)
                ties = int(((raw == 1.0) | (raw == 0.0)).all(-1).sum())
        require(ties >= N // 8, f"K2b: {ties} rays at the clip's tie, want >= {N // 8}")
        g_rgb = grads[0]
        weight, _, _, _, raw = compositing._launch_composite(*args, thres, white_bg, far, True)
        ms = time_ms(lambda: compositing.composite_backward(
            *args, weight, raw, g_rgb, None, None, None, thres, white_bg, far), reps=50)
        plain_ms = time_ms(lambda: compositing.composite_backward_reference(
            *args, g_rgb, None, None, None, thres, white_bg, far), reps=10)
        fwd_ms = time_ms(lambda: compositing.composite(*args, thres, white_bg, far), reps=50)
        # sigma, dist, rgb_pts, weight read (no z without g_depth); rgb_raw, g_rgb; both grads
        n_bytes = N * S * (4 + 4 + 12 + 4) + N * 24 + N * S * 16
        n_ops = N * S * 30
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"[K2b] N={N} S={S}: max_abs_err {err:.3e} against the plain backward (rtol "
              f"{GRAD_RTOL}, atol {GRAD_ATOL_REL} x max|grad|, both backgrounds, {ties} rays at "
              f"the clip's tie); K2 with rgb_raw max_abs_err {fwd_err:.3e}; kernel {ms:.4f} "
              f"ms, plain (forward + autograd) {plain_ms:.4f} "
              f"ms, library none, bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); K2 (the "
              f"forward) at this shape: {fwd_ms:.4f} ms")
        out[N] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "forward_ms_at_this_shape": fwd_ms,
                  "forward_max_abs_err_at_this_shape": fwd_err}
    entry = {"name": "composite_bwd", "route": "cuda",
             "source": "nvfi_torch/csrc/composite_bwd.cu",
             "replaces": "nvfi_tpu/ops/compositing.py:17 (its VJP)", "library_ms": None,
             "render_shape": out[CHUNK]}
    entry.update(out[TRAIN_RAYS])
    return entry


def adv_steps_for(meta, t):
    """render_image's bucket: one RK2 step, or the full render bound."""
    return 1 if kplane.render_steps_for_time(meta, t) == 1 else meta.render_adv_steps


def spread_rays(o, d, n=256):
    """``n`` rays spread evenly over the image, and their flat indices."""
    stride = IMAGE * IMAGE // n
    idx = np.arange(n) * stride + stride // 2
    return o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx], idx


def check_chunk_against_cpu(tag, meta, params, params_cpu, white_bg, o, d, images, device,
                            alpha_state=None):
    """One 256-ray chunk per time, the card against the port on the CPU."""
    co, cd, idx = spread_rays(o, d)
    alpha_cpu = None if alpha_state is None else {k: v.cpu() for k, v in alpha_state.items()}
    for t in TIMES:
        steps = adv_steps_for(meta, t)
        gpu = kplane.render_rays(params, meta, t, co, cd, white_bg=white_bg, adv_steps=steps,
                                 alpha_state=alpha_state, device=device)
        t0 = time.perf_counter()
        cpu = kplane.render_rays(params_cpu, meta, t, co, cd, white_bg=white_bg,
                                 adv_steps=steps, alpha_state=alpha_cpu, device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu = {k: v.cpu() for k, v in gpu.items() if isinstance(v, torch.Tensor)}
        errs = {k: float((gpu[k] - cpu[k]).abs().max()) for k in ("rgb", "acc", "depth")}
        above = float((cpu["weight"] > meta.raymarch_weight_thres).float().mean())
        print(f"[{tag}] t={t}: 256-ray chunk card vs CPU max err {errs}, share of samples "
              f"above rayMarch_weight_thres {above:.4f} (CPU chunk {cpu_s:.1f} s)")
        require(errs["rgb"] <= 1e-4 and errs["acc"] <= 1e-4, f"t={t}: card vs CPU {errs}")
        require(bool(((gpu["depth"] - cpu["depth"]).abs()
                      <= 1e-4 * cpu["depth"].abs()).all()), f"t={t}: depth rtol 1e-4")
        require(above >= 1e-3, f"t={t}: share of samples above threshold {above}")
        acc_img = images[t]["acc"].reshape(-1)[idx]
        require(np.abs(acc_img - gpu["acc"].numpy()).max() <= 1e-4,
                f"t={t}: the chunk disagrees with the image")


def phase_render(meta, params, params_cpu, white_bg, card, o, d, device):
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    # warm-up (cuBLAS handles, allocator) outside the counted main path
    kplane.render_rays(params, meta, TIMES[0], o.reshape(-1, 3)[:CHUNK],
                       d.reshape(-1, 3)[:CHUNK], white_bg=white_bg, adv_steps=1, device=device)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    images, per_image = {}, []
    for t in TIMES:
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images[t] = render_image(params, meta, t, o, d, white_bg=white_bg, chunk=CHUNK,
                                 device=device)
        sec = time.perf_counter() - t0
        after = read_counts()
        per_image.append((t, sec, after["plane_product_fwd"] - before["plane_product_fwd"],
                          after["composite_fwd"] - before["composite_fwd"],
                          torch.cuda.max_memory_allocated() / 2**30))
    launches = read_counts()
    # ------------------------------------------------------------------------

    for (t, sec, n1, n2, mem), img in zip(per_image, images.values()):
        share = float((img["acc"] > 0.5).mean())
        print(f"[render] t={t}: {IMAGE}x{IMAGE} in {sec:.3f} s = {IMAGE * IMAGE / sec:.0f} rays/s "
              f"({adv_steps_for(meta, t)} RK2 steps, {n1} K1 / {n2} K2 launches, peak "
              f"{mem:.2f} GiB) acc>0.5 share {share:.4f}, mean rgb "
              f"{float(img['rgb'].mean()):.4f} [{card}]")
        for k in ("rgb", "depth", "acc"):
            require(np.isfinite(img[k]).all(), f"t={t}: non-finite {k}")
        require(0.05 <= share <= 0.95, f"t={t}: share of rays with acc > 0.5 is {share}")
        require(n1 == n_chunks and n2 == n_chunks,
                f"t={t}: launches K1 {n1}, K2 {n2}, want {n_chunks} each")
    require(not np.allclose(images[TIMES[0]]["rgb"], images[TIMES[2]]["rgb"]),
            "renders at different times are identical")
    require(all(launches[k] == 0 for k in launches
                if k not in ("plane_product_fwd", "composite_fwd")),
            f"the unmasked render launched another kernel: {launches}")
    check_chunk_against_cpu("render", meta, params, params_cpu, white_bg, o, d, images, device)
    return launches, images


def k1d_at(tag, ps, pt, xyzt, cd):
    """K1d against its plain version and K1's density on these coords, and
    its times."""
    P, C = xyzt.shape[0], ps[0].shape[-1]
    got = grid_sample.plane_product_density(ps, pt, xyzt, cd)
    want = grid_sample.plane_product_reference(ps, pt, xyzt, cd, density_only=True)
    full = grid_sample.plane_product(ps, pt, xyzt, cd)[0]
    torch.cuda.synchronize()
    check_close(f"K1d plane_product_density ({tag})", [got], [want], rtol=1e-5,
                atol_rel=1e-5)  # FMA
    require(torch.equal(got, full), f"K1d ({tag}) differs from K1's density output: max "
            f"{float((got - full).abs().max()):.3e}")
    err = max_err([got], [want])
    del got, full
    ms = time_ms(lambda: grid_sample.plane_product_density(ps, pt, xyzt, cd), reps=50)
    alone_ms = time_ms(plane_product_alone(ps, pt, xyzt, cd, True), reps=50)
    plain_ms = time_ms(
        lambda: grid_sample.plane_product_reference(ps, pt, xyzt, cd, density_only=True))
    library_ms = time_ms(grid_sample_library(list(ps) + list(pt), xyzt, cd, True))
    n_bytes = sum(p.numel() // C * cd * 4 for p in list(ps) + list(pt)) + P * 16 + P * 4
    n_ops = P * (6 * 7 * cd + 5 * cd + cd + 6 * 20)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K1d] {tag}: P={P} Cd={cd} of C={C} max_abs_err={err:.3e}, equal to K1's density "
          f"bit for bit; kernel {ms:.4f} ms ({alone_ms:.4f} alone), plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP); "
          f"kernel / library {ms / library_ms:.3f}")
    return want, {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": library_ms, "kernel_to_library": ms / library_ms}


def phase_k1d(meta, params, device):
    """K1d at the mask sweep's shape (uniform coords, and the grid-ordered
    middle chunk of the sweep) and at the train step's."""
    P = ALPHA_CHUNK
    rng = np.random.RandomState(SEED + 3)
    xyzt = torch.tensor(rng.uniform(-1.1, 1.1, (P, 4)).astype(np.float32), device=device)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    want, uniform = k1d_at("uniform coords", ps, pt, xyzt, cd)
    # the train step's shapes: the PDE filter's two time strata (vel_reg_n_pts
    # split at tmax) and, on the pruned step, the two strata of the budget
    full = grid_sample.plane_product(ps, pt, xyzt, cd)[0]
    hp = bat_train_hp()
    n1 = int(round(hp.vel_reg_n_pts * meta.tmax))
    b1 = int(round(hp.vel_occupied_budget * meta.tmax))
    sizes = (n1, hp.vel_reg_n_pts - n1, b1, hp.vel_occupied_budget - b1)
    errs = {}
    for n in sizes:
        part = grid_sample.plane_product_density(ps, pt, xyzt[:n].contiguous(), cd)
        check_close(f"K1d plane_product_density P={n}", [part], [want[:n]], rtol=1e-5,
                    atol_rel=1e-5)
        require(torch.equal(part, full[:n]), f"K1d at P={n} differs from K1's density output")
        errs[n] = max_err([part], [want[:n]])
    print(f"[K1d] the train step's shapes (PDE strata, pruned budget strata), max_abs_err "
          f"against the plain version: {errs}")
    del want, full
    n_chunks = -(-int(np.prod([min(g, 200) for g in meta.grid_size])) // ALPHA_CHUNK)
    grid_xyzt = grid_ordered_xyzt(meta, TIMES[0], n_chunks // 2, device)
    _, grid = k1d_at(f"grid-ordered chunk {n_chunks // 2} of {n_chunks} of the sweep at "
                     f"t={TIMES[0]}", ps, pt, grid_xyzt, cd)
    entry = {"name": "plane_product_density_fwd", "route": "cuda",
             "source": "nvfi_torch/csrc/plane_product.cu",
             "replaces": "nvfi_tpu/fields/kplane.py:513", "grid_ordered": grid,
             "train_shapes_max_abs_err": {str(n): e for n, e in errs.items()}}
    entry.update(uniform)  # the line's numbers: uniform coords, as in earlier runs
    return entry


def phase_k5(meta, device):
    """K5: the two Pallas probes' gather as a path of its own, then the kernel
    against its plain version there and at the block-sparse pick shape."""
    rng = np.random.RandomState(SEED + 4)
    block = 64
    n_blocks = CHUNK * -(-meta.n_samples // block)  # blocks of one 4096-ray chunk
    shapes = {
        "probe": (torch.ones(512, 128), (torch.arange(1024) % 512).to(torch.int32)),
        "pick": (torch.tensor(rng.randn(n_blocks, block * 3).astype(np.float32)),
                 torch.tensor(rng.permutation(n_blocks)[: n_blocks // 2].astype(np.int32))),
    }
    # -- the probe's path: counts set to 0 just before, read just after -----
    # what tests/test_mosaic_probe.py and scripts/perf_micro2.py ask of the
    # TPU toolchain: gather 1024 rows of a (512, 128) table of ones and sum
    reset_counts()
    tab, idx = (x.to(device) for x in shapes["probe"])
    total = float(gather.row_gather(tab, idx).sum())
    launches = read_counts()
    # ------------------------------------------------------------------------
    print(f"[K5] row-gather probe: OK, sum={total}")
    require(total == 1024 * 128, f"probe sum {total}")
    require(launches["row_gather_fwd"] == 1, f"probe launches {launches}")

    out = {}
    for name, (tab, idx) in shapes.items():
        tab, idx = tab.to(device), idx.to(device)
        got = gather.row_gather(tab, idx)
        want = gather.row_gather_reference(tab, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K5 {name}: the gather is not exact")  # a copy
        idx64 = idx.long()
        out_buf = torch.empty(idx.shape[0], tab.shape[1], device=device)
        lib, stream = kernels.load(), kernels.stream_ptr(device)
        alone_ms = time_ms(lambda: lib.nvfi_row_gather_fwd(  # checked above: no wrapper
            tab.data_ptr(), idx.data_ptr(), idx.shape[0], tab.shape[1], out_buf.data_ptr(),
            stream), reps=50)
        require(torch.equal(out_buf, want), f"K5 {name}: the kernel alone is not exact")
        ms = time_ms(lambda: gather.row_gather(tab, idx), reps=50)
        plain_ms = time_ms(lambda: gather.row_gather_reference(tab, idx), reps=50)
        library_ms = time_ms(lambda: torch.index_select(tab, 0, idx64), reps=50)
        n, C = idx.shape[0], tab.shape[1]
        n_bytes = n * C * 4 + int(torch.unique(idx).numel()) * C * 4 + n * 4
        b_ms, b_by = bound_ms(n_bytes, 0)
        print(f"[K5] {name}: {n} rows of {C} from {tab.shape[0]} rows, exact; kernel {ms:.4f} ms "
              f"through the wrapper (its index-range check reads two numbers back to the "
              f"host), {alone_ms:.4f} ms alone, plain {plain_ms:.4f} ms, library "
              f"(index_select) {library_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {n_bytes / 1e6:.2f} MB)")
        out[name] = {"ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": [n, tab.shape[0], C]}
    entry = {"name": "row_gather_fwd", "route": "cuda", "source": "nvfi_torch/csrc/row_gather.cu",
             "replaces": "tests/test_mosaic_probe.py:35, scripts/perf_micro2.py:86",
             "max_abs_err": 0.0, "probe_shape": out["probe"], "pick_shape": out["pick"]}
    # the line's numbers are the probe's (the shape its path runs)
    entry.update({k: out["probe"][k] for k in ("ms", "kernel_alone_ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")})
    return launches, entry


def phase_alpha(meta, params, params_cpu, card, device):
    """The mask build at full width (the first half of render_split)."""
    grid = tuple(min(g, 200) for g in meta.grid_size)
    n_chunks = -(-int(np.prod(grid)) // ALPHA_CHUNK)

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alpha_state, new_aabb = kplane.update_alpha_mask(params, meta, grid, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    # ------------------------------------------------------------------------

    vol = alpha_state["volume"]
    share = float(vol.mean())
    n_k1d = launches["plane_product_density_fwd"]
    n_one = sum(1 for i in range(ALPHA_TIMES) if i / ALPHA_TIMES <= meta.tmax + 1e-6)
    evals = int(np.prod(grid)) * 2 * (n_one * meta.snap_steps
                                      + (ALPHA_TIMES - n_one) * meta.render_adv_steps)
    print(f"[alpha] update_alpha_mask {grid} x {ALPHA_TIMES} times in {sec:.3f} s "
          f"({n_k1d} K1d launches = {ALPHA_TIMES} x {n_chunks} chunks of {ALPHA_CHUNK}; "
          f"{evals / 1e9:.3f} G velocity point-evaluations, {sec / evals * 1e9:.3f} ns each; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) [{card}]")
    print(f"[alpha] occupied share of the volume {share:.4f}, dilated "
          f"{float(alpha_state['dilated'].mean()):.4f}, new_aabb {new_aabb.tolist()}")
    require(n_k1d == ALPHA_TIMES * n_chunks, f"K1d launches {n_k1d}, want "
            f"{ALPHA_TIMES * n_chunks}")
    require(all(v == 0 for k, v in launches.items() if k != "plane_product_density_fwd"),
            f"the mask build launched another kernel: {launches}")
    require(tuple(vol.shape) == grid[::-1] and vol.is_contiguous(), f"volume {vol.shape}")
    require(0.0 < share < 1.0, f"occupied share {share}")
    require(bool(((vol == 0) | (vol == 1)).all()), "the volume is not binary")
    require(bool((alpha_state["dilated"] >= vol).all()), "dilated is not a superset")
    require(np.isfinite(new_aabb).all() and (new_aabb[1] > new_aabb[0]).all()
            and (new_aabb[0] >= meta.aabb_np[0]).all() and (new_aabb[1] <= meta.aabb_np[1]).all(),
            f"new_aabb {new_aabb}")

    # one chunk of the sweep per step bucket against the port on the CPU;
    # tolerance: the velocity MLP's f32 sums differ (cuBLAS vs the CPU), the
    # advected position moves in its last places and alpha follows the density
    rng = np.random.RandomState(SEED + 5)
    xyz = torch.tensor(rng.uniform(-1, 1, (ALPHA_CHUNK, 3)).astype(np.float32))
    for t in (TIMES[0], TIMES[2]):
        steps = meta.snap_steps if t <= meta.tmax + 1e-6 else meta.render_adv_steps
        gpu = kplane.dense_alpha_chunk(params, meta, xyz.to(device), t, steps).cpu()
        t0 = time.perf_counter()
        cpu = kplane.dense_alpha_chunk(params_cpu, meta, xyz, t, steps)
        cpu_s = time.perf_counter() - t0
        err = float((gpu - cpu).abs().max())
        bad = int(((gpu - cpu).abs() > 1e-5 + 1e-3 * cpu.abs()).sum())
        flips = int(((gpu >= meta.alpha_mask_thres) != (cpu >= meta.alpha_mask_thres)).sum())
        print(f"[alpha] t={t} ({steps} steps): {ALPHA_CHUNK}-point chunk card vs CPU max err "
              f"{err:.3e} (atol 1e-5, rtol 1e-3), {flips} points on the other side of "
              f"alphaMask_thres, share above it {float((cpu >= meta.alpha_mask_thres).float().mean()):.4f} "
              f"(CPU chunk {cpu_s:.1f} s)")
        require(bad == 0 and bool(torch.isfinite(gpu).all()), f"t={t}: {bad} alphas off")
    return launches, alpha_state, new_aabb


def mask_kernel_inputs(meta, alpha_state, new_aabb, device):
    """4096*686 coords in [-1.1, 1.1] and the built mask in the shrunk box."""
    P = CHUNK * meta.n_samples
    rng = np.random.RandomState(SEED + 6)
    xyz = torch.tensor(rng.uniform(-1.1, 1.1, (P, 3)).astype(np.float32), device=device)
    box = torch.tensor(np.asarray(new_aabb, np.float32), device=device)
    require(bool((box != alpha_state["aabb"]).any()), "the shrunk box equals the model aabb")
    return xyz, box


def phase_k3(meta, alpha_state, new_aabb, device):
    vol = alpha_state["volume"]
    xyz, box = mask_kernel_inputs(meta, alpha_state, new_aabb, device)
    P, a = xyz.shape[0], meta.aabb_np
    got = occupancy.occupancy_trilinear(vol, xyz, a, box)
    want = occupancy.occupancy_trilinear_reference(vol, xyz, a, box)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the kernel rounds each step as the plain version does; 1e-6 allows a
    # last-place difference in the eight-term sum of values in [0, 1]
    require(err <= 1e-6 and bool(torch.isfinite(got).all()), f"K3 max err {err:.3e} > 1e-6")
    flips = int(((got > 0) != (want > 0)).sum())
    print(f"[K3] (> 0) differs from the plain version on {flips} of {P} samples "
          f"(share {flips / P:.2e}, limit 1e-6); share kept {float((want > 0).float().mean()):.4f}")
    require(flips <= 1e-6 * P, f"K3: {flips} samples flip")
    ms = time_ms(lambda: occupancy.occupancy_trilinear(vol, xyz, a, box), reps=50)
    plain_ms = time_ms(lambda: occupancy.occupancy_trilinear_reference(vol, xyz, a, box), reps=5)
    # library yardstick (never called by the port): the function K3 computes,
    # the affine map into the mask's box and one 5-D F.grid_sample; the
    # F.grid_sample alone on coords that already went through the map beside it
    grid5 = occupancy.to_mask_coords(xyz, a, box).view(1, P, 1, 1, 3)
    vol5 = vol[None, None]
    library_ms = time_ms(lambda: F.grid_sample(
        vol5, occupancy.to_mask_coords(xyz, a, box).view(1, P, 1, 1, 3), align_corners=True,
        padding_mode="zeros"))
    grid_sample_ms = time_ms(lambda: F.grid_sample(vol5, grid5, align_corners=True,
                                                   padding_mode="zeros"))
    lib_err = float((F.grid_sample(vol5, grid5, align_corners=True, padding_mode="zeros")
                     .view(P) - want).abs().max())
    n_bytes = P * 12 + P * 4 + vol.numel() * 4
    n_ops = P * (3 * 12 + 8 * 5)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K3] P={P} volume {tuple(vol.shape)} max_abs_err={err:.3e} kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (to_mask_coords + F.grid_sample; "
          f"F.grid_sample alone {grid_sample_ms:.4f} ms, max diff from plain {lib_err:.1e}), "
          f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB); kernel / library "
          f"{ms / library_ms:.3f}")
    return {"name": "occupancy_trilinear_fwd", "route": "cuda",
            "source": "nvfi_torch/csrc/occupancy.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:1039", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "grid_sample_alone_ms": grid_sample_ms}


def phase_k4(meta, alpha_state, new_aabb, device):
    vol, dil = alpha_state["volume"], alpha_state["dilated"]
    xyz, box = mask_kernel_inputs(meta, alpha_state, new_aabb, device)
    P, a = xyz.shape[0], meta.aabb_np
    got = occupancy.occupancy_nearest(dil, xyz, a, box)
    want = occupancy.occupancy_nearest_reference(dil, xyz, a, box)
    tri = occupancy.occupancy_trilinear(vol, xyz, a, box) > 0
    torch.cuda.synchronize()
    wrong = int((got != want).sum())
    require(wrong == 0, f"K4: {wrong} of {P} samples differ from the plain version")  # exact
    require(bool((got | ~tri).all()), "K4 dropped a sample that trilinear > 0 keeps")
    extra = int((got & ~tri).sum())
    out = {}
    # the render chunk's shape (for the record, beside K3) and the pruned
    # train step's two: the PDE prefilter's points and one train chunk of samples
    for name, pts in (("render", xyz), ("prefilter", xyz[: bat_train_hp().vel_reg_n_pts]),
                      ("train", xyz[: TRAIN_RAYS * meta.n_samples])):
        n = pts.shape[0]
        require(bool((occupancy.occupancy_nearest(dil, pts, a, box) == want[:n]).all()),
                f"K4 at the {name} shape differs from the plain version")
        ms = time_ms(lambda: occupancy.occupancy_nearest(dil, pts, a, box), reps=50)
        plain_ms = time_ms(lambda: occupancy.occupancy_nearest_reference(dil, pts, a, box), reps=5)
        n_bytes = n * 12 + n + dil.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, n * (3 * 12 + 8))
        print(f"[K4] {name} shape P={n} exact; a superset of trilinear > 0 ({extra} samples more "
              f"of {P}, share kept {float(want.float().mean()):.4f}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}: "
              f"{n_bytes / 1e6:.1f} MB)")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    entry = {"name": "occupancy_nearest_fwd", "route": "cuda",
             "source": "nvfi_torch/csrc/occupancy.cu",
             "replaces": "nvfi_tpu/fields/kplane.py:1056", "max_abs_err": 0.0,
             "library_ms": None, "render_shape": out["render"],
             "prefilter_shape": out["prefilter"]}
    entry.update(out["train"])  # the line's numbers are the train chunk's (the shape its path runs)
    return entry


def phase_split(meta, params, params_cpu, white_bg, card, pose, o, d, unmasked, alpha_state,
                device):
    """render_split over three views with the mask; ground truth = the
    unmasked renders, so the metrics say what the mask changes."""
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    names = ("plane_product_fwd", "composite_fwd", "occupancy_trilinear_fwd")
    dataset = ({"test": np.stack([unmasked[t]["rgb"] for t in TIMES])},
               {"test": np.stack([pose] * len(TIMES))}, {"test": np.asarray(TIMES)},
               {"test": len(TIMES)}, None, None, (IMAGE, IMAGE, FOCAL))
    frames, images = [], {}
    inner = harness.render_image

    def timed_render_image(p, m, t, *args, **kwargs):
        before = read_counts()
        t0 = time.perf_counter()
        images[t] = inner(p, m, t, *args, **kwargs)
        after = read_counts()
        frames.append((t, time.perf_counter() - t0, [after[k] - before[k] for k in names]))
        return images[t]

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    harness.render_image = timed_render_image  # per-frame times and counts
    try:
        t0 = time.perf_counter()
        preds, errors = harness.render_split(params, meta, dataset, "test", white_bg=white_bg,
                                             alpha_state=alpha_state, chunk=CHUNK, device=device)
        sec = time.perf_counter() - t0
    finally:
        harness.render_image = inner
    launches = read_counts()
    # ------------------------------------------------------------------------

    for t, fsec, counts in frames:
        print(f"[split] t={t}: {IMAGE}x{IMAGE} in {fsec:.3f} s = {IMAGE * IMAGE / fsec:.0f} rays/s "
              f"with the mask ({adv_steps_for(meta, t)} RK2 steps, K1/K2/K3 launches "
              f"{counts}) [{card}]")
        require(counts == [n_chunks] * 3, f"t={t}: launches {counts}, want {n_chunks} each")
    t0 = time.perf_counter()  # the same frame without the mask, right after, for comparison
    render_image(params, meta, TIMES[0], o, d, white_bg=white_bg, chunk=CHUNK, device=device)
    again = time.perf_counter() - t0
    print(f"[split] t={TIMES[0]} without the mask, right after: {again:.3f} s = "
          f"{IMAGE * IMAGE / again:.0f} rays/s")
    print(f"[split] render_split: {len(TIMES)} views in {sec:.3f} s; masked against unmasked "
          f"renders: {errors}")
    require(preds.shape == (len(TIMES), IMAGE, IMAGE, 3) and np.isfinite(preds).all(),
            f"preds {preds.shape}")
    require(all(np.isfinite(v) for v in errors.values()), f"metrics {errors}")
    require(errors["psnr"] >= PSNR_FLOOR, f"PSNR {errors['psnr']} under {PSNR_FLOOR}")
    require(launches["plane_product_density_fwd"] == 0 and launches["occupancy_nearest_fwd"] == 0
            and launches["row_gather_fwd"] == 0, f"unexpected launches {launches}")

    # the share of samples the mask leaves valid, on 256 rays spread over the frame
    co, cd, _ = spread_rays(o, d)
    co = torch.tensor(co, dtype=torch.float32, device=device)
    cd = torch.tensor(cd, dtype=torch.float32, device=device)
    pts, _, in_box = kplane.sample_ray(meta, co, cd, meta.n_samples)
    kept = in_box & (kplane.sample_alpha(alpha_state, kplane.normalize_coord(meta, pts), meta) > 0)
    print(f"[split] share of samples valid: in the box {float(in_box.float().mean()):.4f}, "
          f"in the box and the mask {float(kept.float().mean()):.4f}")
    require(0.0 < float(kept.float().mean()) < float(in_box.float().mean()),
            "the mask prunes nothing, or everything")
    check_chunk_against_cpu("split", meta, params, params_cpu, white_bg, o, d, images, device,
                            alpha_state=alpha_state)
    return launches


TRAIN_STEPS = 10
PRUNE_STEPS = 3
STEP_LAUNCHES = {"plane_product_fwd": 32, "plane_product_bwd": 32, "composite_fwd": 32,
                 "composite_bwd": 32, "plane_product_density_fwd": 2}


def train_set_up(meta, params, unmasked, pose, device):
    """The two training frames (the unmasked renders at t = 0.4, a keyframe,
    and t = 0.425, within dt_max of it), and start params whose renders
    differ from them: the seeded blob with a re-drawn shader."""
    hp = bat_train_hp()
    frames = (TIMES[0], TIMES[1])
    images = torch.tensor(np.stack([unmasked[t]["rgb"] for t in frames]), device=device)
    poses = torch.tensor(np.stack([pose] * len(frames)), device=device)
    times = torch.tensor(frames, dtype=torch.float32, device=device)
    start = kplane.map_params(lambda x: x.clone(), params)
    gen = torch.Generator().manual_seed(SEED + 10)
    shader = shaders.init_shader(gen, meta.shading_mode, meta.app_dim, meta.view_pe, meta.pos_pe,
                                 meta.fea_pe, meta.feature_c)
    start["shader"] = kplane.map_params(lambda x: x.to(device), shader)
    return hp, start, (poses, images, times)


def grad_tree(params):
    return kplane.map_params(lambda p: p.grad, params)


def as_leaves(params):
    """Make every param a leaf that collects a gradient."""
    for p in optim.tree_leaves(params):
        if p is not None:
            p.requires_grad_(True)


@contextlib.contextmanager
def plain_versions():
    """Inside, render_rays takes the plain versions of K1 and K2 under ordinary
    autograd on any device: the yardstick that separates the kernels' share
    of a difference from the rest of the chunk's (the GEMMs' summation order).
    The port itself never does this on a CUDA tensor."""
    saved = kplane.plane_product, kplane.composite
    kplane.plane_product = grid_sample.plane_product_reference
    kplane.composite = compositing.composite_reference
    try:
        yield
    finally:
        kplane.plane_product, kplane.composite = saved


def check_chunk_grads_against_cpu(meta, params, white_bg, o, d, target, device):
    """Per-leaf grads of one 16-ray chunk of the random-time batch, three ways:
    the card through K1, K1b, K2, K2b; the card through the plain versions; the
    port on the CPU (plain versions).  The first pair differs by the kernels
    alone, the second by everything else (cuBLAS against the CPU's GEMMs)."""
    n = 16
    co, cd, idx = spread_rays(o, d, n)
    tgt = target.reshape(-1, 3)[idx]
    jitter = np.random.RandomState(SEED + 11).rand(n, 1).astype(np.float32)
    cpu = torch.device("cpu")
    grads, rgbs = {}, {}
    for name, dev, plain in (("card", device, False), ("card_plain", device, True),
                             ("cpu", cpu, False)):
        p = kplane.map_params(lambda x: x.detach().to(dev).requires_grad_(True), params)
        count0 = read_counts()
        t0 = time.perf_counter()
        with plain_versions() if plain else contextlib.nullcontext():
            out = kplane.render_rays(p, meta, TIMES[1], co, cd, white_bg=white_bg, training=True,
                                     jitter=jitter, device=dev)
            torch.sum((out["rgb"] - torch.tensor(tgt, device=dev)) ** 2).backward()
        grads[name] = {k: (None if g is None else g.cpu())
                       for k, g in flat_leaves(grad_tree(p)).items()}
        rgbs[name] = out["rgb"].detach().cpu()
        sec = time.perf_counter() - t0
        used = {k: v - count0[k] for k, v in read_counts().items() if v != count0[k]}
        want_used = {} if name != "card" else dict.fromkeys(
            ("plane_product_fwd", "plane_product_bwd", "composite_fwd", "composite_bwd"), 1)
        require(used == want_used, f"chunk grads, {name}: kernel launches {used}")

    def compare(tag, got_name, want_name, rtol, atol_rel):
        """Largest |got - want| per leaf as a share of the leaf's largest
        grad; fails past rtol |want| + atol_rel max|want|."""
        shares, failed = {}, []
        for k, want in grads[want_name].items():
            got = grads[got_name][k]
            require((got is None) == (want is None), f"chunk grads: {k} is missing on one side")
            if want is None:
                continue
            scale = max(float(want.abs().max()), 1e-30)
            bad = (got - want).abs() > atol_rel * scale + rtol * want.abs()
            shares[k] = float((got - want).abs().max()) / scale
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                failed.append(f"{k} ({shares[k]:.2e})")
        worst = max(shares, key=shares.get)
        print(f"[train] grads of one {n}-ray chunk at t={TIMES[1]}, {tag}: {len(shares)} "
              f"leaves, tolerance rtol {rtol} + {atol_rel} x max|grad|; worst {worst} at "
              f"{shares[worst]:.2e} of its largest grad; rgb differs by "
              f"{float((rgbs[got_name] - rgbs[want_name]).abs().max()):.2e}")
        require(not failed, f"chunk grads, {tag}, differ (share of the largest grad): {failed}")
        return shares

    kern = compare("card kernels vs card plain versions", "card", "card_plain",
                   KERNEL_CHUNK_GRAD_RTOL, KERNEL_CHUNK_GRAD_ATOL_REL)
    rest = compare("card plain versions vs CPU", "card_plain", "cpu", CHUNK_GRAD_RTOL,
                   CHUNK_GRAD_ATOL_REL)
    both = compare("card kernels vs CPU", "card", "cpu", CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL)
    print(f"[train]   per leaf, share of its largest grad: kernels vs plain on the card / plain "
          f"on the card vs CPU / kernels vs CPU (CPU chunk {sec:.1f} s)")
    for k in kern:
        print(f"[train]   {k:28s} {kern[k]:.2e} / {rest[k]:.2e} / {both[k]:.2e}  (max |grad| "
              f"{float(grads['cpu'][k].abs().max()):.3e})")


def flat_leaves(tree, prefix=""):
    """path -> leaf of a param-shaped tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in
                flat_leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in
                flat_leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def fixed_loss(loss_fn, params, draws, data, hp, alpha_state=None):
    """The loss on fixed draws at global step 0, without gradient."""
    with torch.no_grad():
        _, metrics = loss_fn(params, draws, 1, 0, 0, *data, hp.L1_weight_initial, 0.0,
                             alpha_state)
    return {k: float(v) for k, v in metrics.items()}


def phase_train(meta, params, white_bg, card, pose, o, d, unmasked, device):
    """Ten full-width static_dynamic train steps."""
    hp, start, data = train_set_up(meta, params, unmasked, pose, device)
    require(hp.white_bg == white_bg and trainer.ray_chunking(meta, hp) == (TRAIN_RAYS, 16),
            f"ray chunking {trainer.ray_chunking(meta, hp)}")
    loss_fn = trainer.make_loss_fn(meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL, device=device)
    train_step = trainer.make_train_step(meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    fixed = trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE)
    before = fixed_loss(loss_fn, start, fixed, data, hp)

    # every grad leaf finite, and non-zero where the JAX package's would be:
    # all but basis_mat_density, which the Density decoder never reads
    as_leaves(start)
    loss_fn(start, fixed, 1, 0, 0, *data, hp.L1_weight_initial, 0.0, None)
    leaves = flat_leaves(grad_tree(start))
    for k, g in leaves.items():
        if k.startswith("basis_mat_density"):
            require(g is None or not bool(g.any()), f"{k} has a gradient")
            continue
        require(g is not None and bool(torch.isfinite(g).all()) and bool(g.any()),
                f"grad of {k} is missing, zero or not finite")
    print(f"[train] {len(leaves)} grad leaves finite and non-zero (basis_mat_density none); "
          f"max |grad|: planes_space/0 {float(leaves['planes_space/0'].abs().max()):.3e}, "
          f"planes_time/0 {float(leaves['planes_time/0'].abs().max()):.3e}, shader/0/w "
          f"{float(leaves['shader/0/w'].abs().max()):.3e}, vel/weight_net/0/w "
          f"{float(leaves['vel/weight_net/0/w'].abs().max()):.3e}, vel/a_weight_net/0/w "
          f"{float(leaves['vel/a_weight_net/0/w'].abs().max()):.3e}")
    check_chunk_grads_against_cpu(meta, start, white_bg, o, d, unmasked[TIMES[1]]["rgb"], device)

    opt_state, counters = optim.init_state(start), trainer.init_counters()
    draws = [trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE) for _ in range(TRAIN_STEPS + 2)]
    train_params = start
    # warm-up step outside the counted path (cuBLAS workspaces, the allocator)
    train_params, opt_state, counters, _ = train_step(train_params, opt_state, counters, draws[0],
                                                      1, 0, 0, *data, hp.L1_weight_initial, 0.0,
                                                      None)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(1, TRAIN_STEPS + 1):
        count0 = read_counts()
        t0 = time.perf_counter()
        train_params, opt_state, counters, metrics = train_step(
            train_params, opt_state, counters, draws[i], 1, 0, i, *data, hp.L1_weight_initial,
            0.0, None)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        count1 = read_counts()
        steps.append((sec, {k: count1[k] - count0[k] for k in count1},
                      {k: float(v) for k, v in metrics.items()}))
    launches = read_counts()
    # ------------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (sec, counts, m) in enumerate(steps, 1):
        print(f"[train] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}, "
              f"vel_pde {m['vel_pde']:.3e}, tv_density {m['tv_density']:.3e}, l1 "
              f"{m['l1']:.4f}, vel_mag {m['vel_mag']:.4f}) [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: metrics {m}")
        want = {k: STEP_LAUNCHES.get(k, 0) for k in counts}
        require(counts == want, f"step {i}: launches {counts}, want {want}")
    secs = [sec for sec, _, _ in steps]
    print(f"[train] {TRAIN_STEPS} steps: median {np.median(secs):.4f} s a step = "
          f"{2 * hp.n_rays / np.median(secs):.0f} rays/s (min {min(secs):.4f}, max "
          f"{max(secs):.4f}); launches a step {steps[0][1]}; peak {peak:.2f} GiB; opt step "
          f"{opt_state['step']} [{card}]")
    after = fixed_loss(loss_fn, train_params, fixed, data, hp)
    print(f"[train] loss on the fixed draws: {before['loss']:.6f} before, {after['loss']:.6f} "
          f"after {TRAIN_STEPS + 1} steps (rgb_t {before['rgb_loss_t']:.6f} -> "
          f"{after['rgb_loss_t']:.6f}, rgb_0 {before['rgb_loss_0']:.6f} -> "
          f"{after['rgb_loss_0']:.6f})")
    require(after["loss"] < before["loss"], "the loss on the fixed draws did not fall")
    # the running max of what render_rays reported in every chunk of every step
    require(counters == trainer.init_counters(), f"a dense step dropped samples: {counters}")

    profile_call("train step (static_dynamic, full width)", lambda: train_step(
        train_params, opt_state, counters, draws[-1], 1, 0, TRAIN_STEPS + 1, *data,
        hp.L1_weight_initial, 0.0, None))
    return launches, hp, train_params, data, {"step_s": float(np.median(secs)),
                                              "rays_per_s": 2 * hp.n_rays / float(np.median(secs))}


def phase_train_prune(meta, hp, params, data, alpha_state, card, device):
    """Three steps with train_occupancy_prune and the mask of the `alpha`
    phase: K4 in each of the 32 chunks and once in the PDE prefilter."""
    pruned_meta = replace(meta, train_occupancy_prune=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    fixed = trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE)
    dense_fn = trainer.make_loss_fn(meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL, device=device)
    pruned_fn = trainer.make_loss_fn(pruned_meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                     use_alpha=True, device=device)
    dense = fixed_loss(dense_fn, params, fixed, data, hp)
    pruned = fixed_loss(pruned_fn, params, fixed, data, hp, alpha_state)
    print(f"[train_prune] loss on the same draws, unpruned / pruned: rgb_t "
          f"{dense['rgb_loss_t']:.6f} / {pruned['rgb_loss_t']:.6f}, rgb_0 "
          f"{dense['rgb_loss_0']:.6f} / {pruned['rgb_loss_0']:.6f}, vel_pde "
          f"{dense['vel_pde']:.3e} / {pruned['vel_pde']:.3e} (another estimator: the mask "
          f"routes the Jacobian budget), loss {dense['loss']:.6f} / {pruned['loss']:.6f}")
    # the band: the mask drops samples under alphaMask_thres at the sweep's
    # times, which moved the frames by PSNR >= 30 dB (mse <= 1e-3) in `split`;
    # the loss is an mse against targets, so it moves by at most
    # 2 sqrt(loss * 1e-3) + 1e-3
    for k in ("rgb_loss_t", "rgb_loss_0"):
        band = 2.0 * np.sqrt(dense[k] * 1e-3) + 1e-3
        require(abs(pruned[k] - dense[k]) <= band, f"{k}: pruned {pruned[k]} vs unpruned "
                f"{dense[k]}, band {band}")
    require(pruned["rgb_loss_t"] != dense["rgb_loss_t"], "the mask pruned nothing")

    train_step = trainer.make_train_step(pruned_meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                         use_alpha=True, device=device)
    opt_state, counters = optim.init_state(params), trainer.init_counters()
    draws = [trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE) for _ in range(PRUNE_STEPS)]
    want = dict(STEP_LAUNCHES, occupancy_nearest_fwd=33)

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    steps = []
    for i in range(PRUNE_STEPS):
        count0 = read_counts()
        t0 = time.perf_counter()
        params, opt_state, counters, metrics = train_step(
            params, opt_state, counters, draws[i], 1, 0, i, *data, hp.L1_weight_initial, 0.0,
            alpha_state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        count1 = read_counts()
        steps.append((sec, {k: count1[k] - count0[k] for k in count1},
                      {k: float(v) for k, v in metrics.items()}))
    launches = read_counts()
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(steps):
        print(f"[train_prune] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}, "
              f"vel_pde {m['vel_pde']:.3e}); K4 launches {counts['occupancy_nearest_fwd']} "
              f"[{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: metrics {m}")
        require(counts == {k: want.get(k, 0) for k in counts},
                f"step {i}: launches {counts}, want {want}")
    return launches


def profile_call(tag, fn):
    """Device-time breakdown of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_rows = torch.autograd.DeviceType.CUDA  # kernels, not the ops that launch them
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == kernel_rows]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    if busy_ms == 0:
        print(f"[profile] {tag}: the profiler saw no device time: not measured")
        return
    print(f"[profile] {tag}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, traced) in "
          f"{sum(e.count for e in rows)} kernel launches")
    for e in sorted(rows, key=lambda e: -_device_us(e))[:10]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")


def phase_profile(meta, params, white_bg, o, d, device):
    """One render chunk and one chunk of the mask sweep per step bucket."""
    rng = np.random.RandomState(SEED + 7)
    xyz = torch.tensor(rng.uniform(-1, 1, (ALPHA_CHUNK, 3)).astype(np.float32), device=device)
    for t in (TIMES[0], TIMES[2]):
        steps = adv_steps_for(meta, t)
        profile_call(f"render chunk, t={t} ({steps} steps)", lambda: kplane.render_rays(
            params, meta, t, o, d, white_bg=white_bg, adv_steps=steps, device=device))
        profile_call(f"mask sweep chunk of {ALPHA_CHUNK} points, t={t} ({steps} steps)",
                     lambda: kplane.dense_alpha_chunk(params, meta, xyz, t, steps))


def _device_us(event):
    """Self device time of a profiler row in us (the attribute was renamed)."""
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else getattr(event, "self_cuda_time_total", 0)


def main():
    t_start = time.perf_counter()
    phase = "env"
    try:
        card = phase_env()
        phase = "build"
        phase_build()
        phase = "set-up"
        device = torch.device("cuda")
        meta, white_bg = bat_meta()
        params = bat_params(meta, device)
        params_cpu = kplane.map_params(lambda x: x.cpu(), params)
        pose = look_at(4.0, 0.6, 0.35)
        o, d = rays.ray_bundle(pose, IMAGE, IMAGE, FOCAL)
        print(f"[set-up] bat: grid {meta.grid_size}, K={meta.num_keyframes}, "
              f"C={meta.density_n_comp}+{meta.app_n_comp}, app_dim {meta.app_dim}, "
              f"n_samples {meta.n_samples}, render_adv_steps {meta.render_adv_steps}, "
              f"vel {meta.vel_hidden} wide, shader {meta.shading_mode} {meta.feature_c} wide")
        phase = "K1"
        mid = IMAGE * IMAGE // 2  # the chunk of rays that phases K1 and profile use
        o_mid, d_mid = o.reshape(-1, 3)[mid:mid + CHUNK], d.reshape(-1, 3)[mid:mid + CHUNK]
        k1 = phase_k1(meta, params, o_mid, d_mid, device)
        phase = "K2"
        k2 = phase_k2(meta, white_bg, device)
        phase = "K1d"
        k1d = phase_k1d(meta, params, device)
        phase = "K5"
        paths = {}
        paths["probe"], k5 = phase_k5(meta, device)
        torch.cuda.empty_cache()
        phase = "render"
        paths["render"], unmasked = phase_render(meta, params, params_cpu, white_bg, card, o, d,
                                                 device)
        phase = "profile"
        phase_profile(meta, params, white_bg, o_mid, d_mid, device)
        phase = "alpha"
        paths["alpha"], alpha_state, new_aabb = phase_alpha(meta, params, params_cpu, card,
                                                            device)
        phase = "K3"
        k3 = phase_k3(meta, alpha_state, new_aabb, device)
        phase = "K4"
        k4 = phase_k4(meta, alpha_state, new_aabb, device)
        phase = "split"
        paths["split"] = phase_split(meta, params, params_cpu, white_bg, card, pose, o, d,
                                     unmasked, alpha_state, device)
        del params_cpu
        phase = "K1b"
        k1b = phase_k1b(meta, params, device)
        phase = "K2b"
        k2b = phase_k2b(meta, white_bg, device)
        phase = "train"
        paths["train"], hp, trained, data, train_numbers = phase_train(
            meta, params, white_bg, card, pose, o, d, unmasked, device)
        phase = "train_prune"
        paths["train_prune"] = phase_train_prune(meta, hp, trained, data, alpha_state, card,
                                                 device)
    except Exception:
        traceback.print_exc()
        print(f"[chip_smoke] FAILED in phase {phase}", file=sys.stderr)
        sys.exit(1)
    entries = [k1, k1b, k1d, k2, k2b, k3, k4, k5]
    for entry in entries:
        entry["launches_by_path"] = {name: counts[entry["name"]] for name, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["launches"] == 0:
            print(f"[chip_smoke] FAILED: {entry['name']} was launched on no main path",
                  file=sys.stderr)
            sys.exit(1)
    print(f"[chip_smoke] train step: {json.dumps(train_numbers)}")
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

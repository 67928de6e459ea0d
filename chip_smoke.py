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
  K2      composite kernel vs composite_reference at (4096, 686) and (128, 686),
          timed through the wrapper and alone
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
  K3      occupancy_trilinear (with the mask's cell bits) vs its plain version
          bit for bit at three inputs: 4096*686 coords in [-1.1, 1.1] with the
          shrunk box as the mask's aabb; the ray-ordered samples of the middle
          4096-ray render chunk at t = 0.4 with the mask as render_split uses
          it; and inside that masked render chunk, traced.  At each the share
          of samples the cell bits skip (every one +0.0 in the plain version),
          kernel / alone / plain / library (to_mask_coords + F.grid_sample) /
          bound times; it follows `alpha` because it is held on the mask
          `alpha` builds
  K4      occupancy_nearest vs its plain version (exact) on the same coords,
          through the wrapper and alone at the render chunk's shape and the
          pruned train step's two; bounds from the distinct 32-byte sectors of
          the dilated volume the samples touch, the whole volume beside them
  split   eval.harness.render_split over three views (the poses and times of
          `render`, whose unmasked images are the ground truth) with the
          mask: rays/s and K1/K2/K3 launches per frame, the share of samples
          the mask leaves valid, PSNR/SSIM against the unmasked renders, and
          one 256-ray chunk per time against the port on the CPU
  K1b     plane_product_bwd kernel vs plane_product_backward_reference at
          the train chunk's shape (128 * 686 samples at one keyframe time) in
          three orders: uniform coords with most incoming grads zero, the
          samples and grads of one real train chunk (recorded from a
          backward of the keyframe batch's first chunk at t = 0.4) and those
          shuffled; at each the kernel (through the wrapper and alone), plain,
          library (autograd through six F.grid_sample) and bound times, the
          share of active samples and the kernel's own count of its global
          atomics; then with every grad non-zero and at the render shape; K1
          vs its plain version at that shape
  K2b     composite_bwd kernel vs composite_backward_reference at (128, 686)
          and (4096, 686), both backgrounds, with rays that miss the box
          (the clip's tie), saturated samples and samples under the threshold,
          its launch plan and its times through the wrapper and alone;
          K2 as the train step runs it (storing the colour before the clip)
          vs its plain version at both shapes, timed through the autograd
          wrapper and alone
  train   ten static_dynamic steps of trainer.make_train_step at full width
          (2 renders x 16 chunks of 128 rays, the PDE loss on 262144 points,
          TV/L1, Adam) against the unmasked frames at t = 0.4 (keyframe
          batch) and t = 0.425 (random-time batch), from params with a
          re-drawn shader: launch counts per step, finite grads that are
          non-zero where they must be, a lower loss on fixed draws, the grads
          of one 16-ray chunk three ways (the card through the kernels, the
          card through the plain versions, the port on the CPU) and the cause
          of the card/CPU gap (the samples whose clamped plane cell differs
          between the two, and the CPU's grads with the card's positions
          there), seconds per step, rays/s and one traced step
  train_prune  three steps with train_occupancy_prune and the mask of `alpha`
          (K4 in every chunk and in the PDE prefilter); pruned against
          unpruned loss on the same draws
Then the bf16 compute mode (meta.compute_dtype = "bfloat16", as bench.py sets
it: the MLPs on bf16-cast params, the bf16 arms of K1, K1d and K1b):
  K1.bf16   the bf16 arm of plane_product vs its plain bf16 version on the
          ray-ordered render chunk and uniform coords: app equal bit for bit,
          the density within its f32 sum; kernel / alone / plain / library
          (six bf16 F.grid_sample) / bound times (bytes, and operations at
          the f32 and at the packed bf16 rate), the launch plan, and the time
          of the bf16 plane copies the arm reads (grid_sample.bf16_planes)
  K1d.bf16  the bf16 arm of the density-only entry on the grid-ordered sweep
          chunk: against its plain version (the chain's last product in f32,
          as JAX's density_feature), and its gap to K1.bf16's density
  render_bf16  the three 400x400 frames in bf16: launches, rays/s beside f32's,
          PSNR against the f32 frames, a 256-ray chunk per time against the
          port on the CPU, a profile of one chunk per step bucket (GEMM ms)
  alpha_bf16  the bf16 mask build (velocity f32, K1d.bf16): seconds, voxels
          that differ from the f32 mask, then one masked bf16 frame
  K1b.bf16  the bf16 arm of plane_product_bwd vs its plain bf16 backward on
          the coords and grads of one real bf16 train chunk: grad_xyzt of two
          launches bit for bit, kernel / alone / alone without grad_xyz /
          plain / library / bound times (the bytes the launch reads: the bf16
          plane copies), the f32 arm alone on the same grads, and the atomic
          counts of both arms
  train_bf16  ten bf16 static_dynamic steps and three pruned ones: launches,
          float32 grads and masters, a lower loss on fixed draws, one 16-ray
          chunk's grads against the card's plain versions and the CPU,
          seconds per step and one traced step; after the steps, the bf16
          plane copies against the stepped planes and K1.bf16 / K1d.bf16 on
          them against their plain versions
The last three lines are the card line from nvidia-smi, the kernels JSON line
(eleven entries: the eight kernels and the three bf16 arms) and the result
line {"ok": true, "device": {...}}.

The numbers it prints are this card's, at its power limit; bounds use the
H100 SXM data-sheet peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 without tensor
cores; the bf16 arms of K1, K1d and K1b, whose arithmetic is packed bf16x2,
at the 133.8 TFLOP/s of bf16 without tensor cores, Hopper white paper).
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
BF16_FLOP_PER_S = 133.8e12  # packed bf16x2 without tensor cores (Hopper white paper)
IMAGE = 400  # bat renders at half resolution
FOCAL = 0.5 * IMAGE / np.tan(0.5 * 0.6911112070083618)  # Blender camera_angle_x
TIMES = (0.4, 0.425, 0.9)
CHUNK = 4096
ALPHA_CHUNK = 262144  # compute_dense_alpha's chunk
ALPHA_TIMES = 60
PSNR_FLOOR = 30.0  # masked against unmasked renders
# every launch counter of the port, by the kernel's name in the kernels line:
# (wrapper, attribute); the bf16 arms of K1, K1d and K1b count apart
COUNTERS = {
    "plane_product_fwd": (grid_sample.plane_product, "launches"),
    "plane_product_density_fwd": (grid_sample.plane_product_density, "launches"),
    "composite_fwd": (compositing.composite, "launches"),
    "occupancy_trilinear_fwd": (occupancy.occupancy_trilinear, "launches"),
    "occupancy_nearest_fwd": (occupancy.occupancy_nearest, "launches"),
    "row_gather_fwd": (gather.row_gather, "launches"),
    "plane_product_bwd": (grid_sample.plane_product_backward, "launches"),
    "composite_bwd": (compositing.composite_backward, "launches"),
    "plane_product_fwd_bf16": (grid_sample.plane_product, "launches_bf16"),
    "plane_product_density_fwd_bf16": (grid_sample.plane_product_density, "launches_bf16"),
    "plane_product_bwd_bf16": (grid_sample.plane_product_backward, "launches_bf16"),
}
BF16 = torch.bfloat16


# the kernel functions of nvfi_torch/csrc, as the profiler names them
PORT_KERNELS = ("plane_product_kernel", "plane_product_bwd_kernel", "composite_fwd_kernel",
                "composite_bwd_kernel", "occupancy_trilinear_fwd_kernel",
                "occupancy_nearest_fwd_kernel", "row_gather_fwd_kernel")


def reset_counts():
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)


def read_counts():
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}


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


def graph_ms(fn, reps=20, replays=10):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed between two CUDA events, the median over ``replays``
    divided by ``reps``.  The graph launches the kernels back to back, so
    the host's cost of a call (Python, ctypes) does not show, as it does in
    :func:`time_ms` where a kernel takes less time than its launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(out))


def bound_ms(n_bytes, n_ops, flop_per_s=F32_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / flop_per_s * 1e3
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


def grid_sample_library(planes, xyzt, cd, density_only, dtype=torch.float32):
    """Library yardstick of K1/K1d (never called by the port): six
    F.grid_sample on (1, C, H, W) planes, the product chain and the density
    sum; with density_only on the density channels alone.  With ``dtype``
    bf16 the planes and grids are cast to bf16 first (not timed): the
    library's bf16 lookup, at the width of K1's bf16 arm, though it rounds
    elsewhere than JAX."""
    P = xyzt.shape[0]
    planes_nchw = [(p[..., :cd] if density_only else p).permute(2, 0, 1)[None]
                   .to(dtype).contiguous() for p in planes]
    pairs = list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)
    grids = [torch.stack([xyzt[:, a], xyzt[:, b]], -1).view(1, P, 1, 2).to(dtype)
             for a, b in pairs]

    def library():
        s = [F.grid_sample(p, g, align_corners=True, padding_mode="zeros")[0, :, :, 0]
             for p, g in zip(planes_nchw, grids)]
        f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5])
        return f.float().sum(0) if density_only else (f[:cd].float().sum(0), f[cd:])

    return library


def plane_product_alone(ps, pt, xyzt, cd, density_only, compute_dtype=torch.float32):
    """K1 or K1d launched straight from the library on checked tensors, with
    the wrapper's plan, in the arm of ``compute_dtype`` (the bf16 arm on the
    planes' bf16 copies, made here once as the wrapper makes them once per
    plane version): the kernel's time without the wrapper's host work."""
    planes = list(ps) + list(pt)
    P = xyzt.shape[0]
    read, C, plan = grid_sample.plane_product_inputs(planes, cd, density_only, compute_dtype)
    density = torch.empty(P, device=xyzt.device)
    app = torch.empty(P, planes[0].shape[-1] - cd, device=xyzt.device, dtype=compute_dtype)
    hw = (ctypes.c_int * 12)(*[int(n) for p in planes for n in p.shape[:2]])
    head = (*[p.data_ptr() for p in read], hw, xyzt.data_ptr(), P, C, cd, plan.vec, plan.run,
            plan.smem_bytes, int(compute_dtype == torch.bfloat16))
    lib, dev = kernels.load(), xyzt.device
    # the lambdas hold the planes read and the outputs, not only their pointers,
    # and take the current stream at call time (graph_ms captures on its own)
    if density_only:
        return lambda _read=read: lib.nvfi_plane_product_density_fwd(
            *head, density.data_ptr(), kernels.stream_ptr(dev))
    return lambda _read=read: lib.nvfi_plane_product_fwd(
        *head, density.data_ptr(), app.data_ptr(), kernels.stream_ptr(dev))


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
    """K2 against its plain version at the render chunk's shape (4096, 686)
    and the train chunk's (128, 686); its times there, through the wrapper
    and alone."""
    S = meta.n_samples
    extra = (meta.raymarch_weight_thres, white_bg, meta.near_far[1])
    out = {}
    for N in (CHUNK, TRAIN_RAYS):
        args = composite_inputs(N, S, meta.step_size, device)
        got = compositing.composite(*args, *extra)
        want = compositing.composite_reference(*args, *extra)
        torch.cuda.synchronize()
        check_close(f"K2 composite N={N}", got, want, rtol=1e-4, atol_rel=1e-5)  # scan association
        err = max_err(got, want)
        ms = time_ms(lambda: compositing.composite(*args, *extra), reps=50)
        alone_ms = graph_ms(lambda: compositing._launch_composite(*args, *extra, False))
        plain_ms = time_ms(lambda: compositing.composite_reference(*args, *extra), reps=20)
        n_above = int((want[0] > meta.raymarch_weight_thres).sum())
        n_bytes = N * S * (4 + 4 + 4 + 12 + 4) + N * (4 + 12 + 4)
        n_ops = N * S * 11 + n_above * 6
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        plan = compositing.composite_plan(N, S, compositing.composite_target_warps(
            args[0].device.index))
        print(f"[K2] N={N} S={S} plan {plan}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
              f"({alone_ms:.4f} alone), plain {plain_ms:.4f} ms, library none, bound "
              f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB)")
        out[N] = {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "plan": plan.__dict__}
    entry = {"name": "composite_fwd", "route": "cuda", "source": "nvfi_torch/csrc/composite.cu",
             "replaces": "nvfi_tpu/ops/compositing.py:17", "library_ms": None,
             "train_shape": out[TRAIN_RAYS]}
    entry.update(out[CHUNK])  # the line's numbers: the render chunk, as in earlier runs
    return entry


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
    """Uniform coords at one keyframe time (every sample of a train chunk
    shares its t) and incoming grads: zero for most samples, as in training,
    where sigma is masked outside the box and rgb_pts under the weight
    threshold."""
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


def train_chunk_grad_inputs(meta, params, white_bg, pose, unmasked, device):
    """K1b's inputs in one real train chunk: the first 128-ray chunk of the
    keyframe batch at t = 0.4, rendered as make_loss_fn renders it (the
    draws' first pixels and jitter, no advection, the train phases' start
    params) and its share of the rgb loss back-propagated.  The coords are
    the forward's; the incoming grads are recorded by hooks on K1's two
    outputs.  Returns (xyzt (P, 4) ray-major, g_density, g_app)."""
    hp, start, (poses, images, _) = train_set_up(meta, params, unmasked, pose, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    draws = trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE)
    pix = draws.pix_0[:TRAIN_RAYS]
    ii, jj = pix // IMAGE, pix % IMAGE
    ray_o, ray_d = trainer._rays_from_pose(poses[0], IMAGE, IMAGE, FOCAL, ii, jj)
    leaves = kplane.map_params(lambda x: x.detach().requires_grad_(True), start)
    seen = {}

    def recording_plane_product(planes_space, planes_time, xyzt, cd, **kw):
        density, app = grid_sample.plane_product(planes_space, planes_time, xyzt, cd, **kw)
        seen["xyzt"] = xyzt.detach()
        density.register_hook(lambda g: seen.__setitem__("gd", g))
        app.register_hook(lambda g: seen.__setitem__("ga", g))
        return density, app

    saved = kplane.plane_product
    kplane.plane_product = recording_plane_product
    try:
        out = kplane.render_rays(leaves, meta, TIMES[0], ray_o, ray_d, white_bg=white_bg,
                                 training=True, advect=False, jitter=draws.jitter_0[0][:TRAIN_RAYS],
                                 bg_coin=None if white_bg else draws.coin_0[0], device=device)
        (torch.sum((out["rgb"] - images[0][ii, jj]) ** 2) / (hp.n_rays * 3)).backward()
    finally:
        kplane.plane_product = saved
    return [seen[k].contiguous() for k in ("xyzt", "gd", "ga")]


def plane_grad_library(planes, xyzt, cd, gd, ga, dtype=torch.float32):
    """Library yardstick of K1b (never called by the port): autograd through
    six F.grid_sample on (1, C, H, W) planes, forward included as in the
    kernel; in ``dtype`` (bf16: planes, grids and grads cast first)."""
    P = xyzt.shape[0]
    planes_nchw = [p.permute(2, 0, 1)[None].to(dtype).contiguous().requires_grad_(True)
                   for p in planes]
    pairs = list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)
    g_all = torch.cat([gd[None].expand(cd, P).to(dtype), ga.t().to(dtype)]).contiguous()

    def library():
        x = xyzt.detach().to(dtype).requires_grad_(True)
        s = [F.grid_sample(p, torch.stack([x[:, a], x[:, b]], -1).view(1, P, 1, 2),
                           align_corners=True, padding_mode="zeros")[0, :, :, 0]
             for p, (a, b) in zip(planes_nchw, pairs)]
        f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5])
        return [g[0].permute(1, 2, 0) if g.dim() == 4 else g
                for g in torch.autograd.grad(f, planes_nchw + [x], g_all)]

    return library


def row_sectors(rows, C, itemsize):
    """Distinct 32-byte sectors that rows of C channels of `itemsize` bytes,
    starting at these element offsets of one array, fall in."""
    start = rows.reshape(-1) * itemsize // 32
    end = ((rows.reshape(-1) + C) * itemsize - 1) // 32
    ids = start[:, None] + torch.arange(-(-C * itemsize // 32) + 1, device=rows.device)
    return int(torch.unique(ids[ids <= end[:, None]]).numel())


def k1b_sector_bytes(planes, xyzt, active, itemsize, weight_dtype):
    """The plane bytes a K1b launch must move on this data: the distinct
    32-byte sectors of the planes (`itemsize` bytes a channel: 4, or 2 for
    the bf16 copies) holding the four corner rows of each active sample's
    cell on each plane, read once, and those of the f32 plane grads holding
    the corner rows it adds to (tent product, in `weight_dtype`, non-zero),
    written once.  Returns (bytes read, bytes written)."""
    C = planes[0].shape[-1]
    x = xyzt[active]
    read = written = 0
    for plane, (a, b) in zip(planes, list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)):
        H, W = plane.shape[:2]
        u = (x[:, a] + 1.0) * 0.5 * (W - 1)
        v = (x[:, b] + 1.0) * 0.5 * (H - 1)
        x0 = torch.clamp(torch.floor(u), 0, W - 2)
        y0 = torch.clamp(torch.floor(v), 0, H - 2)
        wx = [torch.clamp(1.0 - (u - (x0 + i)).abs(), 0.0, 1.0) for i in (0, 1)]
        wy = [torch.clamp(1.0 - (v - (y0 + i)).abs(), 0.0, 1.0) for i in (0, 1)]
        base = (y0 * W + x0).long() * C
        rows = torch.stack([base, base + C, base + W * C, base + (W + 1) * C], -1)
        weights = torch.stack([wy[i] * wx[j] for i in (0, 1) for j in (0, 1)], -1)
        read += row_sectors(rows, C, itemsize)
        written += row_sectors(rows[weights.to(weight_dtype) != 0], C, 4)
    return 32 * read, 32 * written


def k1b_at(tag, ps, pt, xyzt, cd, gd, ga):
    """K1b against its plain backward on these inputs, its atomics and its
    times."""
    planes = list(ps) + list(pt)
    P, C = xyzt.shape[0], ps[0].shape[-1]
    got_planes, got_xyz = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga)
    again, _ = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga, want_xyz=False)
    want_planes, want_xyz = grid_sample.plane_product_backward_reference(ps, pt, xyzt, cd, gd, ga)
    torch.cuda.synchronize()
    got, want = got_planes + [got_xyz], list(want_planes) + [want_xyz]
    check_close(f"K1b plane_product_bwd ({tag})", got, want, rtol=GRAD_RTOL,
                atol_rel=GRAD_ATOL_REL)
    err = max_err(got, want)
    rerun = max_err(again, got_planes)
    require(bool((got_xyz[:, 3] == 0).all()), f"K1b ({tag}) wrote a gradient for the time column")
    scale = (max(float(w.abs().max()) for w in want_planes), float(want_xyz.abs().max()))
    del got, want, want_planes, want_xyz, again
    active = int(((gd != 0) | (ga != 0).any(-1)).sum())
    stats = torch.zeros(3, dtype=torch.int64, device=xyzt.device)
    grads, g_xyzt = grid_sample._zero_plane_grads(planes), torch.empty_like(xyzt)

    def alone(counts=None, want_xyz=True):  # preallocated outputs; the plane grads accumulate
        grid_sample.launch_plane_product_backward(planes, xyzt, cd, gd, ga, grads,
                                                  g_xyzt if want_xyz else None, counts)

    alone(stats)
    atomics, zero_w, merged = (int(v) for v in stats.tolist())
    vec = grid_sample.plane_product_bwd_plan(C, cd, [p.data_ptr() for p in planes]).vec
    updates = active * 24 * (C // vec)
    ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga))
    alone_ms = graph_ms(alone)
    alone_no_xyz_ms = graph_ms(lambda: alone(want_xyz=False))
    plain_ms = time_ms(lambda: grid_sample.plane_product_backward_reference(ps, pt, xyzt, cd, gd,
                                                                            ga), reps=5)
    library = plane_grad_library(planes, xyzt, cd, gd, ga)
    library_ms = time_ms(library, reps=5)
    lib_err = max(float((lg - g).abs().max()) for lg, g in zip(library()[:6], got_planes))
    # the plane sectors this data touches, the grads in, the active samples'
    # coords and grad_xyzt; the whole planes read and written beside it
    live = (gd != 0) | (ga != 0).any(-1)
    read, written = k1b_sector_bytes(planes, xyzt, live, 4, torch.float32)
    n_bytes = read + written + P * (4 + (C - cd) * 4 + 16) + active * 16
    whole_ms, _ = bound_ms(2 * sum(p.numel() * 4 for p in planes) + P * (36 + (C - cd) * 4), 0)
    n_ops = active * C * (6 * 7 + 12 + 48 + 84)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K1b] {tag}: P={P} C={C}, share of samples with a non-zero incoming grad "
          f"{active / P:.4f}; max_abs_err {err:.3e} against the plain backward (rtol {GRAD_RTOL}, "
          f"atol {GRAD_ATOL_REL} x max|grad|; max |plane grad| {scale[0]:.3e}, max |grad_xyz| "
          f"{scale[1]:.3e}); two runs differ by {rerun:.3e} (atomics)")
    print(f"[K1b] {tag}: global atomic instructions {atomics} of {vec} channels, "
          f"{atomics * vec / 8:.0f} 32-byte sectors (unmerged, one scalar atomic an update of "
          f"a channel: {active * 24 * C}, {active * 24 * C / 8:.0f} sectors); of the {updates} "
          f"(sample, plane, corner, group of {vec}) updates {zero_w} have a tent weight of "
          f"exactly 0 (share {zero_w / max(updates, 1):.4f}) and {merged} were folded into "
          f"another sample's atomic (share {merged / max(updates, 1):.4f})")
    print(f"[K1b] {tag}: kernel {ms:.4f} ms ({alone_ms:.4f} alone, {alone_no_xyz_ms:.4f} alone "
          f"without grad_xyz; {atomics * vec / 8 / alone_ms / 1e6:.2f} G sectors/s), plain "
          f"{plain_ms:.4f} ms, "
          f"library (six F.grid_sample + autograd) {library_ms:.4f} ms (its plane grads differ "
          f"by {lib_err:.1e}), bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, of which "
          f"plane sectors read {read / 1e6:.1f} MB and grad sectors written "
          f"{written / 1e6:.1f} MB; {n_ops / 1e9:.2f} GFLOP; {whole_ms:.4f} ms with the whole "
          f"planes and grads); kernel / library {ms / library_ms:.3f}, bound / kernel "
          f"{b_ms / ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
            "kernel_alone_no_xyz_ms": alone_no_xyz_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_whole_planes_ms": whole_ms,
            "library_ms": library_ms,
            "kernel_to_library": ms / library_ms, "active_share": active / P,
            "global_atomics": atomics, "atomic_sectors": atomics * vec // 8,
            "unmerged_atomics": active * 24 * C,
            "zero_weight_updates": zero_w, "merged_updates": merged}


def phase_k1b(meta, params, white_bg, pose, unmasked, device):
    """K1b against its plain backward at the train chunk's shape in three
    orders: uniform coords (as in earlier runs), the real samples and grads of
    one train chunk, and those shuffled; with every grad non-zero; its time at
    the render shape; K1 against its plain version at that shape."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    planes = list(ps) + list(pt)
    C = ps[0].shape[-1]
    P = TRAIN_RAYS * meta.n_samples
    plan = grid_sample.plane_product_bwd_plan(C, cd, [p.data_ptr() for p in planes])
    print(f"[K1b] launch plan: {plan}")
    require(plan.vec == 4, f"the bat planes did not take the 16-byte path: {plan}")
    xyzt, gd, ga = plane_grad_inputs(meta, P, device)
    out = {"uniform": k1b_at("uniform coords", ps, pt, xyzt, cd, gd, ga)}
    # the forward at this shape: K1 against its plain version on the same coords
    fwd_got = grid_sample.plane_product(ps, pt, xyzt, cd)
    fwd_want = grid_sample.plane_product_reference(ps, pt, xyzt, cd)
    check_close("K1 plane_product at the train shape", fwd_got, fwd_want, rtol=1e-5,
                atol_rel=1e-5)  # FMA contraction, as in phase K1
    fwd_err = max_err(fwd_got, fwd_want)
    fwd_ms = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd), reps=20)
    print(f"[K1b] K1 (the forward) at P={P}: max_abs_err {fwd_err:.3e} against its plain "
          f"version, {fwd_ms:.4f} ms")
    del fwd_got, fwd_want
    real = train_chunk_grad_inputs(meta, params, white_bg, pose, unmasked, device)
    require(tuple(real[0].shape) == (P, 4) and bool((real[0][:, 3] == real[0][0, 3]).all())
            and abs(float(real[0][0, 3] - xyzt[0, 3])) < 1e-6,
            f"the train chunk's coords {tuple(real[0].shape)} are not all at t={TIMES[0]}")
    out["real_chunk"] = k1b_at(f"one train chunk, {TRAIN_RAYS} rays x {meta.n_samples} at "
                               f"t={TIMES[0]}, ray-ordered", ps, pt, *real[:1], cd, *real[1:])
    perm = torch.tensor(np.random.RandomState(SEED + 15).permutation(P), device=device)
    out["real_chunk_shuffled"] = k1b_at("the same samples and grads shuffled", ps, pt,
                                        *[x[perm].contiguous() for x in real[:1]], cd,
                                        *[x[perm].contiguous() for x in real[1:]])
    dense = plane_grad_inputs(meta, P, device, dense=True)
    out["dense_grads"] = k1b_at("uniform coords, every incoming grad non-zero", ps, pt,
                                dense[0], cd, *dense[1:])
    zero_ms = time_ms(lambda: grid_sample._zero_plane_grads(planes), reps=20)
    no_xyz_ms = time_ms(lambda: grid_sample.plane_product_backward(
        ps, pt, *real[:1], cd, *real[1:], want_xyz=False), reps=20)
    Pr = CHUNK * meta.n_samples
    big = plane_grad_inputs(meta, Pr, device)
    render_ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, big[0], cd, *big[1:]),
                        reps=5)
    del big, dense
    print(f"[K1b] zeroing the six grad planes (one memset) {zero_ms:.4f} ms; the train chunk "
          f"without grad_xyz {no_xyz_ms:.4f} ms; render shape P={Pr}: {render_ms:.4f} ms")
    entry = {"name": "plane_product_bwd", "route": "cuda",
             "source": "nvfi_torch/csrc/plane_product_bwd.cu",
             "replaces": "nvfi_tpu/fields/kplane.py:444 (its VJP)", "plan": plan.__dict__,
             "real_chunk": out["real_chunk"], "real_chunk_shuffled": out["real_chunk_shuffled"],
             "dense_grads": out["dense_grads"],
             "render_shape_ms": render_ms, "zeroing_ms": zero_ms,
             "forward_ms_at_this_shape": fwd_ms, "forward_max_abs_err_at_this_shape": fwd_err}
    entry.update(out["uniform"])  # the line's numbers: uniform coords, as in earlier runs
    return entry


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
    """K2b at the train chunk's and the render chunk's shape against its plain
    backward, all four incoming grads present, both backgrounds; its time
    with the train step's grads (g_rgb alone), through the wrapper and alone
    (CUDA graphs)."""
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
        alone_ms = graph_ms(lambda: compositing.composite_backward(
            *args, weight, raw, g_rgb, None, None, None, thres, white_bg, far))
        plan = compositing.composite_bwd_plan(N, S, compositing.composite_target_warps(
            args[0].device.index))
        plain_ms = time_ms(lambda: compositing.composite_backward_reference(
            *args, g_rgb, None, None, None, thres, white_bg, far), reps=10)
        fwd_ms = time_ms(lambda: compositing.composite(*args, thres, white_bg, far), reps=50)
        fwd_alone_ms = graph_ms(
            lambda: compositing._launch_composite(*args, thres, white_bg, far, True))
        # sigma, dist, rgb_pts, weight read (no z without g_depth); rgb_raw, g_rgb; both grads
        n_bytes = N * S * (4 + 4 + 12 + 4) + N * 24 + N * S * 16
        n_ops = N * S * 30
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"[K2b] N={N} S={S} plan {plan}: max_abs_err {err:.3e} against the plain "
              f"backward (rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x max|grad|, both backgrounds, "
              f"{ties} rays at the clip's tie); K2 with rgb_raw max_abs_err {fwd_err:.3e}; "
              f"kernel {ms:.4f} ms ({alone_ms:.5f} alone), plain (forward + autograd) {plain_ms:.4f} "
              f"ms, library none, bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); K2 (the "
              f"forward) at this shape: {fwd_ms:.4f} ms through the autograd wrapper, "
              f"{fwd_alone_ms:.4f} ms alone (storing the colour before the clip)")
        out[N] = {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "plan": plan.__dict__, "forward_ms_at_this_shape": fwd_ms,
                  "forward_alone_ms_at_this_shape": fwd_alone_ms,
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
        images[t]["rays_per_s"] = IMAGE * IMAGE / sec
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
    return launches, alpha_state, new_aabb, sec


def mask_kernel_inputs(meta, alpha_state, new_aabb, device):
    """4096*686 coords in [-1.1, 1.1] and the built mask in the shrunk box."""
    P = CHUNK * meta.n_samples
    rng = np.random.RandomState(SEED + 6)
    xyz = torch.tensor(rng.uniform(-1.1, 1.1, (P, 3)).astype(np.float32), device=device)
    box = torch.tensor(np.asarray(new_aabb, np.float32), device=device)
    require(bool((box != alpha_state["aabb"]).any()), "the shrunk box equals the model aabb")
    return xyz, box


def distinct_sectors(flat_index):
    """Distinct 32-byte sectors of a float32 array that these element
    indices fall in."""
    return int(torch.unique(flat_index.reshape(-1) // 8).numel())


def trilinear_sectors(vol, pix):
    """Distinct 32-byte sectors of the volume holding the eight clipped
    corners of every sample: what the trilinear lookup reads."""
    D, H, W = vol.shape
    i0 = torch.floor(torch.nan_to_num(pix)).to(torch.int64)
    sizes = torch.tensor([W, H, D], device=pix.device)
    lo = torch.minimum(torch.clamp(i0, min=0), sizes - 1)
    hi = torch.minimum(torch.clamp(i0 + 1, min=0), sizes - 1)
    corners = [((z[..., 2] * H + y[..., 1]) * W + x[..., 0])
               for z in (lo, hi) for y in (lo, hi) for x in (lo, hi)]
    return distinct_sectors(torch.stack(corners))


def k3_at(tag, vol, bits, xyz, model_aabb, box):
    """K3 against its plain version on these coords (bit for bit), the share
    of samples the cell bits skip, and its times."""
    P = xyz.shape[0]
    got = occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, box)
    want = occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, box)
    skip = occupancy.occupancy_bits_skip(bits, vol.shape, xyz, model_aabb, box)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the kernel rounds each step as the plain version does; 1e-6 allows a
    # last-place difference in the eight-term sum of values in [0, 1]
    require(err <= 1e-6 and bool(torch.isfinite(got).all()), f"K3 ({tag}) max err {err:.3e}")
    flips = int(((got > 0) != (want > 0)).sum())
    require(flips == 0, f"K3 ({tag}): {flips} samples flip (> 0)")
    require(bool((want[skip].view(torch.int32) == 0).all())
            and bool((got[skip].view(torch.int32) == 0).all()),
            f"K3 ({tag}): a sample the bits skip is not +0.0")
    skipped, kept = float(skip.float().mean()), float((want > 0).float().mean())
    del got
    ms = time_ms(lambda: occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, box), reps=50)
    alone_ms = graph_ms(lambda: occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, box))
    plain_ms = time_ms(lambda: occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, box),
                       reps=5)
    # library yardstick (never called by the port): the function K3 computes,
    # the affine map into the mask's box and one 5-D F.grid_sample; the
    # F.grid_sample alone on coords that already went through the map beside it
    grid5 = occupancy.to_mask_coords(xyz, model_aabb, box).view(1, P, 1, 1, 3)
    vol5 = vol[None, None]
    library_ms = time_ms(lambda: F.grid_sample(
        vol5, occupancy.to_mask_coords(xyz, model_aabb, box).view(1, P, 1, 1, 3),
        align_corners=True, padding_mode="zeros"))
    grid_sample_ms = time_ms(lambda: F.grid_sample(vol5, grid5, align_corners=True,
                                                   padding_mode="zeros"))
    lib_err = float((F.grid_sample(vol5, grid5, align_corners=True, padding_mode="zeros")
                     .view(P) - want).abs().max())
    # bound: coords in, values out, the 32-byte sectors of the volume that the
    # samples' corners fall in (the whole volume and its bits beside it)
    sectors = trilinear_sectors(vol, occupancy.mask_pixels(xyz, model_aabb, box, vol.shape))
    n_ops = P * (3 * 12 + 8 * 5)
    b_ms, b_by = bound_ms(P * 12 + P * 4 + sectors * 32, n_ops)
    whole_ms, _ = bound_ms(P * 12 + P * 4 + vol.numel() * 4 + bits.numel() * 4, n_ops)
    print(f"[K3] {tag}: P={P} volume {tuple(vol.shape)} max_abs_err={err:.3e}, 0 flips of > 0, "
          f"share kept {kept:.4f}, share the cell bits skip {skipped:.4f} (all +0.0 in the plain "
          f"version); kernel {ms:.4f} ms ({alone_ms:.4f} alone), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (to_mask_coords + F.grid_sample; F.grid_sample alone "
          f"{grid_sample_ms:.4f} ms, max diff from plain {lib_err:.1e}), bound {b_ms:.5f} ms "
          f"({b_by}: {sectors} volume sectors of 32 B; {whole_ms:.4f} ms with the whole volume "
          f"and its bits); kernel alone / library {alone_ms / library_ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_whole_volume_ms": whole_ms,
            "volume_sectors": sectors, "library_ms": library_ms,
            "grid_sample_alone_ms": grid_sample_ms, "skipped_share": skipped,
            "kept_share": kept}


def phase_k3(meta, params, white_bg, alpha_state, new_aabb, o, d, device):
    """K3 at three inputs: uniform coords with the shrunk box as the mask's
    aabb (as in earlier runs); the ray-ordered samples of the middle 4096-ray
    render chunk at t = 0.4 with the mask as render_split builds it, the
    path's real input; and inside that masked render chunk, traced."""
    vol, bits = alpha_state["volume"], alpha_state["bits"]
    require(tuple(bits.shape) == occupancy.occupancy_bits_shape(vol.shape)
            and torch.equal(bits, occupancy.occupancy_bits(vol)),
            "the mask's cell bits are not those of its volume")
    set_bits = int(((bits[..., None] >> torch.arange(32, device=bits.device)) & 1).sum())
    print(f"[K3] cell bits {tuple(bits.shape)} int32 ({bits.numel() * 4 / 1e6:.2f} MB; the "
          f"volume {vol.numel() * 4 / 1e6:.1f} MB), share of cells set "
          f"{set_bits / np.prod([max(n - 1, 1) for n in vol.shape]):.4f}")
    xyz, box = mask_kernel_inputs(meta, alpha_state, new_aabb, device)
    entry = {"name": "occupancy_trilinear_fwd", "route": "cuda",
             "source": "nvfi_torch/csrc/occupancy.cu",
             "replaces": "nvfi_tpu/fields/kplane.py:1039"}
    entry.update(k3_at("uniform coords, the shrunk box", vol, bits, xyz, meta.aabb_np, box))
    del xyz
    pts, _, _ = kplane.sample_ray(meta, torch.as_tensor(o, dtype=torch.float32, device=device),
                                  torch.as_tensor(d, dtype=torch.float32, device=device),
                                  meta.n_samples)
    rays_xyz = kplane.normalize_coord(meta, pts).reshape(-1, 3).contiguous()
    entry["ray_ordered"] = k3_at(f"ray-ordered, {CHUNK} rays x {meta.n_samples} at t={TIMES[0]}",
                                 vol, bits, rays_xyz, meta.aabb_np, alpha_state["aabb"])
    rows = profile_call(f"masked render chunk, t={TIMES[0]}", lambda: kplane.render_rays(
        params, meta, TIMES[0], o, d, white_bg=white_bg, adv_steps=1, alpha_state=alpha_state,
        device=device))
    traced = [v for k, v in rows.items() if "occupancy_trilinear_fwd_kernel" in k]
    require(len(traced) == 1 and traced[0][1] == 1, f"K3 in the traced chunk: {traced}")
    entry["traced_chunk_ms"] = traced[0][0]
    print(f"[K3] in the traced masked render chunk at t={TIMES[0]}: {traced[0][0]:.4f} ms "
          f"(1 launch)")
    return entry


def phase_k4(meta, alpha_state, new_aabb, device):
    vol, dil = alpha_state["volume"], alpha_state["dilated"]
    xyz, box = mask_kernel_inputs(meta, alpha_state, new_aabb, device)
    P, a = xyz.shape[0], meta.aabb_np
    got = occupancy.occupancy_nearest(dil, xyz, a, box)
    want = occupancy.occupancy_nearest_reference(dil, xyz, a, box)
    tri = occupancy.occupancy_trilinear(vol, alpha_state["bits"], xyz, a, box) > 0
    torch.cuda.synchronize()
    wrong = int((got != want).sum())
    require(wrong == 0, f"K4: {wrong} of {P} samples differ from the plain version")  # exact
    require(bool((got | ~tri).all()), "K4 dropped a sample that trilinear > 0 keeps")
    extra = int((got & ~tri).sum())
    out = {}
    # the render chunk's shape (for the record, beside K3) and the pruned
    # train step's two: the PDE prefilter's points and one train chunk of samples
    D, H, W = dil.shape
    for name, pts in (("render", xyz), ("prefilter", xyz[: bat_train_hp().vel_reg_n_pts]),
                      ("train", xyz[: TRAIN_RAYS * meta.n_samples])):
        n = pts.shape[0]
        require(bool((occupancy.occupancy_nearest(dil, pts, a, box) == want[:n]).all()),
                f"K4 at the {name} shape differs from the plain version")
        ms = time_ms(lambda: occupancy.occupancy_nearest(dil, pts, a, box), reps=50)
        alone_ms = graph_ms(lambda: occupancy.occupancy_nearest(dil, pts, a, box))
        plain_ms = time_ms(lambda: occupancy.occupancy_nearest_reference(dil, pts, a, box), reps=5)
        # bound: coords in, one byte out, the 32-byte sectors of the dilated
        # volume that the samples' cells fall in (the whole volume beside it)
        cell = occupancy.mask_cells(torch.nan_to_num(
            occupancy.mask_pixels(pts, a, box, dil.shape)), dil.shape)
        sectors = distinct_sectors((cell[:, 2] * H + cell[:, 1]) * W + cell[:, 0])
        n_ops = n * (3 * 12 + 8)
        b_ms, b_by = bound_ms(n * 12 + n + sectors * 32, n_ops)
        whole_ms, _ = bound_ms(n * 12 + n + dil.numel() * 4, n_ops)
        print(f"[K4] {name} shape P={n} exact; a superset of trilinear > 0 ({extra} samples more "
              f"of {P}, share kept {float(want.float().mean()):.4f}); kernel {ms:.4f} ms "
              f"({alone_ms:.4f} alone), plain {plain_ms:.4f} ms, library none, bound "
              f"{b_ms:.5f} ms ({b_by}: {sectors} sectors of 32 B of the dilated volume, "
              f"{(n * 13 + sectors * 32) / 1e6:.2f} MB; {whole_ms:.4f} ms with the whole volume, "
              f"{(n * 13 + dil.numel() * 4) / 1e6:.1f} MB)")
        out[name] = {"ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_whole_volume_ms": whole_ms,
                     "volume_sectors": sectors}
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


def plane_cells(meta, xyzt):
    """(P, 6, 2) int64: the clamped cell of each sample on each of the six
    planes (MAT_SPACE, then MAT_TIME) along each of its two axes, as K1 and
    its plain version take it: clip(floor((u + 1) / 2 (size - 1)), 0, size - 2)."""
    gs, K = meta.grid_size, meta.num_keyframes
    axes = [((m0, gs[m0]), (m1, gs[m1])) for m0, m1 in grid_sample.MAT_SPACE]
    axes += [((m0, gs[m0]), (3, K)) for m0, _ in grid_sample.MAT_TIME]
    return torch.stack([torch.stack([torch.clamp(torch.floor(
        (xyzt[:, col] + 1.0) * 0.5 * (size - 1)).to(torch.int64), 0, max(size - 2, 0))
        for col, size in plane], -1) for plane in axes], 1)


@contextlib.contextmanager
def recorded_plane_product(seen, swap=None):
    """Inside, every plane_product call of render_rays records the xyzt that
    reaches it in ``seen``; with ``swap`` = (xyzt, where) it first replaces the
    rows ``where`` by those of ``xyzt`` (the value only: the gradient still
    flows to the positions the chunk computed)."""
    inner = kplane.plane_product

    def recording(planes_space, planes_time, xyzt, cd, **kw):
        if swap is not None:
            other, where = (x.to(xyzt.device) for x in swap)
            xyzt = xyzt + torch.where(where[:, None], other - xyzt, 0.0).detach()
        seen.append(xyzt.detach().cpu())
        return inner(planes_space, planes_time, xyzt, cd, **kw)

    kplane.plane_product = recording
    try:
        yield
    finally:
        kplane.plane_product = inner


def check_chunk_grads_against_cpu(meta, params, white_bg, o, d, target, device,
                                  kernel_tol=(KERNEL_CHUNK_GRAD_RTOL, KERNEL_CHUNK_GRAD_ATOL_REL),
                                  cpu_tol=(CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL)):
    """Per-leaf grads of one 16-ray chunk of the random-time batch, three ways:
    the card through K1, K1b, K2, K2b; the card through the plain versions; the
    port on the CPU (plain versions).  The first pair differs by the kernels
    alone, the second by everything else (cuBLAS against the CPU's GEMMs).

    Then the cause of the second: the advected xyzt that reaches K1 on the
    card and on the CPU, the samples whose clamped plane cell differs, and
    the CPU's grads again with the card's xyzt at those samples, and at
    every sample, each against the card's plain versions; and both sides'
    grads from one dL/drgb (the CPU's), which leaves out what the forward's
    difference in rgb does to the loss's residual."""
    n = 16
    co, cd, idx = spread_rays(o, d, n)
    tgt = target.reshape(-1, 3)[idx]
    jitter = np.random.RandomState(SEED + 11).rand(n, 1).astype(np.float32)
    cpu = torch.device("cpu")
    grads, rgbs, xyzts = {}, {}, {}
    # the last two runs share one dL/drgb, the CPU's: 2 (rgb - target)
    runs = [("card", device, False, None), ("card_plain", device, True, None),
            ("cpu", cpu, False, None), ("cpu_card_cells", cpu, False, "cells"),
            ("cpu_card_xyzt", cpu, False, "all"), ("card_plain_fixed", device, True, "fixed"),
            ("cpu_fixed", cpu, False, "fixed")]
    for name, dev, plain, swap in runs:
        fixed = swap == "fixed"
        if swap in ("cells", "all"):
            where = (differ if swap == "cells" else torch.ones_like(differ))
            swap = (xyzts["card"], where)
        else:
            swap = None
        p = kplane.map_params(lambda x: x.detach().to(dev).requires_grad_(True), params)
        count0 = read_counts()
        seen = []
        t0 = time.perf_counter()
        with plain_versions() if plain else contextlib.nullcontext(), \
                recorded_plane_product(seen, swap):
            out = kplane.render_rays(p, meta, TIMES[1], co, cd, white_bg=white_bg, training=True,
                                     jitter=jitter, device=dev)
            if fixed:
                torch.sum(out["rgb"] * (2.0 * (rgbs["cpu"] - torch.tensor(tgt))).to(dev)).backward()
            else:
                torch.sum((out["rgb"] - torch.tensor(tgt, device=dev)) ** 2).backward()
        require(len(seen) == 1, f"chunk grads, {name}: {len(seen)} plane_product calls")
        xyzts[name] = seen[0]
        grads[name] = {k: (None if g is None else g.cpu())
                       for k, g in flat_leaves(grad_tree(p)).items()}
        rgbs[name] = out["rgb"].detach().cpu()
        sec = time.perf_counter() - t0
        used = {k: v - count0[k] for k, v in read_counts().items() if v != count0[k]}
        arm = "_bf16" if meta.compute_dtype == "bfloat16" else ""
        want_used = {} if name != "card" else dict.fromkeys(
            (f"plane_product_fwd{arm}", f"plane_product_bwd{arm}", "composite_fwd",
             "composite_bwd"), 1)
        require(used == want_used, f"chunk grads, {name}: kernel launches {used}")
        if name == "cpu":  # the cause: where the advected positions' cells differ
            cells_card, cells_cpu = plane_cells(meta, xyzts["card"]), plane_cells(meta, seen[0])
            per_axis = (cells_card != cells_cpu).sum(0)  # (6, 2)
            differ = (cells_card != cells_cpu).any(-1).any(-1)
            gap = (xyzts["card"] - seen[0]).abs()
            print(f"[train] the xyzt that reaches K1, card against CPU, {seen[0].shape[0]} "
                  f"samples: max |difference| x {float(gap[:, 0].max()):.2e} y "
                  f"{float(gap[:, 1].max()):.2e} z {float(gap[:, 2].max()):.2e} t "
                  f"{float(gap[:, 3].max()):.2e}; {int((gap[:, :3] > 0).any(-1).sum())} samples "
                  f"differ at all; {int(differ.sum())} samples with a clamped plane cell that "
                  f"differs; per plane (space xy xz yz, time zt yt xt) and axis "
                  f"{per_axis.tolist()}")

    def compare(tag, got_name, want_name, rtol, atol_rel, check=True):
        """Largest |got - want| per leaf as a share of the leaf's largest
        grad; fails past rtol |want| + atol_rel max|want| (with ``check``)."""
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
              f"{float((rgbs[got_name] - rgbs[want_name]).abs().max()):.2e}; "
              f"{len(failed)} leaves past it")
        require(not (check and failed), f"chunk grads, {tag}, differ (share of the largest "
                f"grad): {failed}")
        return shares

    kern = compare("card kernels vs card plain versions", "card", "card_plain", *kernel_tol)
    rest = compare("card plain versions vs CPU", "card_plain", "cpu", *cpu_tol)
    both = compare("card kernels vs CPU", "card", "cpu", *cpu_tol)
    cells = compare("card plain versions vs CPU with the card's xyzt at the samples whose cell "
                    "differs", "card_plain", "cpu_card_cells", *cpu_tol, check=False)
    every = compare("card plain versions vs CPU with the card's xyzt at every sample",
                    "card_plain", "cpu_card_xyzt", *cpu_tol, check=False)
    fixed = compare("card plain versions vs CPU, both from the CPU's dL/drgb", "card_plain_fixed",
                    "cpu_fixed", *cpu_tol, check=False)
    resid = (rgbs["cpu"] - torch.tensor(tgt)).abs()
    print(f"[train] the loss's residual |rgb - target| on the CPU: max {float(resid.max()):.3e}, "
          f"mean {float(resid.mean()):.3e}; rgb card (plain) vs CPU "
          f"{float((rgbs['card_plain'] - rgbs['cpu']).abs().max()):.3e}")
    print(f"[train]   per leaf, share of its largest grad: kernels vs plain on the card / plain "
          f"on the card vs CPU / kernels vs CPU / plain on the card vs CPU with the card's xyzt "
          f"at the cell-differing samples / at every sample / plain on the card vs CPU from one "
          f"dL/drgb (CPU chunk {sec:.1f} s)")
    for k in kern:
        print(f"[train]   {k:28s} {kern[k]:.2e} / {rest[k]:.2e} / {both[k]:.2e} / "
              f"{cells[k]:.2e} / {every[k]:.2e} / {fixed[k]:.2e}  (max |grad| "
              f"{float(grads['cpu'][k].abs().max()):.3e})")
    return {"cell_differing_samples": int(differ.sum()), "samples": int(differ.numel()),
            "worst_share": {tag: max(v.values()) for tag, v in (
                ("kernels_vs_plain", kern), ("plain_vs_cpu", rest), ("kernels_vs_cpu", both),
                ("plain_vs_cpu_card_cells", cells), ("plain_vs_cpu_card_xyzt", every),
                ("plain_vs_cpu_one_dl_drgb", fixed))}}


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
    diagnosis = check_chunk_grads_against_cpu(meta, start, white_bg, o, d,
                                              unmasked[TIMES[1]]["rgb"], device)

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
    return launches, hp, train_params, data, {
        "step_s": float(np.median(secs)), "rays_per_s": 2 * hp.n_rays / float(np.median(secs)),
        "chunk_grads": diagnosis}


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


# ---------------------------------------------------------------------------
# the bf16 compute mode: meta.compute_dtype = "bfloat16", as bench.py sets it;
# K1, K1d and K1b take their bf16 arms, the MLPs run on bf16-cast params
# ---------------------------------------------------------------------------

# bf16 frames against the f32 frames of the `render` phase (the same weights):
# the shader and velocity net round to bf16, the lookups' chain too; 61.9 to
# 62.4 dB on an H100
BF16_PSNR_FLOOR = 50.0
# a 256-ray bf16 chunk, card against the port on the CPU: cuBLAS and the CPU
# round their bf16 GEMMs from f32 sums taken in other orders, and a product
# that lands on the other side of a bf16 rounding moves by a bf16 place; rgb
# 4.7e-5 to 6.5e-5 and acc up to 1.3e-4 on an H100
BF16_CHUNK_ATOL = 5e-4
# a 16-ray bf16 train chunk's per-leaf grads, as shares of each leaf's largest
# grad: the kernels against the card's plain bf16 versions (the forward of
# K1.bf16 is exact, K2's f32 scan association moves rgb, and a bf16 rounding
# downstream passes it on or not), and either against the CPU (whose bf16
# GEMMs round other f32 sums): 7.5e-3 at most on an H100, the velocity net's;
# the limits leave about 2.7x
BF16_KERNEL_CHUNK_GRAD_RTOL, BF16_KERNEL_CHUNK_GRAD_ATOL_REL = 2e-2, 2e-2
BF16_CHUNK_GRAD_RTOL, BF16_CHUNK_GRAD_ATOL_REL = 2e-2, 2e-2
# voxels of the bf16 mask that differ from the f32 mask, as a share of its
# occupied voxels: 0.26% on an H100
BF16_MASK_DIFFER_SHARE = 0.01
BF16_STEP_LAUNCHES = {"plane_product_fwd_bf16": 32, "plane_product_bwd_bf16": 32,
                      "composite_fwd": 32, "composite_bwd": 32,
                      "plane_product_density_fwd_bf16": 2}


def bf16_meta(meta):
    return replace(meta, compute_dtype="bfloat16")


def bits_differ(got, want):
    """Elements whose bits differ (bf16 tensors)."""
    return int((got.view(torch.int16) != want.view(torch.int16)).sum())


def k1_bf16_at(tag, ps, pt, xyzt, cd):
    """K1.bf16 against its plain bf16 version on these coords: app bit for
    bit (limit 0 differing elements), the density within its f32 sum's
    order; its times."""
    P, C = xyzt.shape[0], ps[0].shape[-1]
    got_d, got_a = grid_sample.plane_product(ps, pt, xyzt, cd, BF16)
    want_d, want_a = grid_sample.plane_product_reference(ps, pt, xyzt, cd, compute_dtype=BF16)
    torch.cuda.synchronize()
    differ = bits_differ(got_a, want_a)
    require(got_a.dtype == BF16 and differ == 0, f"K1.bf16 ({tag}): {differ} app elements "
            "differ from the plain bf16 version")
    check_close(f"K1.bf16 density ({tag})", [got_d], [want_d], rtol=1e-5, atol_rel=1e-6)
    err = max_err([got_d, got_a.float()], [want_d, want_a.float()])
    f32_gap = float((got_a.float() - grid_sample.plane_product(ps, pt, xyzt, cd)[1]).abs().max())
    del got_d, got_a, want_d, want_a
    ms = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd, BF16))
    alone = plane_product_alone(ps, pt, xyzt, cd, False, BF16)
    alone_ms, graph_alone_ms = time_ms(alone), graph_ms(alone)
    plain_ms = time_ms(lambda: grid_sample.plane_product_reference(ps, pt, xyzt, cd,
                                                                   compute_dtype=BF16), reps=3)
    library_ms = time_ms(grid_sample_library(list(ps) + list(pt), xyzt, cd, False, BF16))
    # the launch reads the planes' bf16 copies (2 B a channel), made apart
    n_bytes = sum(p.numel() * 2 for p in list(ps) + list(pt)) + P * 16 + P * 4 + P * (C - cd) * 2
    n_ops = P * (6 * 7 * C + 5 * C + cd + 6 * 20)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_FLOP_PER_S)
    f32_rate_ms, f32_rate_by = bound_ms(n_bytes, n_ops)
    print(f"[K1.bf16] {tag}: P={P} C={C}: app equal to the plain bf16 version bit for bit (0 "
          f"elements differ, limit 0), max_abs_err={err:.3e} (the density's f32 sum); app "
          f"differs from K1's f32 arm by up to {f32_gap:.3e}; kernel {ms:.4f} ms ({alone_ms:.4f} "
          f"alone, {graph_alone_ms:.4f} alone in a graph), plain {plain_ms:.4f} ms, library (six "
          f"bf16 F.grid_sample) {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{n_bytes / 1e9:.3f} GB with the bf16 plane copies, {n_ops / 1e9:.2f} GFLOP at "
          f"{BF16_FLOP_PER_S / 1e12} TFLOP/s; "
          f"{f32_rate_ms:.4f} ms ({f32_rate_by}) with the operations at the f32 rate)")
    return {"max_abs_err": err, "app_bits_differ": differ, "ms": ms, "kernel_alone_ms": alone_ms,
            "graph_alone_ms": graph_alone_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_f32_rate": f32_rate_ms, "library_ms": library_ms}


def plane_copy_ms(planes, channels):
    """Device time of the bf16 plane copies as the wrapper makes them for a
    new plane version (``grid_sample.bf16_planes`` on fresh views, which it
    has not seen): K1.bf16's (all channels) or K1d.bf16's (the density
    channels)."""
    return time_ms(lambda: grid_sample.bf16_planes([p.detach() for p in planes], channels))


def phase_k1_bf16(meta, params, o, d, device):
    """K1.bf16 at the ray-ordered render chunk (4096 x 686 at t = 0.4) and at
    uniform coords; K1 of the f32 arm at the same coords for comparison."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    xyzt = ray_ordered_xyzt(meta, o, d, TIMES[0], device)
    entry = {"name": "plane_product_fwd_bf16", "route": "cuda",
             "source": "nvfi_torch/csrc/plane_product.cu",
             "replaces": "nvfi_tpu/ops/grid_sample.py:79 (compute_dtype=bf16) under "
                         "nvfi_tpu/fields/kplane.py:444"}
    planes = list(ps) + list(pt)
    plan = grid_sample.plane_product_inputs(planes, cd, False, BF16)[2]
    print(f"[K1.bf16] launch plan: {plan}")
    require(plan.vec == 8, f"the bat planes' bf16 copies did not take the 16-byte path: {plan}")
    entry.update(k1_bf16_at(f"ray-ordered, {CHUNK} rays x {meta.n_samples} at t={TIMES[0]}",
                            ps, pt, xyzt, cd))
    copies = {"K1": plane_copy_ms(planes, ps[0].shape[-1]), "K1d": plane_copy_ms(planes, cd)}
    # f32 read and bf16 written once
    copy_bytes = {"K1": sum(p.numel() * 6 for p in planes),
                  "K1d": sum(p.numel() // ps[0].shape[-1] * cd * 6 for p in planes)}
    copy_bound = {k: bound_ms(n, 0)[0] for k, n in copy_bytes.items()}
    print(f"[K1.bf16] the bf16 plane copies (grid_sample.bf16_planes, made once per plane "
          f"version, not in the kernels' times or bounds): K1's {copies['K1']:.4f} ms "
          f"({copy_bytes['K1'] / 1e6:.1f} MB read and written, bound {copy_bound['K1']:.4f} ms), "
          f"K1d's {copies['K1d']:.4f} ms ({copy_bytes['K1d'] / 1e6:.1f} MB, bound "
          f"{copy_bound['K1d']:.4f} ms)")
    entry["plan"] = plan.__dict__
    entry["plane_copy"] = {"source": "nvfi_torch/ops/grid_sample.py:bf16_planes",
                           "made": "once per plane version", "ms": copies,
                           "bytes": copy_bytes, "bound_ms": copy_bound}
    entry["f32_arm_ms_here"] = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd))
    rng = np.random.RandomState(SEED + 16)
    uniform = torch.tensor(rng.uniform(-1.1, 1.1, tuple(xyzt.shape)).astype(np.float32),
                           device=device)
    entry["uniform"] = k1_bf16_at("uniform coords", ps, pt, uniform, cd)
    print(f"[K1.bf16] the f32 arm on the ray-ordered chunk: {entry['f32_arm_ms_here']:.4f} ms")
    return entry


def phase_k1d_bf16(meta, params, device):
    """K1d.bf16 at the grid-ordered middle chunk of the sweep at t = 0.4:
    against its plain version within the f32 sum's order (its last product
    in f32, as JAX's density_feature), and its gap to K1.bf16's density,
    which rounds that product to bf16 (JAX's field_features)."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    n_chunks = -(-int(np.prod([min(g, 200) for g in meta.grid_size])) // ALPHA_CHUNK)
    xyzt = grid_ordered_xyzt(meta, TIMES[0], n_chunks // 2, device)
    P = xyzt.shape[0]
    got = grid_sample.plane_product_density(ps, pt, xyzt, cd, BF16)
    want = grid_sample.plane_product_reference(ps, pt, xyzt, cd, density_only=True,
                                               compute_dtype=BF16)
    full = grid_sample.plane_product(ps, pt, xyzt, cd, BF16)[0]
    torch.cuda.synchronize()
    check_close("K1d.bf16 plane_product_density", [got], [want], rtol=1e-5, atol_rel=1e-6)
    err = max_err([got], [want])
    k1_gap = float((got - full).abs().max() / full.abs().max())
    f32_gap = float((got - grid_sample.plane_product_density(ps, pt, xyzt, cd)).abs().max())
    del got, want, full
    ms = time_ms(lambda: grid_sample.plane_product_density(ps, pt, xyzt, cd, BF16), reps=50)
    alone = plane_product_alone(ps, pt, xyzt, cd, True, BF16)
    alone_ms, graph_alone_ms = time_ms(alone, reps=50), graph_ms(alone)
    plain_ms = time_ms(lambda: grid_sample.plane_product_reference(
        ps, pt, xyzt, cd, density_only=True, compute_dtype=BF16), reps=5)
    library_ms = time_ms(grid_sample_library(list(ps) + list(pt), xyzt, cd, True, BF16))
    C = ps[0].shape[-1]
    # the launch reads the bf16 copies of the density channels (2 B a channel)
    n_bytes = sum(p.numel() // C * cd * 2 for p in list(ps) + list(pt)) + P * 16 + P * 4
    n_ops = P * (6 * 7 * cd + 5 * cd + cd + 6 * 20)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_FLOP_PER_S)
    f32_rate_ms, f32_rate_by = bound_ms(n_bytes, n_ops)
    plan = grid_sample.plane_product_inputs(list(ps) + list(pt), cd, True, BF16)[2]
    print(f"[K1d.bf16] grid-ordered chunk {n_chunks // 2} of {n_chunks} of the sweep at "
          f"t={TIMES[0]}: P={P} Cd={cd}, launch plan {plan}; max_abs_err={err:.3e} against the "
          f"plain bf16 version (rtol 1e-5, the f32 sum's order); K1.bf16's density, whose last "
          f"product is rounded to bf16, differs by up to {k1_gap:.3e} of its largest value; "
          f"{f32_gap:.3e} from the f32 arm; kernel {ms:.4f} ms ({alone_ms:.4f} alone, "
          f"{graph_alone_ms:.4f} alone in a graph), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB with the bf16 "
          f"copies; "
          f"{f32_rate_ms:.4f} ms ({f32_rate_by}) with the operations at the f32 rate)")
    return {"name": "plane_product_density_fwd_bf16", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:513 (compute_dtype=bf16)", "plan": plan.__dict__,
            "max_abs_err": err, "k1_density_gap_share": k1_gap, "ms": ms,
            "kernel_alone_ms": alone_ms, "graph_alone_ms": graph_alone_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_rate": f32_rate_ms,
            "library_ms": library_ms}


def phase_k1b_bf16(meta, params, white_bg, pose, unmasked, device):
    """K1b.bf16 at the real bf16 train chunk: the coords and incoming grads
    (g_density f32, g_app bf16) of the keyframe batch's first 128 rays at
    t = 0.4, rendered in bf16; against the plain bf16 backward, grad_xyzt of
    two launches bit for bit; its times beside the f32 arm's on the same
    grads, and both arms' atomic counts."""
    bmeta = bf16_meta(meta)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    planes = list(ps) + list(pt)
    xyzt, gd, ga = train_chunk_grad_inputs(bmeta, params, white_bg, pose, unmasked, device)
    P, C = xyzt.shape[0], ps[0].shape[-1]
    require(ga.dtype == BF16 and gd.dtype == torch.float32, f"grads {gd.dtype} {ga.dtype}")
    copies = grid_sample.bf16_planes(planes, C)
    grads, g_xyzt = grid_sample._zero_plane_grads(planes), torch.empty_like(xyzt)
    plan = grid_sample.plane_product_bwd_plan(
        C, cd, [p.data_ptr() for p in copies + grads] + [ga.data_ptr()], BF16)
    print(f"[K1b.bf16] launch plan: {plan}")
    require(plan.vec == 8, f"the bat planes' bf16 copies did not take the 16-byte path: {plan}")
    got_planes, got_xyz = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga,
                                                             compute_dtype=BF16)
    _, again_xyz = grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga, want_planes=False,
                                                      compute_dtype=BF16)
    want_planes, want_xyz = grid_sample.plane_product_backward_reference(ps, pt, xyzt, cd, gd, ga,
                                                                         BF16)
    torch.cuda.synchronize()
    got, want = got_planes + [got_xyz], list(want_planes) + [want_xyz]
    check_close("K1b.bf16 plane_product_bwd (the real bf16 train chunk)", got, want,
                rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL)
    err = max_err(got, want)
    xyz_differ = int((got_xyz.view(torch.int32) != again_xyz.view(torch.int32)).sum())
    require(xyz_differ == 0, f"K1b.bf16: grad_xyzt of two launches differs in {xyz_differ} "
            "values (it has no atomics)")
    scale = (max(float(w.abs().max()) for w in want_planes), float(want_xyz.abs().max()))
    del got, want, want_planes, want_xyz, again_xyz
    active = int(((gd != 0) | (ga != 0).any(-1)).sum())

    def alone(g_app=ga, counts=None, want_xyz=True):  # preallocated outputs; the grads accumulate
        grid_sample.launch_plane_product_backward(planes, xyzt, cd, gd, g_app, grads,
                                                  g_xyzt if want_xyz else None, counts)

    ga_f32 = ga.float()
    stats = {}
    for arm, g_app in (("bf16", ga), ("f32", ga_f32)):
        counts = torch.zeros(3, dtype=torch.int64, device=device)
        alone(g_app, counts)
        stats[arm] = [int(v) for v in counts.tolist()]
    ms = time_ms(lambda: grid_sample.plane_product_backward(ps, pt, xyzt, cd, gd, ga,
                                                            compute_dtype=BF16))
    alone_ms = graph_ms(alone)
    alone_no_xyz_ms = graph_ms(lambda: alone(want_xyz=False))
    plain_ms = time_ms(lambda: grid_sample.plane_product_backward_reference(
        ps, pt, xyzt, cd, gd, ga, BF16), reps=3)
    library_ms = time_ms(plane_grad_library(planes, xyzt, cd, gd, ga, BF16), reps=5)
    f32_alone_ms = graph_ms(lambda: alone(ga_f32))
    f32_alone_no_xyz_ms = graph_ms(lambda: alone(ga_f32, want_xyz=False))
    # the launch reads the sectors of the bf16 plane copies (2 B a channel,
    # made apart) that this data touches and adds to those of the f32 grads;
    # the whole copies read and grads written beside it
    live = (gd != 0) | (ga != 0).any(-1)
    read, written = k1b_sector_bytes(copies, xyzt, live, 2, BF16)
    n_bytes = read + written + P * (4 + (C - cd) * 2 + 16) + active * 16
    whole_ms, _ = bound_ms(sum(p.numel() * (2 + 4) for p in planes) + P * (36 + (C - cd) * 2), 0)
    # per active sample and channel: the lookup (6 x 7), the chain's products
    # and its VJP (12), 24 row cotangents, 24 products and 24 sums of the tent
    # products' cotangents; per active sample the f32 tail (6 x 12)
    n_ops = active * (C * (6 * 7 + 12 + 24 + 48) + 6 * 12)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_FLOP_PER_S)
    f32_rate_ms, f32_rate_by = bound_ms(n_bytes, n_ops)
    sectors = stats["bf16"][0] * min(plan.vec, 4) // 8
    print(f"[K1b.bf16] one bf16 train chunk, {TRAIN_RAYS} rays x {meta.n_samples} at t={TIMES[0]}: "
          f"P={P} C={C}, share of samples with a non-zero incoming grad {active / P:.4f}; "
          f"max_abs_err {err:.3e} against the plain bf16 backward (rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL_REL} x max|grad|; max |plane grad| {scale[0]:.3e}, max |grad_xyz| "
          f"{scale[1]:.3e}); grad_xyzt of two launches equal bit for bit")
    print(f"[K1b.bf16] atomics (global atomic instructions, zero-weight updates, merged "
          f"updates): bf16 arm {stats['bf16']}, f32 arm on the same grads {stats['f32']} "
          f"(equal: {stats['bf16'] == stats['f32']}); {sectors} 32-byte sectors, "
          f"{sectors / alone_ms / 1e6:.2f} G sectors/s alone")
    print(f"[K1b.bf16] kernel {ms:.4f} ms ({alone_ms:.4f} alone, {alone_no_xyz_ms:.4f} alone "
          f"without grad_xyz; the f32 arm alone on the same grads widened {f32_alone_ms:.4f}, "
          f"{f32_alone_no_xyz_ms:.4f} without grad_xyz), plain {plain_ms:.4f} ms, library (six "
          f"bf16 F.grid_sample + autograd) {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{n_bytes / 1e6:.1f} MB, of which sectors of the bf16 plane copies read "
          f"{read / 1e6:.1f} MB and grad sectors written {written / 1e6:.1f} MB; "
          f"{n_ops / 1e9:.3f} GFLOP at {BF16_FLOP_PER_S / 1e12} TFLOP/s; {f32_rate_ms:.4f} ms "
          f"({f32_rate_by}) with the operations at the f32 rate; {whole_ms:.4f} ms with the "
          f"whole copies and grads); kernel / library {ms / library_ms:.3f}")
    return {"name": "plane_product_bwd_bf16", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product_bwd.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:444 (compute_dtype=bf16, its VJP)",
            "plan": plan.__dict__, "max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
            "kernel_alone_no_xyz_ms": alone_no_xyz_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_rate": f32_rate_ms,
            "bound_whole_planes_ms": whole_ms,
            "library_ms": library_ms, "f32_arm_alone_ms_here": f32_alone_ms,
            "f32_arm_alone_no_xyz_ms_here": f32_alone_no_xyz_ms, "active_share": active / P,
            "atomics": stats, "atomic_sectors": sectors}


def psnr(a, b):
    return float(-10.0 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20)))


def phase_render_bf16(meta, params, params_cpu, white_bg, card, o, d, f32_images, f32_rates,
                      device):
    """The 400x400 frames at t = 0.4, 0.425, 0.9 in bf16: launches, rays/s
    beside f32's, PSNR against the f32 frames, one 256-ray chunk per time
    against the port on the CPU, and a profile of one chunk per bucket."""
    bmeta = bf16_meta(meta)
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    kplane.render_rays(params, bmeta, TIMES[0], o.reshape(-1, 3)[:CHUNK],
                       d.reshape(-1, 3)[:CHUNK], white_bg=white_bg, adv_steps=1, device=device)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    images, per_image = {}, []
    for t in TIMES:
        before = read_counts()
        t0 = time.perf_counter()
        images[t] = render_image(params, bmeta, t, o, d, white_bg=white_bg, chunk=CHUNK,
                                 device=device)
        sec = time.perf_counter() - t0
        after = read_counts()
        per_image.append((t, sec, after["plane_product_fwd_bf16"]
                          - before["plane_product_fwd_bf16"],
                          after["composite_fwd"] - before["composite_fwd"]))
    launches = read_counts()
    # ------------------------------------------------------------------------

    rates, psnrs = {}, {}
    for (t, sec, n1, n2), img in zip(per_image, images.values()):
        rates[t] = IMAGE * IMAGE / sec
        psnrs[t] = psnr(img["rgb"], f32_images[t]["rgb"])
        print(f"[render_bf16] t={t}: {IMAGE}x{IMAGE} in {sec:.3f} s = {rates[t]:.0f} rays/s "
              f"(f32 {f32_rates[t]:.0f}; {adv_steps_for(meta, t)} RK2 steps, {n1} K1.bf16 / {n2} "
              f"K2 launches); PSNR against the f32 frame {psnrs[t]:.2f} dB (floor "
              f"{BF16_PSNR_FLOOR}), max |rgb - f32| "
              f"{float(np.abs(img['rgb'] - f32_images[t]['rgb']).max()):.3e} [{card}]")
        for k in ("rgb", "depth", "acc"):
            require(np.isfinite(img[k]).all(), f"bf16 t={t}: non-finite {k}")
        require(n1 == n_chunks and n2 == n_chunks,
                f"bf16 t={t}: launches K1.bf16 {n1}, K2 {n2}, want {n_chunks} each")
        require(psnrs[t] >= BF16_PSNR_FLOOR, f"bf16 t={t}: PSNR {psnrs[t]:.2f} against f32")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("plane_product_fwd_bf16", "composite_fwd")),
            f"the bf16 render launched another kernel: {launches}")

    co, cdirs, idx = spread_rays(o, d)
    chunk_errs = {}
    for t in TIMES:
        steps = adv_steps_for(meta, t)
        gpu = kplane.render_rays(params, bmeta, t, co, cdirs, white_bg=white_bg, adv_steps=steps,
                                 device=device)
        t0 = time.perf_counter()
        cpu = kplane.render_rays(params_cpu, bmeta, t, co, cdirs, white_bg=white_bg,
                                 adv_steps=steps, device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu = {k: v.cpu() for k, v in gpu.items() if isinstance(v, torch.Tensor)}
        errs = {k: float((gpu[k] - cpu[k]).abs().max()) for k in ("rgb", "acc", "depth")}
        mean_rgb = float((gpu["rgb"] - cpu["rgb"]).abs().mean())
        chunk_errs[t] = errs
        print(f"[render_bf16] t={t}: 256-ray chunk card vs CPU max err {errs}, mean |rgb| err "
              f"{mean_rgb:.3e} (limit {BF16_CHUNK_ATOL} on rgb and acc; CPU chunk {cpu_s:.1f} s)")
        require(errs["rgb"] <= BF16_CHUNK_ATOL and errs["acc"] <= BF16_CHUNK_ATOL,
                f"bf16 t={t}: card vs CPU {errs}")
        require(np.abs(images[t]["acc"].reshape(-1)[idx] - gpu["acc"].numpy()).max() <= 1e-4,
                f"bf16 t={t}: the chunk disagrees with the image")
    mid = IMAGE * IMAGE // 2
    profiles = {}
    for t in (TIMES[0], TIMES[2]):
        steps = adv_steps_for(meta, t)
        profile_call(f"bf16 render chunk, t={t} ({steps} steps)", lambda: kplane.render_rays(
            params, bmeta, t, o.reshape(-1, 3)[mid:mid + CHUNK], d.reshape(-1, 3)[mid:mid + CHUNK],
            white_bg=white_bg, adv_steps=steps, device=device))
        profiles[t] = dict(LAST_PROFILE)
    return launches, images, {"rays_per_s": rates, "psnr_vs_f32": psnrs,
                              "chunk_vs_cpu": chunk_errs, "profiles": profiles}


def phase_alpha_bf16(meta, params, white_bg, card, f32_state, f32_sec, o, d, unmasked, device):
    """The bf16 mask build (K1d.bf16; the velocity net stays f32, as in the
    JAX package), its voxels against the f32 mask, then one masked bf16 frame
    (K1.bf16, K2, K3)."""
    bmeta = bf16_meta(meta)
    grid = tuple(min(g, 200) for g in meta.grid_size)
    n_chunks = -(-int(np.prod(grid)) // ALPHA_CHUNK)
    n_frame = -(-IMAGE * IMAGE // CHUNK)

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, new_aabb = kplane.update_alpha_mask(params, bmeta, grid, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    build = read_counts()
    t0 = time.perf_counter()
    frame = render_image(params, bmeta, TIMES[0], o, d, white_bg=white_bg, chunk=CHUNK,
                         alpha_state=state, device=device)
    frame_sec = time.perf_counter() - t0
    launches = read_counts()
    # ------------------------------------------------------------------------

    vol, vol32 = state["volume"], f32_state["volume"]
    differ = int((vol != vol32).sum())
    occupied = int(vol32.sum())
    print(f"[alpha_bf16] update_alpha_mask {grid} x {ALPHA_TIMES} times in bf16: {sec:.3f} s "
          f"(f32 {f32_sec:.3f} s; {build['plane_product_density_fwd_bf16']} K1d.bf16 launches); "
          f"occupied share {float(vol.mean()):.4f} (f32 {float(vol32.mean()):.4f}); {differ} "
          f"voxels differ from the f32 mask ({differ / max(occupied, 1):.5f} of its {occupied} "
          f"occupied voxels, limit {BF16_MASK_DIFFER_SHARE}) [{card}]")
    require(build["plane_product_density_fwd_bf16"] == ALPHA_TIMES * n_chunks
            and all(v == 0 for k, v in build.items() if k != "plane_product_density_fwd_bf16"),
            f"the bf16 mask build's launches {build}")
    require(differ <= BF16_MASK_DIFFER_SHARE * occupied,
            f"{differ} voxels differ from the f32 mask")
    framed = {k: launches[k] - build[k] for k in launches}
    want = {"plane_product_fwd_bf16": n_frame, "composite_fwd": n_frame,
            "occupancy_trilinear_fwd": n_frame}
    require(framed == {k: want.get(k, 0) for k in framed}, f"masked bf16 frame launches {framed}")
    p = psnr(frame["rgb"], unmasked[TIMES[0]]["rgb"])
    print(f"[alpha_bf16] the masked bf16 frame at t={TIMES[0]}: {IMAGE * IMAGE / frame_sec:.0f} "
          f"rays/s, PSNR against the unmasked f32 frame {p:.2f} dB (floor {PSNR_FLOOR})")
    require(np.isfinite(frame["rgb"]).all() and p >= PSNR_FLOOR, f"masked bf16 frame PSNR {p}")
    return launches, state, {"mask_s": sec, "voxels_differ": differ,
                             "masked_frame_rays_per_s": IMAGE * IMAGE / frame_sec,
                             "masked_frame_psnr": p}


def check_bf16_copies_after_steps(meta, params, o, d, device):
    """After optimizer steps have updated the planes in place: the bf16 plane
    copies that K1.bf16 and K1d.bf16 read (grid_sample.bf16_planes, kept per
    plane version) equal the stepped planes rounded to bf16 bit for bit, and
    both arms on the stepped planes equal their plain versions, which read
    the float32 planes (app bit for bit, density rtol 1e-5).  A copy left
    stale by an update that did not move the plane's version fails here."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    planes = list(ps) + list(pt)
    stale = 0
    for channels in (planes[0].shape[-1], cd):
        for copy, p in zip(grid_sample.bf16_planes(planes, channels), planes):
            stale += bits_differ(copy, p.detach()[..., :channels].to(BF16))
    require(stale == 0, f"{stale} values of the bf16 plane copies differ from the stepped "
            "planes rounded to bf16")
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    mid = IMAGE * IMAGE // 2  # the middle chunk, as phases K1 and K1.bf16 take it
    xyzt = ray_ordered_xyzt(meta, o[mid:mid + CHUNK], d[mid:mid + CHUNK], TIMES[0],
                            device)[:ALPHA_CHUNK].contiguous()
    with torch.no_grad():
        got_d, got_a = grid_sample.plane_product(ps, pt, xyzt, cd, BF16)
        want_d, want_a = grid_sample.plane_product_reference(ps, pt, xyzt, cd,
                                                             compute_dtype=BF16)
        got_dd = grid_sample.plane_product_density(ps, pt, xyzt, cd, BF16)
        want_dd = grid_sample.plane_product_reference(ps, pt, xyzt, cd, density_only=True,
                                                      compute_dtype=BF16)
    torch.cuda.synchronize()
    differ = bits_differ(got_a, want_a)
    require(differ == 0, f"K1.bf16 on the stepped planes: {differ} app elements differ from "
            "the plain bf16 version")
    check_close("K1.bf16 density on the stepped planes", [got_d], [want_d], rtol=1e-5,
                atol_rel=1e-6)
    check_close("K1d.bf16 on the stepped planes", [got_dd], [want_dd], rtol=1e-5, atol_rel=1e-6)
    err = max_err([got_d, got_dd], [want_d, want_dd])
    print(f"[train_bf16] after the steps: the bf16 plane copies equal the stepped planes rounded "
          f"to bf16 (0 values differ, limit 0); on {xyzt.shape[0]} ray-ordered samples of the "
          f"middle {CHUNK}-ray chunk at t={TIMES[0]}, K1.bf16's app equals its plain version "
          f"bit for bit (limit 0) and the "
          f"densities of K1.bf16 and K1d.bf16 are within {err:.3e} of theirs (rtol 1e-5)")
    return {"stale_values": stale, "app_bits_differ": differ, "density_max_abs_err": err}


def phase_train_bf16(meta, params, white_bg, card, pose, o, d, unmasked, alpha_state, device):
    """Ten static_dynamic steps and three pruned ones in bf16 at full width:
    launches (K1.bf16, K1b.bf16, K1d.bf16; no f32 arm), finite grads, a lower
    loss on fixed draws, one 16-ray chunk's grads three ways, masters f32,
    s/step and one traced step."""
    bmeta = bf16_meta(meta)
    hp, start, data = train_set_up(bmeta, params, unmasked, pose, device)
    loss_fn = trainer.make_loss_fn(bmeta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                   device=device)
    train_step = trainer.make_train_step(bmeta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    fixed = trainer.draw_train_inputs(gen, bmeta, hp, IMAGE, IMAGE)
    before = fixed_loss(loss_fn, start, fixed, data, hp)
    as_leaves(start)
    loss_fn(start, fixed, 1, 0, 0, *data, hp.L1_weight_initial, 0.0, None)
    leaves = flat_leaves(grad_tree(start))
    for k, g in leaves.items():
        if k.startswith("basis_mat_density"):
            require(g is None or not bool(g.any()), f"bf16: {k} has a gradient")
            continue
        require(g is not None and g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                and bool(g.any()), f"bf16: grad of {k} is missing, zero, not f32 or not finite")
    print(f"[train_bf16] {len(leaves)} grad leaves float32, finite and non-zero "
          f"(basis_mat_density none)")
    print("[train_bf16] one 16-ray chunk's grads in bf16 (the lines tagged [train] below):")
    diagnosis = check_chunk_grads_against_cpu(
        bmeta, start, white_bg, o, d, unmasked[TIMES[1]]["rgb"], device,
        kernel_tol=(BF16_KERNEL_CHUNK_GRAD_RTOL, BF16_KERNEL_CHUNK_GRAD_ATOL_REL),
        cpu_tol=(BF16_CHUNK_GRAD_RTOL, BF16_CHUNK_GRAD_ATOL_REL))

    opt_state, counters = optim.init_state(start), trainer.init_counters()
    draws = [trainer.draw_train_inputs(gen, bmeta, hp, IMAGE, IMAGE)
             for _ in range(TRAIN_STEPS + 2)]
    train_params = start
    train_params, opt_state, counters, _ = train_step(train_params, opt_state, counters, draws[0],
                                                      1, 0, 0, *data, hp.L1_weight_initial, 0.0,
                                                      None)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
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

    for i, (sec, counts, m) in enumerate(steps, 1):
        print(f"[train_bf16] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}, "
              f"vel_pde {m['vel_pde']:.3e}) [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"bf16 step {i}: metrics {m}")
        want = {k: BF16_STEP_LAUNCHES.get(k, 0) for k in counts}
        require(counts == want, f"bf16 step {i}: launches {counts}, want {want}")
    secs = [sec for sec, _, _ in steps]
    require(all(p.dtype == torch.float32 for tree in (train_params, opt_state["m"],
                                                      opt_state["v"])
                for p in optim.tree_leaves(tree) if p is not None),
            "a master leaf or a moment is not float32")
    after = fixed_loss(loss_fn, train_params, fixed, data, hp)
    print(f"[train_bf16] {TRAIN_STEPS} steps: median {np.median(secs):.4f} s a step = "
          f"{2 * hp.n_rays / np.median(secs):.0f} rays/s (min {min(secs):.4f}, max "
          f"{max(secs):.4f}); launches a step {steps[0][1]}; masters and moments float32; loss "
          f"on the fixed draws {before['loss']:.6f} before, {after['loss']:.6f} after "
          f"{TRAIN_STEPS + 1} steps [{card}]")
    require(after["loss"] < before["loss"], "bf16: the loss on the fixed draws did not fall")
    profile_call("bf16 train step (static_dynamic, full width)", lambda: train_step(
        train_params, opt_state, counters, draws[-1], 1, 0, TRAIN_STEPS + 1, *data,
        hp.L1_weight_initial, 0.0, None))
    traced = dict(LAST_PROFILE)

    # three pruned steps: K4 in every chunk and in the PDE prefilter
    pruned_meta = replace(bmeta, train_occupancy_prune=True)
    prune_step = trainer.make_train_step(pruned_meta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                         use_alpha=True, device=device)
    want = dict(BF16_STEP_LAUNCHES, occupancy_nearest_fwd=33)

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    pruned = []
    for i in range(PRUNE_STEPS):
        count0 = read_counts()
        t0 = time.perf_counter()
        train_params, opt_state, counters, metrics = prune_step(
            train_params, opt_state, counters, draws[i], 1, 0, TRAIN_STEPS + 2 + i, *data,
            hp.L1_weight_initial, 0.0, alpha_state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        count1 = read_counts()
        pruned.append((sec, {k: count1[k] - count0[k] for k in count1},
                       {k: float(v) for k, v in metrics.items()}))
    prune_launches = read_counts()
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(pruned):
        print(f"[train_prune_bf16] step {i}: {sec:.4f} s, loss {m['loss']:.6f}; K4 launches "
              f"{counts['occupancy_nearest_fwd']} [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"bf16 pruned step {i}: metrics {m}")
        require(counts == {k: want.get(k, 0) for k in counts},
                f"bf16 pruned step {i}: launches {counts}, want {want}")
    fresh = check_bf16_copies_after_steps(bmeta, train_params, o, d, device)
    return launches, prune_launches, {
        "step_s": float(np.median(secs)), "rays_per_s": 2 * hp.n_rays / float(np.median(secs)),
        "traced_step": traced, "chunk_grads": diagnosis, "copies_after_steps": fresh}


def profile_call(tag, fn):
    """Device-time breakdown of one call of ``fn`` (torch.profiler), printed;
    returns {kernel name: (device ms, launches)}."""
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
        return {}
    gemm = sum(_device_us(e) for e in rows if is_gemm(e.key)) / 1e3
    LAST_PROFILE.update(wall_ms=wall_ms, busy_ms=busy_ms, gemm_ms=gemm,
                        idle_share=max(0.0, 1 - busy_ms / wall_ms),
                        launches=sum(e.count for e in rows))
    print(f"[profile] {tag}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, traced) in "
          f"{sum(e.count for e in rows)} kernel launches; GEMMs {gemm:.2f} ms")
    ranked = sorted(rows, key=lambda e: -_device_us(e))
    for e in ranked[:10]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    for e in ranked[10:]:  # the port's own kernels below the top ten
        if any(f"::{name}" in e.key for name in PORT_KERNELS):
            print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]} "
                  f"(below the top ten)")
    return {e.key: (_device_us(e) / 1e3, e.count) for e in rows}


LAST_PROFILE = {}  # the summary of profile_call's last trace


def is_gemm(key):
    """A matrix-product kernel of cuBLAS / cuBLASLt, by its name."""
    return any(k in key.lower() for k in ("gemm", "nvjet", "xmma", "cutlass", "s16816", "s1688"))


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
        paths["alpha"], alpha_state, new_aabb, alpha_sec = phase_alpha(meta, params, params_cpu,
                                                                       card, device)
        phase = "K3"
        k3 = phase_k3(meta, params, white_bg, alpha_state, new_aabb, o_mid, d_mid, device)
        phase = "K4"
        k4 = phase_k4(meta, alpha_state, new_aabb, device)
        phase = "split"
        paths["split"] = phase_split(meta, params, params_cpu, white_bg, card, pose, o, d,
                                     unmasked, alpha_state, device)
        phase = "K1b"
        k1b = phase_k1b(meta, params, white_bg, pose, unmasked, device)
        phase = "K2b"
        k2b = phase_k2b(meta, white_bg, device)
        phase = "train"
        paths["train"], hp, trained, data, train_numbers = phase_train(
            meta, params, white_bg, card, pose, o, d, unmasked, device)
        phase = "train_prune"
        paths["train_prune"] = phase_train_prune(meta, hp, trained, data, alpha_state, card,
                                                 device)
        del trained, data
        torch.cuda.empty_cache()
        # the bf16 compute mode, after every f32 phase
        phase = "K1.bf16"
        k1_bf16 = phase_k1_bf16(meta, params, o_mid, d_mid, device)
        phase = "K1d.bf16"
        k1d_bf16 = phase_k1d_bf16(meta, params, device)
        torch.cuda.empty_cache()
        phase = "render_bf16"
        paths["render_bf16"], _, render_bf16 = phase_render_bf16(
            meta, params, params_cpu, white_bg, card, o, d, unmasked,
            {t: unmasked[t]["rays_per_s"] for t in TIMES}, device)
        del params_cpu
        phase = "alpha_bf16"
        paths["alpha_bf16"], alpha_bf16_state, alpha_bf16 = phase_alpha_bf16(
            meta, params, white_bg, card, alpha_state, alpha_sec, o, d, unmasked, device)
        phase = "K1b.bf16"
        k1b_bf16 = phase_k1b_bf16(meta, params, white_bg, pose, unmasked, device)
        phase = "train_bf16"
        paths["train_bf16"], paths["train_prune_bf16"], train_bf16 = phase_train_bf16(
            meta, params, white_bg, card, pose, o, d, unmasked, alpha_bf16_state, device)
    except Exception:
        traceback.print_exc()
        print(f"[chip_smoke] FAILED in phase {phase}", file=sys.stderr)
        sys.exit(1)
    entries = [k1, k1b, k1d, k2, k2b, k3, k4, k5, k1_bf16, k1b_bf16, k1d_bf16]
    for entry in entries:
        entry["launches_by_path"] = {name: counts[entry["name"]] for name, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["launches"] == 0:
            print(f"[chip_smoke] FAILED: {entry['name']} was launched on no main path",
                  file=sys.stderr)
            sys.exit(1)
    print(f"[chip_smoke] train step: {json.dumps(train_numbers)}")
    print(f"[chip_smoke] bf16: {json.dumps({'render': render_bf16, 'alpha': alpha_bf16, 'train': train_bf16})}")
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

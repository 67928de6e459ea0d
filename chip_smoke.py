#!/usr/bin/env python3
"""Chip smoke test of the nvfi_torch port on one NVIDIA card (H100, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  env     the card's name and power limit, torch and CUDA versions; TF32 off
  build   compile nvfi_torch/csrc/*.cu with nvcc for sm_90a (one nvcc per
          source, all started together) and print the ptxas report
  floor   the launch floor: the empty kernel of csrc/floor.cu in CUDA graphs
          at <<<1, 32>>> and at the one-thread-a-sample grids of a train
          chunk, the PDE prefilter and a render chunk, and there the touch
          kernel (12 bytes in, 1 byte out a thread); every kernel entry gets
          the empty kernel's time at its own grid (floor_ms)
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
  K4      occupancy_nearest (reading the mask's occupied bits) vs its plain
          version (exact) on the same coords, through the wrapper and alone
          at the render chunk's shape and the pruned train step's two, one
          sample a thread; bounds from the distinct 32-byte sectors of the
          occupied bits the samples touch, the whole bits and the sectors of
          the f32 dilated volume beside them
  split   eval.harness.render_split over three views (the poses and times of
          `render`, whose unmasked images are the ground truth) with the
          mask: rays/s and K1/K2/K3 launches per frame, the share of samples
          the mask leaves valid, PSNR/SSIM against the unmasked renders, and
          one 256-ray chunk per time against the port on the CPU
  split_sparse  render_split(sparse_budget=...) over the same views with the
          same mask: turbo's block-sparse sample axis (blocks of
          meta.sample_block = 16, the axis padded to 688), the budget 1.3 x
          the largest per-chunk share of active blocks; each frame within
          1e-5 of `split`'s dense masked frame, dropped 0, rays/s beside the
          dense masked frame's, B and P = 16 B a chunk, launches K1/K2/K3 40
          and K5 120 a frame (three picks a chunk, no read-back); the picks of
          the middle chunk of its first frame are kept for phase K5
  K5      row_gather: the gather of the repository's two Pallas probes (1024
          rows of a 512 x 128 table of ones, summed) as a path of its own,
          then the kernel vs tab[idx] there and at the three picks that
          `split_sparse` made (the xyz, t and base_times tables of one chunk
          and its B selected blocks); each also from a seeded table of
          distinct rows with the same indices; the kernel alone, the plain
          version and index_select as CUDA graphs, the wrappers row_gather
          (whose index check reads back) and pick_rows (none) with events
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
  K2.colourless  the colourless arms of K2 and K2b (the top-K shade's
          compositing: no colour in or out) at (4096, 688) and (256, 688):
          weight, acc, depth and grad_sigma equal to the colour arms' bit for
          bit on the same inputs, against their plain versions, alone times
          beside the colour arms', bounds and floors
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
          unpruned loss on the same draws; one traced step
  train_turbo  turbo steps: train_occupancy_prune, block_budget and shade from
          the port's probe (train.turbo.measure_block_budget on the train
          pose, the shade capped at bat.yaml's 0.25 by shade_cap_policy), 8
          chunks of 256 rays a batch; one chunk with the shade uncapped
          (dropped 0) against the dense pruned chunk on the card and the
          CPU; three counted steps with dropped_blocks 0 and exact launches
          (K5 3, K1, K1b, K4 and the colourless K2 / K2b one a chunk, K4 and
          K1d in the PDE loss), s/step, rays/s and one traced step beside
          `train_prune`'s
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
          seconds per step and one traced step of each; after the steps, the
          bf16 plane copies against the stepped planes and K1.bf16 /
          K1d.bf16 on them against their plain versions
  train_turbo_bf16  `train_turbo` in bf16, on the bf16 mask of `alpha_bf16`
Then the Trainer stage loop, through the port's training CLI (nvfi_torch.train_nvfi)
on configs/synth/chessboard_slow_turbo.yaml, its schedule compressed to 14
iterations (upsamples after 2, 4, 6, 8, 10; alpha-mask builds at 2 and 4;
checkpoints every 6), the synthetic scene at the CLI's defaults (96^2, 48
times x 4 cameras):
  trainer  the CLI with --eval_test: every step synchronized and timed,
          its launches equal to what the stage's meta gives (step_launches),
          the counters' running max printed; planes contiguous on K1's and
          K1b's 16-byte plans at each stage's first step; dropped_blocks 0 at
          every counter read; a line per event (grid, keyframes, aabb, mask
          resolution, occupancy, budgets, seconds of the mask build, shrink,
          upsample and probe); checkpoints 6, 12, 13; eval PSNR / SSIM; peak
          memory; then a second Trainer restores model_00006 (meta, extras,
          mask and params equal to the saved ones, re-probed) and runs on to
          the end, finishing on the first run's grid, aabb and keyframes
  trainer_bf16  the same in bf16 (no eval, no resume), the bf16 plane copies
          held to the new planes at each stage
  trainer_learns  120 steps of the tiny scene of tests/test_train_e2e.py:
          psnr_0 must rise by more than 4 dB
  segm_train  python -m nvfi_torch.train_segm on the `trainer` scene (20
          iterations, 64^3 points into K1d each), 3 in-process iterations
          with the KNN arm, one seg step card vs CPU in float32 and float64
          (and a control step with TF32 on, printed); one iteration's t = 0
          occupancy query card vs CPU, and K1d against its plain version there
  segm_render  python -m nvfi_torch.test_segm_render: the 128^3 transfer
          mask, two views through the MaskField head, the metrics, the PLY
          export (headers and first vertices read back); a 256-ray transfer
          chunk with the head and one chunk of the transfer mask sweep card
          vs CPU, and K1d at that chunk's positions advected to t = 0
  transfer  python -m nvfi_torch.test_transfer_vel with the bf16 run's
          velocity grafted in: the t = 0 view equal to the host's own frame
          bit for bit
Multi-frame ray batches (experiment.multi_frame_batch: every ray of a batch from a
frame of its own, at its time and pose), after train_turbo, on a pool of 16
frames at distinct times (8 keyframes of K = 16 and 8 times 0.02 off one) from
four cameras, rendered by the card from the seeded weights at 100^2:
  train_multi  ten bat-width static_dynamic steps (2 x 16 chunks of 128 rays):
          exact launches, the median step beside `train`'s; the first 16 rays
          of each batch's first chunk, card kernels vs card plain versions vs
          the CPU; K1 and K1b alone on the random-time batch's first 128-ray
          chunk, multi-frame and single-frame (one frame), at the same P
  train_multi_turbo  three turbo steps on the pool (the mask of `alpha`, the
          probe over the pool's poses, the shade capped at 0.25, 2 x 8 chunks
          of 256): dropped_blocks every step, equal to the chunks' active
          blocks past the budget's B, each batch's largest active-block share
          beside the budget; one chunk card vs CPU (dropped_blocks equal)
And on the `trainer` scene, at the end:
  supervise  python -m nvfi_torch.train_nvfi --supervise --profile 2 on the
          `trainer` schedule with multi-frame batches; the first child is
          killed (SIGKILL) once model_00006 exists: one restart with
          --resume, the resumed run ends at the last iteration, and both
          attempts' Chrome traces name the port's kernels
  video   python -m nvfi_torch.render_video at its defaults (128^2, 40
          frames over t in [0, 1], the mask at 128^3): frames/s, the mask's
          seconds, launches a frame; frame 0 and the first past tmax within 1
          level of the CPU's on 256 of their rays
  eval_all  python -m nvfi_torch.eval_all cut to 8 test views at 64^2: the
          PSNRs, velocity EPE and advection error, the velocity numbers
          within rtol 1e-4 of the CPU's
Then the static TensoRF models (a model_name without Keyframe), at bat's
widths (24 + 48 channels, app_dim 32, MLP_PE 128 wide, 199^3, 686 samples):
  K6, K6.CP  plane_line (VM: three plane x line products a kind; CP: three
          lines) vs its plain version on the seeded blob field at the train
          step's 2048 x 686 jittered samples (the line's numbers) and a
          4096-ray render chunk; K6d (the density alone) on the grid-ordered
          middle chunk of the 199^3 sweep and the render chunk; K6b on the
          coords and incoming grads of one real train step (recorded at its
          launch); at each: wrapper / alone (CUDA graphs) / plain / library
          (F.grid_sample on planes and lines, products, sums; its autograd
          for K6b) / bound times, the floor at the grid
  static  python -m nvfi_torch.train_nvfi --config configs/synth/bat.yaml
          --synthetic nvfi.model_name TensorVMSplit, 14 iterations (upsamples
          after 2, 4, 6, 8, 10; alpha-mask builds with their shrink at 4 and
          8): one K6, K6b, K2, K2b a step exactly, K6d one sweep an alpha
          event, the median step by stage, the events' seconds, peak memory
  static_step  one full-width step on the blob field: launches, grads
          through the kernels vs the card's plain versions, a 256-ray
          batch's vs the port on the CPU in float64
  static_frame  a fresh 199^3 mask and the masked 400^2 frame (4096-ray
          chunks: K6, K3, K2 40 each) on the trained field and on the blob
          field; rays/s; 256 spread rays vs the CPU
  static_cp  TensorCP through the CLI (4 iterations: an upsample to
          199^3, a mask and shrink), then an unmasked frame
  static_learns  StaticTrainer on tests/test_static.py's tiny scene for 120
          steps: psnr_0 must rise by more than 4 dB
The script prints its seconds by phase. The last three lines are the card line from nvidia-smi, the kernels JSON line
(nineteen entries: the eight kernels, the three bf16 arms, the two
colourless arms, K6, K6d, K6b and their CP arms) and the result line
{"ok": true, "device": {...}}.

The numbers it prints are this card's, at its power limit; bounds use the
H100 SXM data-sheet peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 without tensor
cores; the bf16 arms of K1, K1d and K1b, whose arithmetic is packed bf16x2,
at the 133.8 TFLOP/s of bf16 without tensor cores, Hopper white paper).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dataclasses import replace

from nvfi_torch import (eval_all, render_video, test_segm_render, test_transfer_vel, train_nvfi,
                        train_segm)
from nvfi_torch.config import CfgNode, load_config
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.data.blender import _spherical_pose
from nvfi_torch.eval import harness, velocity_eval
from nvfi_torch.eval.metrics import mse2psnr
from nvfi_torch.fields import kplane, shaders, tensorf_vm
from nvfi_torch.ops import compositing, gather, grid_sample, kernels, occupancy, plane_line
from nvfi_torch.render import rays, renderer
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint, optim, segm, static, trainer, turbo
from nvfi_torch.train.trainer import n_to_reso
from nvfi_torch.utils import point_viz

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
# (wrapper, attribute); the bf16 arms of K1, K1d and K1b and the colourless
# arms of K2 and K2b count apart
COUNTERS = {
    "plane_product_fwd": (grid_sample.plane_product, "launches"),
    "plane_product_density_fwd": (grid_sample.plane_product_density, "launches"),
    "composite_fwd": (compositing.composite, "launches"),
    "occupancy_trilinear_fwd": (occupancy.occupancy_trilinear, "launches"),
    "occupancy_nearest_fwd": (occupancy.occupancy_nearest, "launches"),
    "row_gather_fwd": (gather.row_gather, "launches"),
    "plane_product_bwd": (grid_sample.plane_product_backward, "launches"),
    "composite_bwd": (compositing.composite_backward, "launches"),
    "composite_fwd_colourless": (compositing.composite_weights, "launches"),
    "composite_bwd_colourless": (compositing.composite_weights_backward, "launches"),
    "plane_product_fwd_bf16": (grid_sample.plane_product, "launches_bf16"),
    "plane_product_density_fwd_bf16": (grid_sample.plane_product_density, "launches_bf16"),
    "plane_product_bwd_bf16": (grid_sample.plane_product_backward, "launches_bf16"),
    "plane_line_fwd": (plane_line.plane_line, "launches"),
    "plane_line_fwd_cp": (plane_line.plane_line, "launches_cp"),
    "plane_line_density_fwd": (plane_line.plane_line_density, "launches"),
    "plane_line_density_fwd_cp": (plane_line.plane_line_density, "launches_cp"),
    "plane_line_bwd": (plane_line.plane_line_backward, "launches"),
    "plane_line_bwd_cp": (plane_line.plane_line_backward, "launches_cp"),
}
BF16 = torch.bfloat16


# the kernel functions of nvfi_torch/csrc, as the profiler names them
PORT_KERNELS = ("plane_product_kernel", "plane_product_bwd_kernel", "composite_fwd_kernel",
                "composite_bwd_kernel", "occupancy_trilinear_fwd_kernel",
                "occupancy_nearest_fwd_kernel", "row_gather_fwd_kernel", "plane_line_fwd_kernel",
                "plane_line_bwd_kernel")


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


# threads of a block of K1, K1d, K1b (f32 arm) and K3 (kThreads of
# plane_product.cu, plane_product_bwd.cu and occupancy.cu), and of K1b.bf16
SAMPLE_THREADS, K1B_BF16_THREADS = 256, 128
FLOOR_MS = {}  # (blocks, threads) -> the empty kernel's device time, ms


def floor_at(blocks, threads):
    """Device time of the empty kernel of csrc/floor.cu launched as
    <<<blocks, threads>>> (graph_ms: 20 launches a graph): what a launch of
    that grid takes on this card before any work.  Cached by grid."""
    key = (int(blocks), int(threads))
    if key not in FLOOR_MS:
        lib, dev = kernels.load(), torch.device("cuda", torch.cuda.current_device())
        FLOOR_MS[key] = graph_ms(lambda: kernels.check(
            lib.nvfi_floor_empty(key[0], key[1], kernels.stream_ptr(dev)), "floor_empty"))
    return FLOOR_MS[key]


def with_floor(numbers, grid):
    """``numbers`` (a kernel's timings at one shape) with the grid it was
    launched at and the launch floor of that grid."""
    numbers["grid"] = [int(g) for g in grid]
    numbers["floor_ms"] = floor_at(*grid)
    return numbers


def run_grid(P, run, threads=SAMPLE_THREADS):
    """The grid of a kernel whose blocks own runs of ``run`` samples."""
    return -(-P // run), threads


def composite_grid(N, plan):
    """The grid of K2 or K2b for N rays under ``plan``."""
    return -(-N // plan.rays_per_block), plan.rays_per_block * plan.warps_per_ray * 32


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
    # the CLIs' optional packages (matplotlib: test_segm_render's PNG snapshot)
    for name in ("PIL", "imageio", "tqdm", "wandb", "matplotlib"):
        try:
            importlib.import_module(name)
            print(f"[env] {name} imports")
        except ImportError as e:
            print(f"[env] {name} does not import: {e}")
    return card


def phase_build():
    info = kernels.build(verbose=True)
    kernels.load()
    print(f"[build] {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")) \
                or line.startswith("=="):
            print(f"[build]   {line.strip()}")


def phase_floor(meta, device):
    """The launch floor: the empty kernel of csrc/floor.cu at <<<1, 32>>> and
    at the grids of one thread a sample in blocks of 256 (K3's, and K4's
    first design's) at the pruned train step's two shapes (a train chunk,
    the PDE prefilter) and a render chunk's; at the same grids the touch
    kernel (12 bytes read, one byte written a thread), which adds the first
    DRAM round trip.  Each kernel entry gets the floor of its own grid
    (floor_at) in its phase."""
    print(f"[floor] empty kernel <<<1, 32>>>: {floor_at(1, 32):.5f} ms (graph_ms, 20 launches a "
          f"graph)")
    sizes = {"train chunk": TRAIN_RAYS * meta.n_samples,
             "prefilter": bat_train_hp().vel_reg_n_pts, "render chunk": CHUNK * meta.n_samples}
    rng = np.random.RandomState(SEED + 17)
    xyz = torch.tensor(rng.uniform(-1.1, 1.1, (max(sizes.values()), 3)).astype(np.float32),
                       device=device)
    lib = kernels.load()
    out = {"empty_1x32_ms": FLOOR_MS[(1, 32)]}
    for name, P in sizes.items():
        pts, touched = xyz[:P], torch.empty(P, dtype=torch.uint8, device=device)

        def touch():
            kernels.check(lib.nvfi_floor_touch(pts.data_ptr(), P, touched.data_ptr(),
                                               kernels.stream_ptr(device)), "floor_touch")

        touch()
        want = (pts[:, 0] + pts[:, 1] + pts[:, 2]) > 0
        torch.cuda.synchronize()
        require(torch.equal(touched.bool(), want), f"floor touch kernel at P={P} is wrong")
        grid = run_grid(P, SAMPLE_THREADS)
        empty_ms, touch_ms = floor_at(*grid), graph_ms(touch)
        b_ms, _ = bound_ms(P * 13, 0)
        print(f"[floor] {name} P={P} <<<{grid[0]}, {grid[1]}>>>: empty {empty_ms:.5f} ms, touch "
              f"{touch_ms:.5f} ms (12 B in and 1 B out a thread, {P * 13 / 1e6:.2f} MB: bound "
              f"{b_ms:.5f} ms)")
        out[name] = {"P": P, "grid": list(grid), "empty_ms": empty_ms, "touch_ms": touch_ms,
                     "touch_bound_ms": b_ms}
    return out


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


def grid_ordered_xyz(meta, grid, chunk_index, device):
    """One chunk of a mask sweep's normalized points over ``grid``, as
    compute_dense_alpha orders them (z fastest): (ALPHA_CHUNK, 3)."""
    a = meta.aabb_np
    lin = [np.linspace(0.0, 1.0, g, dtype=np.float32) for g in grid]
    mesh = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1).reshape(-1, 3)
    part = mesh[chunk_index * ALPHA_CHUNK:(chunk_index + 1) * ALPHA_CHUNK]
    xyz = (((a[0] * (1 - part) + a[1] * part) - a[0]) * (2.0 / (a[1] - a[0])) - 1.0)
    return torch.tensor(xyz.astype(np.float32), device=device)


def grid_ordered_xyzt(meta, t, chunk_index, device):
    """One chunk of the mask sweep's points at a keyframe time t:
    (ALPHA_CHUNK, 4)."""
    xyz = grid_ordered_xyz(meta, tuple(min(g, 200) for g in meta.grid_size), chunk_index, device)
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
    return with_floor(entry, run_grid(P, plan.run))


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
        out[N] = with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "plan": plan.__dict__}, composite_grid(N, plan))
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


def recorded_chunk_inputs(meta, params, hp, ray_o, ray_d, target, t, jitter, advect,
                          bg_coin=None):
    """K1's coords and K1b's incoming grads in one train chunk, rendered as
    make_loss_fn renders it and its share of the rgb loss back-propagated;
    recorded by hooks on K1's two outputs, launches uncounted.  Returns
    (xyzt (P, 4) ray-major, g_density, g_app)."""
    leaves = kplane.map_params(lambda x: x.detach().requires_grad_(True), params)
    seen = {}

    def recording_plane_product(planes_space, planes_time, xyzt, cd, **kw):
        density, app = grid_sample.plane_product(planes_space, planes_time, xyzt, cd, **kw)
        seen["xyzt"] = xyzt.detach()
        density.register_hook(lambda g: seen.__setitem__("gd", g))
        app.register_hook(lambda g: seen.__setitem__("ga", g))
        return density, app

    with patched(kplane, "plane_product", recording_plane_product), uncounted():
        out = kplane.render_rays(leaves, meta, t, ray_o, ray_d, white_bg=hp.white_bg,
                                 training=True, advect=advect, jitter=jitter, bg_coin=bg_coin,
                                 device=ray_o.device)
        (torch.sum((out["rgb"] - target) ** 2) / (hp.n_rays * 3)).backward()
    return [seen[k].contiguous() for k in ("xyzt", "gd", "ga")]


def train_chunk_grad_inputs(meta, params, white_bg, pose, unmasked, device):
    """K1b's inputs in one real train chunk: the first 128-ray chunk of the
    keyframe batch at t = 0.4 (the draws' first pixels and jitter, no
    advection, the train phases' start params)."""
    hp, start, (poses, images, _) = train_set_up(meta, params, unmasked, pose, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    draws = trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE)
    pix = draws.pix_0[:TRAIN_RAYS]
    ii, jj = pix // IMAGE, pix % IMAGE
    ray_o, ray_d = trainer._rays_from_pose(poses[0], IMAGE, IMAGE, FOCAL, ii, jj)
    return recorded_chunk_inputs(meta, start, hp, ray_o, ray_d, images[0][ii, jj], TIMES[0],
                                 draws.jitter_0[0][:TRAIN_RAYS], False,
                                 None if white_bg else draws.coin_0[0])


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
    return with_floor(entry, run_grid(P, plan.run))


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
        out[N] = with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "plan": plan.__dict__, "forward_ms_at_this_shape": fwd_ms,
                             "forward_alone_ms_at_this_shape": fwd_alone_ms,
                             "forward_max_abs_err_at_this_shape": fwd_err},
                            composite_grid(N, plan))
    entry = {"name": "composite_bwd", "route": "cuda",
             "source": "nvfi_torch/csrc/composite_bwd.cu",
             "replaces": "nvfi_tpu/ops/compositing.py:17 (its VJP)", "library_ms": None,
             "render_shape": out[CHUNK]}
    entry.update(out[TRAIN_RAYS])
    return entry


TURBO_RAYS = 256  # rays of a turbo train chunk: ray_chunking under bat's probed block budget


def padded_samples(meta):
    """The block-sparse sample axis: n_samples padded to whole blocks (688)."""
    return -(-meta.n_samples // meta.sample_block) * meta.sample_block


def phase_k2_colourless(meta, white_bg, device):
    """The colourless arms of K2 and K2b (no colour in, none out: the top-K
    shade's compositing) at turbo's padded axis, (4096, 688) and (256, 688):
    weight, acc, depth and grad_sigma bit for bit the colour arms' on the
    same inputs, against their plain versions, alone times (graphs) beside
    the colour arms', bounds and floors."""
    S, S0 = padded_samples(meta), meta.n_samples
    thres, far = meta.raymarch_weight_thres, meta.near_far[1]
    fwd, bwd = {}, {}
    for N in (CHUNK, TURBO_RAYS):
        args = composite_inputs(N, S, meta.step_size, device)
        args[0][:, S0:] = 0.0  # the padded samples: invalid, and the last real dist 0
        args[1][:, S0 - 1:] = 0.0
        sigma, dist, z, _ = args
        weight, acc, depth = compositing.composite_weights(sigma, dist, z, far)
        colour = compositing.composite(*args, thres, white_bg, far)
        plain = compositing.composite_weights_reference(sigma, dist, z, far)
        torch.cuda.synchronize()
        for name, got, want in zip(("weight", "acc", "depth"), (weight, acc, depth),
                                   (colour[0], colour[1], colour[3])):
            require(torch.equal(got, want), f"K2 colourless N={N}: {name} is not the colour "
                    f"arm's bit for bit")
        check_close(f"K2 colourless N={N}", (weight, acc, depth), plain, rtol=1e-4,
                    atol_rel=1e-5)  # scan association, as in phase K2
        err = max_err((weight, acc, depth), plain)
        ms = time_ms(lambda: compositing.composite_weights(sigma, dist, z, far), reps=50)
        alone_ms = graph_ms(lambda: compositing._launch_composite(sigma, dist, z, None, thres,
                                                                  False, far, False))
        colour_ms = graph_ms(lambda: compositing._launch_composite(*args, thres, white_bg, far,
                                                                   False))
        plain_ms = time_ms(lambda: compositing.composite_weights_reference(sigma, dist, z, far),
                           reps=20)
        # sigma, dist, z in; weight out; acc and depth out
        n_bytes, n_ops = N * S * 16 + N * 8, N * S * 9
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        plan = compositing.composite_plan(N, S, compositing.composite_target_warps(
            sigma.device.index))
        fwd[N] = with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                             "colour_arm_alone_ms": colour_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "shape": [N, S],
                             "plan": plan.__dict__}, composite_grid(N, plan))
        print(f"[K2.colourless] N={N} S={S}: weight, acc, depth equal the colour arm's bit for "
              f"bit; max_abs_err {err:.3e} against the plain version; kernel {ms:.4f} ms "
              f"(wrapper), {alone_ms:.5f} ms alone (the colour arm {colour_ms:.5f}), floor "
              f"{fwd[N]['floor_ms']:.5f} ms at grid {fwd[N]['grid']}; plain {plain_ms:.4f} ms, "
              f"library none; bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB)")

        # the backward as the top-K step runs it: g_weight (the gather's scatter,
        # on samples above the threshold) and g_acc (the background)
        rng = np.random.RandomState(SEED + 14)
        g_weight = torch.tensor(rng.randn(N, S).astype(np.float32), device=device)
        g_weight = torch.where(weight > thres, g_weight, 0.0)
        g_acc = torch.tensor(rng.randn(N).astype(np.float32), device=device)
        got = compositing.composite_weights_backward(sigma, dist, z, weight, g_acc, None,
                                                     g_weight, far)
        same = compositing.composite_backward(*args, weight, None, None, g_acc, None, g_weight,
                                              thres, white_bg, far)[0]
        want = compositing.composite_weights_backward_reference(sigma, dist, z, g_acc, None,
                                                                g_weight, far)
        torch.cuda.synchronize()
        require(torch.equal(got, same), f"K2b colourless N={N}: grad_sigma is not the colour "
                f"arm's bit for bit")
        check_close(f"K2b colourless N={N}", [got], [want], rtol=GRAD_RTOL,
                    atol_rel=GRAD_ATOL_REL)
        err = max_err([got], [want])
        ms = time_ms(lambda: compositing.composite_weights_backward(
            sigma, dist, z, weight, g_acc, None, g_weight, far), reps=50)
        alone_ms = graph_ms(lambda: compositing.composite_weights_backward(
            sigma, dist, z, weight, g_acc, None, g_weight, far))
        colour_ms = graph_ms(lambda: compositing.composite_backward(
            *args, weight, None, None, g_acc, None, g_weight, thres, white_bg, far))
        plain_ms = time_ms(lambda: compositing.composite_weights_backward_reference(
            sigma, dist, z, g_acc, None, g_weight, far), reps=10)
        # sigma, dist, weight, g_weight in (no z without a depth grad); grad_sigma out; g_acc
        n_bytes, n_ops = N * S * 20 + N * 4, N * S * 25
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        plan = compositing.composite_bwd_plan(N, S, compositing.composite_target_warps(
            sigma.device.index))
        bwd[N] = with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                             "colour_arm_alone_ms": colour_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "shape": [N, S],
                             "plan": plan.__dict__}, composite_grid(N, plan))
        print(f"[K2b.colourless] N={N} S={S}: grad_sigma equals the colour arm's (without "
              f"g_rgb) bit for bit; max_abs_err {err:.3e} against the plain backward (rtol "
              f"{GRAD_RTOL}, atol {GRAD_ATOL_REL} x max|grad|); kernel {ms:.4f} ms (wrapper), "
              f"{alone_ms:.5f} ms alone (the colour arm {colour_ms:.5f}), floor "
              f"{bwd[N]['floor_ms']:.5f} ms at grid {bwd[N]['grid']}; plain {plain_ms:.4f} ms, "
              f"library none; bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB)")
    replaces = "nvfi_tpu/ops/compositing.py:17 + nvfi_tpu/fields/kplane.py:886-887, 990"
    fwd_entry = {"name": "composite_fwd_colourless", "route": "cuda",
                 "source": "nvfi_torch/csrc/composite.cu", "replaces": replaces,
                 "library_ms": None, "render_shape": fwd[CHUNK]}
    fwd_entry.update(fwd[TURBO_RAYS])  # the line's numbers: the turbo train chunk
    bwd_entry = {"name": "composite_bwd_colourless", "route": "cuda",
                 "source": "nvfi_torch/csrc/composite_bwd.cu",
                 "replaces": replaces + " (its VJP)", "library_ms": None,
                 "render_shape": bwd[CHUNK]}
    bwd_entry.update(bwd[TURBO_RAYS])
    return fwd_entry, bwd_entry


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
    plan = grid_sample.plane_product_inputs(list(ps) + list(pt), cd, True, torch.float32)[2]
    return with_floor(entry, run_grid(P, plan.run))


def phase_k5(meta, picks, sparse, device):
    """K5: the two Pallas probes' gather as a path of its own, then the kernel
    against its plain version there and at turbo's three picks of bat, as the
    `split_sparse` path made them (the middle chunk of its first frame)."""
    # -- the probe's path: counts set to 0 just before, read just after -----
    # what tests/test_mosaic_probe.py and scripts/perf_micro2.py ask of the
    # TPU toolchain: gather 1024 rows of a (512, 128) table of ones and sum
    probe = (torch.ones(512, 128, device=device),
             (torch.arange(1024, device=device) % 512).to(torch.int32))
    reset_counts()
    total = float(gather.row_gather(*probe).sum())
    launches = read_counts()
    # ------------------------------------------------------------------------
    print(f"[K5] row-gather probe: OK, sum={total}")
    require(total == 1024 * 128, f"probe sum {total}")
    require(launches["row_gather_fwd"] == 1, f"probe launches {launches}")

    sel = picks["xyz"][1]
    n_blocks = picks["xyz"][0].shape[0]
    print(f"[K5] turbo's picks of the middle {CHUNK}-ray chunk of `split_sparse`'s frame at "
          f"t={TIMES[0]}: blocks of {meta.sample_block} samples, {n_blocks} blocks, B = "
          f"{sel.shape[0]} (budget {sparse['budget']:.4f})")
    require(all(torch.equal(idx, sel) for _, idx in picks.values()), "the picks' indices differ")
    shapes = {"probe": probe}
    shapes.update({f"pick_{name}": picks[name] for name in ("xyz", "t", "base_times")})
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    out = {}
    for name, (tab, idx) in shapes.items():
        got = gather.row_gather(tab, idx)
        want = gather.row_gather_reference(tab, idx)
        # the same indices into a seeded table of the same shape, whose rows
        # all differ: a kernel that reads a wrong row fails here even where
        # the real table's rows are equal (the probe's ones, the picks' t)
        distinct = torch.randn(tab.shape, generator=gen, device=device)
        got_distinct = gather.row_gather(distinct, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K5 {name}: the gather is not exact")  # a copy
        require(torch.equal(got_distinct, gather.row_gather_reference(distinct, idx)),
                f"K5 {name}: the gather from a table of distinct rows is not exact")
        n, C = idx.shape[0], tab.shape[1]
        buf = torch.empty(n, C, device=device)

        def alone():  # no index check, which reads back: what a graph captures
            gather.launch_row_gather(tab, idx, buf)

        alone()
        torch.cuda.synchronize()
        require(torch.equal(buf, want), f"K5 {name}: the kernel alone is not exact")
        alone_ms = graph_ms(alone)
        ms = time_ms(lambda: gather.row_gather(tab, idx), reps=50)
        pick_ms = time_ms(lambda: gather.pick_rows(tab, idx), reps=50)  # no read-back
        plain_ms = graph_ms(lambda: gather.row_gather_reference(tab, idx))
        library_ms = graph_ms(lambda: torch.index_select(tab, 0, idx))
        # each output row written once, each distinct table row read once, the indices
        n_bytes = n * C * 4 + int(torch.unique(idx).numel()) * C * 4 + n * 4
        b_ms, b_by = bound_ms(n_bytes, 0)
        width = 4 if C % 4 == 0 else 1  # a thread a float4 of the output, else a float
        grid = (-(-(n * C // width) // gather.ROW_GATHER_THREADS), gather.ROW_GATHER_THREADS)
        numbers = with_floor({"ms": ms, "pick_rows_ms": pick_ms, "kernel_alone_ms": alone_ms,
                              "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "shape": [n, tab.shape[0], C]}, grid)
        print(f"[K5] {name}: {n} rows of {C} floats from {tab.shape[0]} rows, exact (and from "
              f"a table of distinct rows); kernel {ms:.4f} ms through the wrapper (host: its "
              f"index-range check reads two numbers back), {pick_ms:.4f} ms through pick_rows "
              f"(no read-back), {alone_ms:.5f} ms alone (graph), "
              f"floor {numbers['floor_ms']:.5f} ms at grid {numbers['grid']}; plain "
              f"{plain_ms:.5f} ms, library (index_select) {library_ms:.5f} ms, both graphs; "
              f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.3f} MB); kernel alone / library "
              f"{alone_ms / library_ms:.3f}")
        out[name] = numbers
    entry = {"name": "row_gather_fwd", "route": "cuda", "source": "nvfi_torch/csrc/row_gather.cu",
             "replaces": "tests/test_mosaic_probe.py:35, scripts/perf_micro2.py:86",
             "max_abs_err": 0.0, "pick_blocks": n_blocks, "pick_B": int(sel.shape[0]),
             "pick_shapes": {k: v for k, v in out.items() if k != "probe"}}
    entry.update(out["probe"])  # the line's numbers are the probe's (the shape its path runs)
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
    with_floor(entry, run_grid(xyz.shape[0], SAMPLE_THREADS))
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
    vol, dil, occ = alpha_state["volume"], alpha_state["dilated"], alpha_state["occupied"]
    require(torch.equal(occ, occupancy.occupied_bits(dil)),
            "the mask's occupied bits are not those of its dilated volume")
    xyz, box = mask_kernel_inputs(meta, alpha_state, new_aabb, device)
    P, a = xyz.shape[0], meta.aabb_np
    got = occupancy.occupancy_nearest(dil, occ, xyz, a, box)
    want = occupancy.occupancy_nearest_reference(dil, xyz, a, box)
    tri = occupancy.occupancy_trilinear(vol, alpha_state["bits"], xyz, a, box) > 0
    torch.cuda.synchronize()
    wrong = int((got != want).sum())
    require(wrong == 0, f"K4: {wrong} of {P} samples differ from the plain version")  # exact
    require(bool((got | ~tri).all()), "K4 dropped a sample that trilinear > 0 keeps")
    extra = int((got & ~tri).sum())
    print(f"[K4] occupied bits {tuple(occ.shape)} int32 ({occ.numel() * 4 / 1e6:.2f} MB; the "
          f"dilated volume {dil.numel() * 4 / 1e6:.1f} MB)")
    out = {}
    # the render chunk's shape (for the record, beside K3) and the pruned
    # train step's two: the PDE prefilter's points and one train chunk of samples
    D, H, W = dil.shape
    Dc, Hc, words = occ.shape
    for name, pts in (("render", xyz), ("prefilter", xyz[: bat_train_hp().vel_reg_n_pts]),
                      ("train", xyz[: TRAIN_RAYS * meta.n_samples])):
        n = pts.shape[0]
        require(torch.equal(occupancy.occupancy_nearest(dil, occ, pts, a, box), want[:n]),
                f"K4 at the {name} shape differs from the plain version")
        ms = time_ms(lambda: occupancy.occupancy_nearest(dil, occ, pts, a, box), reps=50)
        alone_ms = graph_ms(lambda: occupancy.occupancy_nearest(dil, occ, pts, a, box))
        plain_ms = time_ms(lambda: occupancy.occupancy_nearest_reference(dil, pts, a, box), reps=5)
        # bound: coords in, one byte out, the 32-byte sectors of the occupied
        # bits that the samples' cells fall in (the whole bits beside it, and
        # the sectors of the f32 dilated volume that the first design read)
        cell = occupancy.mask_cells(torch.nan_to_num(
            occupancy.mask_pixels(pts, a, box, dil.shape)), dil.shape)
        sectors = distinct_sectors((cell[:, 2] * Hc + cell[:, 1]) * words + cell[:, 0] // 32)
        volume_sectors = distinct_sectors((cell[:, 2] * H + cell[:, 1]) * W + cell[:, 0])
        n_ops = n * (3 * 12 + 8)
        b_ms, b_by = bound_ms(n * 12 + n + sectors * 32, n_ops)
        whole_ms, _ = bound_ms(n * 12 + n + occ.numel() * 4, n_ops)
        volume_ms, _ = bound_ms(n * 12 + n + volume_sectors * 32, n_ops)
        numbers = with_floor({"ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "bound_whole_bits_ms": whole_ms,
                              "bits_sectors": sectors, "bound_volume_sectors_ms": volume_ms,
                              "volume_sectors": volume_sectors},
                             run_grid(n, occupancy.NEAREST_THREADS, occupancy.NEAREST_THREADS))
        print(f"[K4] {name} shape P={n} exact; a superset of trilinear > 0 ({extra} samples more "
              f"of {P}, share kept {float(want.float().mean()):.4f}); kernel "
              f"{ms:.4f} ms ({alone_ms:.5f} alone), floor {numbers['floor_ms']:.5f} ms at its "
              f"grid, plain {plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms ({b_by}: "
              f"{sectors} sectors of 32 B of the occupied bits, "
              f"{(n * 13 + sectors * 32) / 1e6:.2f} MB; {whole_ms:.5f} ms with the whole bits; "
              f"{volume_ms:.5f} ms with the {volume_sectors} sectors of the f32 dilated volume "
              f"the first design read)")
        out[name] = numbers
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
    return launches, images, {t: fsec for t, fsec, _ in frames}


def frame_chunks(o, d):
    """The CHUNK-ray chunks of a frame as render_image makes them (the last
    one padded with zero origins and copies of the last direction)."""
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    for start in range(0, o.shape[0], CHUNK):
        co, cd = o[start:start + CHUNK], d[start:start + CHUNK]
        pad = CHUNK - co.shape[0]
        if pad:
            co = np.concatenate([co, np.zeros((pad, 3), co.dtype)])
            cd = np.concatenate([cd, np.tile(d[-1:], (pad, 1))])
        yield co, cd


def active_block_shares(meta, alpha_state, o, d, device):
    """Per chunk of the frame, the share of its blocks of ``sample_block``
    samples that hold a valid sample (in the box, trilinear mask > 0: the eval
    render's test), as the block-sparse axis of render_rays sees them.  The
    test reads the unadvected positions, so the shares do not depend on t."""
    S, S0, SB = padded_samples(meta), meta.n_samples, meta.sample_block
    shares = []
    with torch.inference_mode():
        for co, cd in frame_chunks(o, d):
            co = torch.tensor(co, dtype=torch.float32, device=device)
            cd = torch.tensor(cd, dtype=torch.float32, device=device)
            pts, _, valid = kplane.sample_ray(meta, co, cd, S)
            valid = valid & (torch.arange(S, device=device) < S0)
            valid = valid & (kplane.sample_alpha(alpha_state, kplane.normalize_coord(meta, pts),
                                                 meta) > 0)
            shares.append(float(valid.reshape(-1, SB).any(-1).float().mean()))
    return shares


def block_budget_blocks(budget, total_b):
    """B of the block-sparse axis for ``total_b`` blocks (JAX kplane.py:855)."""
    return min(total_b, max(8, (int(budget * total_b) + 7) // 8 * 8))


SPLIT_SPARSE_ATOL = 1e-5  # a turbo frame against the dense masked frame, max |rgb|


def phase_split_sparse(meta, params, white_bg, card, pose, o, d, alpha_state, dense_images,
                       dense_secs, device):
    """render_split(sparse_budget=...) with the mask of `alpha` over the views of
    `split`: the block-sparse axis, its picks through K5 with no read-back.
    Each frame against the dense masked frame of `split`; rays/s beside its;
    the picks of the middle chunk of the first frame kept for phase K5."""
    S, SB = padded_samples(meta), meta.sample_block
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    shares = active_block_shares(meta, alpha_state, o, d, device)
    budget = max(shares) * 1.3
    total_b = CHUNK * (S // SB)
    B = block_budget_blocks(budget, total_b)
    print(f"[split_sparse] active blocks of {SB} samples per {CHUNK}-ray chunk: share max "
          f"{max(shares):.4f}, mean {np.mean(shares):.4f} (the same at every t); sparse_budget "
          f"= 1.3 x max = {budget:.4f}: B = {B} of {total_b} blocks, P = B x {SB} = {B * SB} "
          f"samples a chunk (dense: {CHUNK * meta.n_samples})")
    require(0.0 < budget < 1.0, f"sparse budget {budget}")
    dataset = ({"test": np.stack([dense_images[t]["rgb"] for t in TIMES])},
               {"test": np.stack([pose] * len(TIMES))}, {"test": np.asarray(TIMES)},
               {"test": len(TIMES)}, None, None, (IMAGE, IMAGE, FOCAL))
    frames, images, picks = [], {}, {}
    inner, inner_pick = harness.render_image, kplane.pick_rows
    calls = [0]

    def timed_render_image(p, m, t, *args, **kwargs):
        before = read_counts()
        t0 = time.perf_counter()
        images[t] = inner(p, m, t, *args, **kwargs)
        after = read_counts()
        frames.append((t, time.perf_counter() - t0, {k: after[k] - before[k] for k in after}))
        return images[t]

    def recording_pick(tab, idx):  # keeps the middle chunk's three picks of the first frame
        chunk, which = divmod(calls[0], 3)
        calls[0] += 1
        if chunk == n_chunks // 2:
            picks[("xyz", "t", "base_times")[which]] = (tab, idx)
        return inner_pick(tab, idx)

    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    harness.render_image, kplane.pick_rows = timed_render_image, recording_pick
    try:
        t0 = time.perf_counter()
        preds, errors = harness.render_split(params, meta, dataset, "test", white_bg=white_bg,
                                             alpha_state=alpha_state, chunk=CHUNK,
                                             sparse_budget=budget, device=device)
        sec = time.perf_counter() - t0
    finally:
        harness.render_image, kplane.pick_rows = inner, inner_pick
    launches = read_counts()
    # ------------------------------------------------------------------------

    want = {k: 0 for k in launches}
    want.update(plane_product_fwd=n_chunks, composite_fwd=n_chunks,
                occupancy_trilinear_fwd=n_chunks, row_gather_fwd=3 * n_chunks)
    out = {"budget": budget, "share_max": max(shares), "B": B, "P": B * SB, "frames": {}}
    for t, fsec, counts in frames:
        gap = float(np.abs(images[t]["rgb"] - dense_images[t]["rgb"]).max())
        print(f"[split_sparse] t={t}: {IMAGE}x{IMAGE} in {fsec:.3f} s = {IMAGE * IMAGE / fsec:.0f} "
              f"rays/s on the block-sparse axis (the dense masked frame of `split`: "
              f"{IMAGE * IMAGE / dense_secs[t]:.0f} rays/s); launches K1 "
              f"{counts['plane_product_fwd']}, K2 {counts['composite_fwd']}, K3 "
              f"{counts['occupancy_trilinear_fwd']}, K5 {counts['row_gather_fwd']}; dropped "
              f"{images[t]['dropped']}; max |rgb - dense masked rgb| {gap:.3e} [{card}]")
        require(counts == want, f"t={t}: launches {counts}, want {want}")
        require(images[t]["dropped"] == 0.0, f"t={t}: dropped {images[t]['dropped']}")
        require(gap <= SPLIT_SPARSE_ATOL, f"t={t}: the turbo frame differs from the dense "
                f"masked frame by {gap:.3e} > {SPLIT_SPARSE_ATOL}")
        out["frames"][str(t)] = {"rays_per_s": IMAGE * IMAGE / fsec,
                                 "dense_rays_per_s": IMAGE * IMAGE / dense_secs[t],
                                 "max_abs_rgb_vs_dense": gap}
    require(preds.shape == (len(TIMES), IMAGE, IMAGE, 3) and np.isfinite(preds).all(),
            f"preds {preds.shape}")
    require(sorted(picks) == ["base_times", "t", "xyz"] and calls[0] == 3 * n_chunks * len(TIMES),
            f"picks recorded {sorted(picks)}, {calls[0]} pick calls")
    print(f"[split_sparse] render_split(sparse_budget={budget:.4f}): {len(TIMES)} views in "
          f"{sec:.3f} s; metrics {errors}")
    # the middle chunk traced, dense masked and block-sparse, per step bucket
    mid = IMAGE * IMAGE // 2
    co, cd = o.reshape(-1, 3)[mid:mid + CHUNK], d.reshape(-1, 3)[mid:mid + CHUNK]
    out["traced_chunks"] = {}
    for t in (TIMES[0], TIMES[2]):
        steps = adv_steps_for(meta, t)
        for name, m in (("dense masked", meta), ("block-sparse", replace(meta,
                                                                         block_budget=budget))):
            profile_call(f"{name} render chunk with the mask, t={t} ({steps} steps)",
                         lambda: kplane.render_rays(params, m, t, co, cd, white_bg=white_bg,
                                                    adv_steps=steps, alpha_state=alpha_state,
                                                    device=device))
            out["traced_chunks"][f"{name}, t={t}"] = dict(LAST_PROFILE)
    return launches, picks, out


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
    return hp, redrawn_shader(meta, params, device), (poses, images, times)


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


def grad_shares(tag, what, got, want, rtol, atol_rel, check=True):
    """Per leaf of two {path: grad} trees, the largest |got - want| as a share
    of the leaf's largest grad, printed with the worst leaf; fails past
    rtol |want| + atol_rel max|want| (with ``check``)."""
    shares, failed = {}, []
    for k, w in want.items():
        g = got[k]
        require((g is None) == (w is None), f"{tag} chunk grads: {k} is missing on one side")
        if w is None:
            continue
        scale = max(float(w.abs().max()), 1e-30)
        shares[k] = float((g - w).abs().max()) / scale
        if bool(((g - w).abs() > atol_rel * scale + rtol * w.abs()).any()) or \
                not bool(torch.isfinite(g).all()):
            failed.append(f"{k} ({shares[k]:.2e})")
    worst = max(shares, key=shares.get)
    print(f"[{tag}] {what}: {len(shares)} leaves, tolerance rtol {rtol} + {atol_rel} x "
          f"max|grad|; worst {worst} at {shares[worst]:.2e} of its largest grad; "
          f"{len(failed)} leaves past it")
    require(not (check and failed), f"{tag}: {what}: grads differ (share of the largest "
            f"grad): {failed}")
    return shares


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
        rgb_gap = float((rgbs[got_name] - rgbs[want_name]).abs().max())
        return grad_shares("train", f"grads of one {n}-ray chunk at t={TIMES[1]}, {tag} (rgb "
                           f"differs by {rgb_gap:.2e})", grads[got_name], grads[want_name],
                           rtol, atol_rel, check)

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


def counted_steps(train_step, params, opt_state, counters, draws, its, data, hp, alpha_state):
    """The main path of a train phase: ``draws[k]`` at global step ``its[k]``,
    each step synchronized and timed with the launches it made; the counts
    are set to 0 just before and read just after.  Returns (params,
    opt_state, counters, steps, launches), a (seconds, launches, metrics) a
    step."""
    reset_counts()
    steps = []
    for d, it in zip(draws, its):
        count0 = read_counts()
        t0 = time.perf_counter()
        params, opt_state, counters, metrics = train_step(
            params, opt_state, counters, d, 1, 0, it, *data, hp.L1_weight_initial, 0.0,
            alpha_state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        count1 = read_counts()
        steps.append((sec, {k: count1[k] - count0[k] for k in count1},
                      {k: float(v) for k, v in metrics.items()}))
    return params, opt_state, counters, steps, read_counts()


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

    opt_state, counters = optim.init_state(start), trainer.init_counters(device)
    draws = [trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE) for _ in range(TRAIN_STEPS + 2)]
    train_params = start
    # warm-up step outside the counted path (cuBLAS workspaces, the allocator)
    train_params, opt_state, counters, _ = train_step(train_params, opt_state, counters, draws[0],
                                                      1, 0, 0, *data, hp.L1_weight_initial, 0.0,
                                                      None)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    torch.cuda.reset_peak_memory_stats()
    its = range(1, TRAIN_STEPS + 1)
    train_params, opt_state, counters, steps, launches = counted_steps(
        train_step, train_params, opt_state, counters, [draws[i] for i in its], its, data, hp,
        None)
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
    require(all(float(v) == 0.0 for v in counters.values()),
            f"a dense step dropped samples: {counters}")

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
    opt_state, counters = optim.init_state(params), trainer.init_counters(device)
    draws = [trainer.draw_train_inputs(gen, meta, hp, IMAGE, IMAGE) for _ in range(PRUNE_STEPS)]
    want = dict(STEP_LAUNCHES, occupancy_nearest_fwd=33)

    # -- the main path: counts set to 0 just before, read just after --------
    params, opt_state, counters, steps, launches = counted_steps(
        train_step, params, opt_state, counters, draws, range(PRUNE_STEPS), data, hp,
        alpha_state)
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(steps):
        print(f"[train_prune] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}, "
              f"vel_pde {m['vel_pde']:.3e}); K4 launches {counts['occupancy_nearest_fwd']} "
              f"[{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: metrics {m}")
        require(counts == {k: want.get(k, 0) for k in counts},
                f"step {i}: launches {counts}, want {want}")
    profile_call("pruned train step (static_dynamic, full width)", lambda: train_step(
        params, opt_state, counters, draws[-1], 1, 0, PRUNE_STEPS, *data, hp.L1_weight_initial,
        0.0, alpha_state))
    return launches, step_numbers(hp, [sec for sec, _, _ in steps], steps[0][1])


def step_numbers(hp, secs, launches):
    """s/step (median), rays/s, launches a step and the last traced step."""
    step_s = float(np.median(secs))
    return {"step_s": step_s, "rays_per_s": 2 * hp.n_rays / step_s,
            "launches_a_step": sum(launches.values()), "traced_step": dict(LAST_PROFILE)}


TURBO_STEPS = 3


def config_shade_fraction():
    """bat.yaml's shade_fraction, the cap of the probed shade (0.25)."""
    return float(load_config(str(CONFIG)).nvfi.get("shade_fraction", 1.0))


def step_launches(meta, hp, arm=""):
    """The launches of one static_dynamic train step of ``meta``'s stage: per
    chunk of both batches K1 and K1b (of the arm) and K2 / K2b (their
    colourless arms under the top-K shade), K4 where the mask prunes and
    three K5 picks on the block-sparse axis; in the PDE loss K1d twice and,
    where the mask prunes, K4 once (the prefilter)."""
    n = 2 * trainer.ray_chunking(meta, hp)[1]
    topk = 0.0 < meta.shade_fraction < 1.0
    fwd, bwd = (("composite_fwd_colourless", "composite_bwd_colourless") if topk
                else ("composite_fwd", "composite_bwd"))
    want = {f"plane_product_fwd{arm}": n, f"plane_product_bwd{arm}": n, fwd: n, bwd: n,
            f"plane_product_density_fwd{arm}": 2}
    if meta.train_occupancy_prune:
        want["occupancy_nearest_fwd"] = n + 1
    if 0.0 < meta.block_budget < 1.0:
        want["row_gather_fwd"] = 3 * n
    return want


def turbo_chunk_grads(tag, dense_meta, tmeta, params, alpha_state, data, hp, draws, device,
                      kernel_tol, cpu_tol):
    """One turbo chunk's per-leaf grads (the random-time batch's first chunk of
    ``draws``, loss sum((rgb - target)^2)) on the card through the kernels,
    against the dense pruned chunk on the same draws (card, kernels) and the
    port on the CPU (plain versions, the same chunk).  Returns the worst shares."""
    poses, images, times = data
    n = trainer.ray_chunking(tmeta, hp)[0]
    pix = draws.pix_t[:n]
    ii, jj = pix // IMAGE, pix % IMAGE
    ray_o, ray_d = trainer._rays_from_pose(poses[1], IMAGE, IMAGE, FOCAL, ii, jj)
    target = images[1][ii, jj]
    jitter = draws.jitter_t[0]
    arm = "_bf16" if tmeta.compute_dtype == "bfloat16" else ""
    cpu = torch.device("cpu")
    alpha_cpu = {k: v.cpu() for k, v in alpha_state.items()}
    runs = {"turbo": (tmeta, device), "dense": (dense_meta, device), "cpu": (tmeta, cpu)}
    grads, outs = {}, {}
    for name, (m, dev) in runs.items():
        p = kplane.map_params(lambda x: x.detach().to(dev).requires_grad_(True), params)
        count0 = read_counts()
        t0 = time.perf_counter()
        out = kplane.render_rays(p, m, times[1].item(), ray_o.to(dev), ray_d.to(dev),
                                 white_bg=hp.white_bg, training=True, jitter=jitter.to(dev),
                                 alpha_state=alpha_state if dev == device else alpha_cpu,
                                 device=dev)
        torch.sum((out["rgb"] - target.to(dev)) ** 2).backward()
        sec = time.perf_counter() - t0
        used = {k: v - count0[k] for k, v in read_counts().items() if v != count0[k]}
        grads[name] = {k: (None if g is None else g.cpu())
                       for k, g in flat_leaves(grad_tree(p)).items()}
        outs[name] = {k: float(out[k]) for k in ("dropped_blocks", "dropped_shade")}
        if name == "turbo":
            want = {k: v // (2 * trainer.ray_chunking(tmeta, hp)[1])
                    for k, v in step_launches(tmeta, hp, arm).items()
                    if not k.startswith("plane_product_density")}
            want["occupancy_nearest_fwd"] = 1
        elif name == "dense":
            want = dict.fromkeys((f"plane_product_fwd{arm}", f"plane_product_bwd{arm}",
                                  "composite_fwd", "composite_bwd", "occupancy_nearest_fwd"), 1)
        else:
            want = {}
        require(used == want, f"{tag} chunk grads, {name}: kernel launches {used}, want {want}")
        print(f"[{tag}] one {n}-ray chunk at t={times[1].item()}, {name}: dropped "
              f"{outs[name]}, {sec:.1f} s")
    require(outs["turbo"] == {"dropped_blocks": 0.0, "dropped_shade": 0.0} == outs["cpu"],
            f"{tag}: the uncapped turbo chunk dropped work: {outs}")

    def compare(what, got, want, rtol, atol_rel):
        return max(grad_shares(tag, f"chunk grads, {what}", grads[got], grads[want], rtol,
                               atol_rel).values())

    return {"turbo_vs_dense_pruned": compare("turbo (kernels) vs dense pruned (kernels)",
                                             "turbo", "dense", *kernel_tol),
            "turbo_vs_cpu": compare("turbo (kernels) vs the CPU (plain versions)", "turbo",
                                    "cpu", *cpu_tol)}


def phase_train_turbo(tag, meta, params, data, hp, alpha_state, prune_numbers, card, pose,
                      device, kernel_tol, cpu_tol, seed):
    """Turbo train steps at bat's width: train_occupancy_prune with the mask of
    ``alpha_state``, block_budget and shade from the port's probe on the train
    pose (bench.py:104-110), the shade capped at bat.yaml's shade_fraction
    (shade_cap_policy).  One uncapped chunk's grads (follow_probe, where no
    shade sample drops) against the dense pruned chunk and the CPU; then
    TURBO_STEPS counted steps with dropped_blocks 0 and exact launches, and
    one traced step, beside the pruned dense step's numbers."""
    arm = "_bf16" if meta.compute_dtype == "bfloat16" else ""
    t0 = time.perf_counter()
    budget, probed = turbo.measure_block_budget(meta, alpha_state, pose[None], IMAGE, IMAGE,
                                                FOCAL, hp.n_rays, with_shade=True)
    probe_s = time.perf_counter() - t0
    cap = config_shade_fraction()
    shade = turbo.shade_cap_policy(probed, cap, follow_probe=False)
    dense_meta = replace(meta, train_occupancy_prune=True)
    tmeta = replace(dense_meta, block_budget=budget, shade_fraction=shade)
    free_meta = replace(tmeta, shade_fraction=turbo.shade_cap_policy(probed, cap, True))
    chunking = trainer.ray_chunking(tmeta, hp)
    print(f"[{tag}] probe on the train pose ({hp.n_rays} rays x 12 batches, {probe_s:.1f} s): "
          f"block_budget {budget:.4f}, shade {probed:.4f} probed, {shade:.4f} capped at {cap}; "
          f"ray chunking {chunking} (dense {trainer.ray_chunking(meta, hp)})")
    require(0.0 < budget < 1.0 and 0.0 < shade < 1.0, f"budgets {budget}, {shade}")
    require(chunking == (TURBO_RAYS, hp.n_rays // TURBO_RAYS), f"ray chunking {chunking}")
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = [trainer.draw_train_inputs(gen, tmeta, hp, IMAGE, IMAGE)
             for _ in range(TURBO_STEPS + 2)]
    grads = turbo_chunk_grads(tag, dense_meta, free_meta, params, alpha_state, data, hp,
                              draws[0], device, kernel_tol, cpu_tol)

    train_step = trainer.make_train_step(tmeta, hp, "static_dynamic", IMAGE, IMAGE, FOCAL,
                                         use_alpha=True, device=device)
    opt_state, counters = optim.init_state(params), trainer.init_counters(device)
    params, opt_state, counters, _ = train_step(params, opt_state, counters, draws[0], 1, 0, 0,
                                                *data, hp.L1_weight_initial, 0.0, alpha_state)
    torch.cuda.synchronize()
    want = step_launches(tmeta, hp, arm)

    # -- the main path: counts set to 0 just before, read just after --------
    its = range(1, TURBO_STEPS + 1)
    params, opt_state, counters, steps, launches = counted_steps(
        train_step, params, opt_state, counters, [draws[i] for i in its], its, data, hp,
        alpha_state)
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(steps, 1):
        print(f"[{tag}] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}); "
              f"dropped_blocks {m['dropped_blocks']:.0f}, dropped_shade "
              f"{m['dropped_shade']:.0f} [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"{tag} step {i}: metrics {m}")
        require(m["dropped_blocks"] == 0.0, f"{tag} step {i}: {m['dropped_blocks']} active "
                f"blocks dropped")
        require(counts == {k: want.get(k, 0) for k in counts},
                f"{tag} step {i}: launches {counts}, want {want}")
    require({k: float(v) for k, v in counters.items()}["dropped_blocks"] == 0.0,
            f"{tag}: counters {counters}")
    profile_call(f"{tag} step (static_dynamic, full width)", lambda: train_step(
        params, opt_state, counters, draws[-1], 1, 0, TURBO_STEPS + 1, *data,
        hp.L1_weight_initial, 0.0, alpha_state))
    numbers = step_numbers(hp, [sec for sec, _, _ in steps], steps[0][1])
    numbers.update(block_budget=budget, shade_probed=probed, shade=shade, probe_s=probe_s,
                   chunk_grads=grads, dropped_shade=[m["dropped_shade"] for _, _, m in steps],
                   counters={k: float(v) for k, v in counters.items()})
    for name, num in (("turbo", numbers), ("dense pruned", prune_numbers)):
        tr = num["traced_step"]
        print(f"[{tag}] {name}: {num['step_s']:.4f} s a step (median) = "
              f"{num['rays_per_s']:.0f} rays/s, {num['launches_a_step']} counted launches a "
              f"step; traced: busy {tr.get('busy_ms', float('nan')):.2f} ms of "
              f"{tr.get('wall_ms', float('nan')):.2f}, idle share "
              f"{tr.get('idle_share', float('nan')):.3f}, {tr.get('launches', 0)} kernel "
              f"launches, GEMMs {tr.get('gemm_ms', float('nan')):.2f} ms [{card}]")
    return launches, numbers


# ---------------------------------------------------------------------------
# multi-frame ray batches (experiment.multi_frame_batch): every ray of a batch
# from a frame of its own, at that frame's time and pose
# ---------------------------------------------------------------------------

POOL_IMAGE = 100  # the pool's frames: a quarter of IMAGE a side, the same field of view
POOL_FOCAL = FOCAL * POOL_IMAGE / IMAGE
POOL_AZIMUTHS = (0.6, 1.5, 2.4, 3.3)  # four cameras around the scene, frame f on f % 4
# 16 distinct times: 8 keyframes of bat's K = 16 (spacing 0.05) and 8 times
# 0.02 off a keyframe (inside dt_max), each side
POOL_TIMES = (0.0, 0.02, 0.12, 0.15, 0.22, 0.25, 0.33, 0.35, 0.43, 0.45, 0.53, 0.55, 0.62,
              0.65, 0.73, 0.75)
MULTI_STEPS = 10
MULTI_GRAD_RAYS = 16  # the rays of a batch's first chunk whose grads are held three ways
# a capped turbo chunk, card against CPU: the top-K shade may pick another
# sample where two weights tie at the K-th within rounding
MULTI_TURBO_RGB_ATOL = 1e-3


def redrawn_shader(meta, params, device):
    """Start params whose renders differ from the seeded weights' frames: the
    seeded blob with a re-drawn shader."""
    start = kplane.map_params(lambda x: x.clone(), params)
    gen = torch.Generator().manual_seed(SEED + 10)
    shader = shaders.init_shader(gen, meta.shading_mode, meta.app_dim, meta.view_pe, meta.pos_pe,
                                 meta.fea_pe, meta.feature_c)
    start["shader"] = kplane.map_params(lambda x: x.to(device), shader)
    return start


def multi_frame_set_up(meta, params, white_bg, device):
    """The pool: 16 frames at distinct times from four cameras, rendered by
    the card from the seeded weights at POOL_IMAGE^2 (targets of the train
    phases, not a counted path); the keyframe pool is the frames whose time
    is a keyframe.  Returns (hp, start params, (poses, images, times), (pool_all,
    pool_key), host poses)."""
    hp = replace(bat_train_hp(), multi_frame=True)
    poses = np.stack([look_at(4.0, POOL_AZIMUTHS[f % len(POOL_AZIMUTHS)], 0.35)
                      for f in range(len(POOL_TIMES))])
    times = np.asarray(POOL_TIMES, np.float32)
    images = []
    t0 = time.perf_counter()
    with uncounted():
        for pose, t in zip(poses, times):
            o, d = rays.ray_bundle(pose, POOL_IMAGE, POOL_IMAGE, POOL_FOCAL)
            images.append(render_image(params, meta, float(t), o, d, white_bg=white_bg,
                                       chunk=CHUNK, device=device)["rgb"])
    sec = time.perf_counter() - t0
    t_dev = torch.tensor(times, device=device)
    on_key = torch.isclose(t_dev, kplane.snap_to_keyframe(meta, t_dev))
    pool_all = torch.arange(len(times), device=device)
    pool_key = pool_all[on_key]
    require(len(set(POOL_TIMES)) == len(POOL_TIMES) >= 16 and len(pool_key) == 8,
            f"the pool: {len(POOL_TIMES)} times, keyframe frames {pool_key.tolist()}")
    print(f"[train_multi] pool: {len(times)} frames of {POOL_IMAGE}x{POOL_IMAGE} at distinct "
          f"times {POOL_TIMES} from {len(POOL_AZIMUTHS)} cameras, rendered in {sec:.1f} s; "
          f"keyframe pool {pool_key.tolist()}")
    data = (torch.tensor(poses, device=device), torch.tensor(np.stack(images), device=device),
            t_dev)
    return hp, redrawn_shader(meta, params, device), data, (pool_all, pool_key), poses


def batch_rays(data, draws, batch, rows):
    """Rays, targets and times of ``rows`` of a multi-frame batch ('t' or '0')."""
    poses, images, times = data
    frames = getattr(draws, f"frames_{batch}")[rows]
    pix = getattr(draws, f"pix_{batch}")[rows]
    ii, jj = pix // POOL_IMAGE, pix % POOL_IMAGE
    ray_o, ray_d = trainer._rays_from_poses(poses[frames], POOL_IMAGE, POOL_IMAGE, POOL_FOCAL,
                                            ii, jj)
    return ray_o, ray_d, images[frames, ii, jj], times[frames]


def multi_chunk_grads(tag, meta, params, white_bg, data, draws, batch, device):
    """Per-leaf grads of the first MULTI_GRAD_RAYS rays of a batch's first
    chunk (their own frames, times and jitter; the keyframe batch without
    advection), loss sum((rgb - target)^2), three ways: the card through the
    kernels, the card through the plain versions, the port on the CPU."""
    n = MULTI_GRAD_RAYS
    ray_o, ray_d, target, t = batch_rays(data, draws, batch, slice(0, n))
    jitter = getattr(draws, f"jitter_{batch}")[0][:n]
    advect = batch == "t"
    require(len(torch.unique(t)) >= 4, f"{tag}: the chunk's times {t.tolist()}")
    cpu = torch.device("cpu")
    grads, rgbs = {}, {}
    for name, dev, plain in (("card", device, False), ("card_plain", device, True),
                             ("cpu", cpu, False)):
        p = kplane.map_params(lambda x: x.detach().to(dev).requires_grad_(True), params)
        count0 = read_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            out = kplane.render_rays(p, meta, t.to(dev), ray_o.to(dev), ray_d.to(dev),
                                     white_bg=white_bg, training=True, advect=advect,
                                     jitter=jitter.to(dev), device=dev)
            torch.sum((out["rgb"] - target.to(dev)) ** 2).backward()
        used = {k: v - count0[k] for k, v in read_counts().items() if v != count0[k]}
        want = {} if name != "card" else dict.fromkeys(
            ("plane_product_fwd", "plane_product_bwd", "composite_fwd", "composite_bwd"), 1)
        require(used == want, f"{tag} chunk grads, {name}: kernel launches {used}")
        grads[name] = {k: (None if g is None else g.cpu())
                       for k, g in flat_leaves(grad_tree(p)).items()}
        rgbs[name] = out["rgb"].detach().cpu()

    def compare(what, got, want, rtol, atol_rel):
        rgb_gap = float((rgbs[got] - rgbs[want]).abs().max())
        return max(grad_shares(tag, f"batch {batch}, {n} rays at {len(torch.unique(t))} "
                               f"distinct times, {what} (rgb differs by {rgb_gap:.2e})",
                               grads[got], grads[want], rtol, atol_rel).values())

    return {"kernels_vs_plain": compare("card kernels vs card plain versions", "card",
                                        "card_plain", KERNEL_CHUNK_GRAD_RTOL,
                                        KERNEL_CHUNK_GRAD_ATOL_REL),
            "plain_vs_cpu": compare("card plain versions vs CPU", "card_plain", "cpu",
                                    CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL),
            "kernels_vs_cpu": compare("card kernels vs CPU", "card", "cpu", CHUNK_GRAD_RTOL,
                                      CHUNK_GRAD_ATOL_REL)}


def multi_vs_single_chunk(meta, params, hp, data, draws, single):
    """K1 and K1b alone on the random-time batch's first 128-ray chunk of a
    multi-frame step and of a single-frame step (frame 1, one pose, one time
    0.02 off its keyframe) at the same P."""
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    rows = slice(0, TRAIN_RAYS)
    ray_o, ray_d, target, t = batch_rays(data, draws, "t", rows)
    multi = recorded_chunk_inputs(meta, params, hp, ray_o, ray_d, target, t,
                                  draws.jitter_t[0], True)
    poses, images, times = data
    pix = single.pix_t[rows]
    ii, jj = pix // POOL_IMAGE, pix % POOL_IMAGE
    ray_o, ray_d = trainer._rays_from_pose(poses[1], POOL_IMAGE, POOL_IMAGE, POOL_FOCAL, ii, jj)
    one = recorded_chunk_inputs(meta, params, hp, ray_o, ray_d, images[1][ii, jj],
                                times[1], single.jitter_t[0], True)
    P = TRAIN_RAYS * meta.n_samples
    require(multi[0].shape[0] == one[0].shape[0] == P, f"chunk shapes {multi[0].shape}")
    out = {}
    for name, (xyzt, gd, ga) in (("single_frame_chunk", one), ("multi_frame_chunk", multi)):
        n_t = len(torch.unique(xyzt[:, 3]))
        tag = f"{'multi' if name.startswith('multi') else 'single'}-frame train chunk, " \
              f"{TRAIN_RAYS} rays x {meta.n_samples}, {n_t} distinct normalized times"
        with uncounted():
            out[name] = {"k1": k1_at(tag, ps, pt, xyzt, cd),
                         "k1b": k1b_at(tag, ps, pt, xyzt, cd, gd, ga), "distinct_times": n_t}
    for k in ("k1", "k1b"):
        s, m = out["single_frame_chunk"][k], out["multi_frame_chunk"][k]
        print(f"[train_multi] {k.upper()} alone, single- / multi-frame chunk: "
              f"{s['kernel_alone_ms']:.4f} / {m['kernel_alone_ms']:.4f} ms (ratio "
              f"{m['kernel_alone_ms'] / s['kernel_alone_ms']:.3f}); bound "
              f"{s['bound_ms']:.4f} / {m['bound_ms']:.4f} ms")
    return out


def phase_train_multi(meta, params, white_bg, card, train_numbers, device):
    """Ten full-width static_dynamic steps with multi-frame batches: each ray
    of both batches from its own frame of the pool (the keyframe batch from
    the keyframe pool, unadvected)."""
    tag = "train_multi"
    hp, start, data, pools, host_poses = multi_frame_set_up(meta, params, white_bg, device)
    require(trainer.ray_chunking(meta, hp) == (TRAIN_RAYS, 16),
            f"ray chunking {trainer.ray_chunking(meta, hp)}")
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    draws = [trainer.draw_train_inputs(gen, meta, hp, POOL_IMAGE, POOL_IMAGE, None, *pools)
             for _ in range(MULTI_STEPS + 2)]
    single = trainer.draw_train_inputs(gen, meta, replace(hp, multi_frame=False), POOL_IMAGE,
                                       POOL_IMAGE)
    grads = {b: multi_chunk_grads(tag, meta, start, white_bg, data, draws[0], b, device)
             for b in ("t", "0")}
    kernels_alone = multi_vs_single_chunk(meta, start, hp, data, draws[0], single)

    train_step = trainer.make_train_step(meta, hp, "static_dynamic", POOL_IMAGE, POOL_IMAGE,
                                         POOL_FOCAL, device=device)
    opt_state, counters = optim.init_state(start), trainer.init_counters(device)
    train_params = start
    train_params, opt_state, counters, _ = train_step(train_params, opt_state, counters,
                                                      draws[0], 1, 0, 0, *data,
                                                      hp.L1_weight_initial, 0.0, None)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    its = range(1, MULTI_STEPS + 1)
    train_params, opt_state, counters, steps, launches = counted_steps(
        train_step, train_params, opt_state, counters, [draws[i] for i in its], its, data, hp,
        None)
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(steps, 1):
        print(f"[{tag}] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f} (rgb_t {m['rgb_loss_t']:.6f}, rgb_0 {m['rgb_loss_0']:.6f}, "
              f"vel_pde {m['vel_pde']:.3e}) [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"{tag} step {i}: metrics {m}")
        want = {k: STEP_LAUNCHES.get(k, 0) for k in counts}
        require(counts == want, f"{tag} step {i}: launches {counts}, want {want}")
    require(all(float(v) == 0.0 for v in counters.values()),
            f"{tag}: a dense step dropped samples: {counters}")
    profile_call(f"{tag} step (static_dynamic, multi-frame, full width)", lambda: train_step(
        train_params, opt_state, counters, draws[-1], 1, 0, MULTI_STEPS + 1, *data,
        hp.L1_weight_initial, 0.0, None))
    numbers = step_numbers(hp, [sec for sec, _, _ in steps], steps[0][1])
    numbers.update(chunk_grads=grads, kernels_alone=kernels_alone,
                   single_frame_step_s=train_numbers["step_s"])
    print(f"[{tag}] {MULTI_STEPS} steps: median {numbers['step_s']:.4f} s a step = "
          f"{numbers['rays_per_s']:.0f} rays/s; `train` (single-frame batches, same chunking): "
          f"{train_numbers['step_s']:.4f} s (ratio {numbers['step_s'] / train_numbers['step_s']:.3f})"
          f"; launches a step {steps[0][1]} [{card}]")
    return launches, numbers, (hp, train_params, data, pools, host_poses)


def chunk_active_blocks(tmeta, alpha_state, data, draws, batch, hp):
    """Per chunk of a multi-frame batch, its active blocks (a valid sample:
    in the box, the dilated mask's nearest test, as render_rays trains) and
    their count past the budget's B; uncounted K4 launches."""
    ray_chunk, n_chunks = trainer.ray_chunking(tmeta, hp)
    S, S0, SB = padded_samples(tmeta), tmeta.n_samples, tmeta.sample_block
    ray_o, ray_d, _, _ = batch_rays(data, draws, batch, slice(0, hp.n_rays))
    jitter = getattr(draws, f"jitter_{batch}")
    active = []
    with torch.no_grad(), uncounted():
        for c in range(n_chunks):
            rows = slice(c * ray_chunk, (c + 1) * ray_chunk)
            pts, _, valid = kplane.sample_ray(tmeta, ray_o[rows], ray_d[rows], S, jitter[c])
            valid = valid & (torch.arange(S, device=valid.device) < S0)
            valid = valid & kplane.sample_occupied(alpha_state, kplane.normalize_coord(tmeta, pts),
                                                   tmeta)
            active.append(int(valid.reshape(-1, SB).any(-1).sum()))
    total_b = ray_chunk * (S // SB)
    B = block_budget_blocks(tmeta.block_budget, total_b)
    return active, total_b, B, sum(max(a - B, 0) for a in active)


def phase_train_multi_turbo(meta, multi, alpha_state, card, turbo_numbers, device):
    """Turbo steps on the multi-frame pool, set up as `train_turbo`: the mask
    of `alpha`, block_budget and shade from the port's probe over the pool's
    poses (one pose a probe batch, as the JAX package probes), the shade
    capped at 0.25, 2 x 8 chunks of 256 rays.  dropped_blocks is the runtime
    certificate: printed every step, never assumed 0; one chunk's count and
    outputs equal to the CPU port's from the same draws; each batch's real
    active-block share beside the probe's budget."""
    tag = "train_multi_turbo"
    hp, params, data, pools, host_poses = multi
    t0 = time.perf_counter()
    budget, probed = turbo.measure_block_budget(meta, alpha_state, host_poses, POOL_IMAGE,
                                                POOL_IMAGE, POOL_FOCAL, hp.n_rays,
                                                with_shade=True)
    probe_s = time.perf_counter() - t0
    cap = config_shade_fraction()
    shade = turbo.shade_cap_policy(probed, cap, follow_probe=False)
    tmeta = replace(meta, train_occupancy_prune=True, block_budget=budget, shade_fraction=shade)
    chunking = trainer.ray_chunking(tmeta, hp)
    print(f"[{tag}] probe over the pool's poses ({hp.n_rays} rays x 12 batches, {probe_s:.1f} "
          f"s): block_budget {budget:.4f}, shade {probed:.4f} probed, {shade:.4f} capped at {cap}; "
          f"ray chunking {chunking}")
    require(0.0 < budget < 1.0 and 0.0 < shade < 1.0, f"budgets {budget}, {shade}")
    require(chunking == (TURBO_RAYS, hp.n_rays // TURBO_RAYS), f"ray chunking {chunking}")
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    draws = [trainer.draw_train_inputs(gen, tmeta, hp, POOL_IMAGE, POOL_IMAGE, None, *pools)
             for _ in range(TURBO_STEPS + 1)]

    # one chunk of the random-time batch, card against CPU, on the step's meta
    n = chunking[0]
    ray_o, ray_d, target, t = batch_rays(data, draws[1], "t", slice(0, n))
    alpha_cpu = {k: v.cpu() for k, v in alpha_state.items()}
    outs = {}
    with torch.no_grad(), uncounted():
        for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
            p = kplane.map_params(lambda x: x.detach().to(dev), params)
            out = kplane.render_rays(p, tmeta, t.to(dev), ray_o.to(dev), ray_d.to(dev),
                                     white_bg=hp.white_bg, training=True,
                                     jitter=draws[1].jitter_t[0].to(dev),
                                     alpha_state=alpha_state if dev == device else alpha_cpu,
                                     device=dev)
            outs[name] = {k: v.detach().cpu() for k, v in out.items()
                          if isinstance(v, torch.Tensor)}
    card_o, cpu_o = outs["card"], outs["cpu"]
    errs = {k: float((card_o[k] - cpu_o[k]).abs().max()) for k in ("rgb", "acc")}
    depth_ok = bool(((card_o["depth"] - cpu_o["depth"]).abs()
                     <= 1e-4 * cpu_o["depth"].abs()).all())
    counts = {k: (float(card_o[k]), float(cpu_o[k])) for k in ("dropped_blocks", "dropped_shade")}
    print(f"[{tag}] one {n}-ray chunk at {len(torch.unique(t))} distinct times, card vs CPU: "
          f"dropped_blocks {counts['dropped_blocks']}, dropped_shade {counts['dropped_shade']}, "
          f"max err {errs}, depth within rtol 1e-4 {depth_ok}")
    require(counts["dropped_blocks"][0] == counts["dropped_blocks"][1],
            f"{tag}: dropped_blocks card vs CPU {counts['dropped_blocks']}")
    require(errs["acc"] <= 1e-4 and depth_ok and errs["rgb"] <= MULTI_TURBO_RGB_ATOL,
            f"{tag}: the chunk card vs CPU {errs}, depth {depth_ok}")

    train_step = trainer.make_train_step(tmeta, hp, "static_dynamic", POOL_IMAGE, POOL_IMAGE,
                                         POOL_FOCAL, use_alpha=True, device=device)
    opt_state, counters = optim.init_state(params), trainer.init_counters(device)
    want = step_launches(tmeta, hp)
    shares = []

    # -- the main path: counts set to 0 just before, read just after --------
    its = range(1, TURBO_STEPS + 1)
    params, opt_state, counters, steps, launches = counted_steps(
        train_step, params, opt_state, counters, [draws[i] for i in its], its, data, hp,
        alpha_state)
    # ------------------------------------------------------------------------

    for i, (sec, counts_i, m) in enumerate(steps, 1):
        per_batch = {b: chunk_active_blocks(tmeta, alpha_state, data, draws[i], b, hp)
                     for b in ("t", "0")}
        predicted = sum(v[3] for v in per_batch.values())
        total_b, B = per_batch["t"][1], per_batch["t"][2]
        share = {b: max(v[0]) / total_b for b, v in per_batch.items()}
        shares.append(share)
        print(f"[{tag}] step {i}: {sec:.4f} s = {2 * hp.n_rays / sec:.0f} rays/s, loss "
              f"{m['loss']:.6f}; dropped_blocks {m['dropped_blocks']:.0f} (the chunks' active "
              f"blocks past B = {B} of {total_b}: {predicted}), dropped_shade "
              f"{m['dropped_shade']:.0f}; the largest active-block share of a chunk, batch t / 0: "
              f"{share['t']:.4f} / {share['0']:.4f} against the probe's budget {budget:.4f} "
              f"[{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"{tag} step {i}: metrics {m}")
        require(m["dropped_blocks"] == predicted, f"{tag} step {i}: dropped_blocks "
                f"{m['dropped_blocks']}, the chunks' active blocks past B give {predicted}")
        require(counts_i == {k: want.get(k, 0) for k in counts_i},
                f"{tag} step {i}: launches {counts_i}, want {want}")
    run_max = {k: float(v) for k, v in counters.items()}
    exact = "exact (no active block dropped)" if run_max["dropped_blocks"] == 0 else \
        "NOT exact: the budget dropped active blocks"
    print(f"[{tag}] running max over the steps: {run_max}: {exact}; `train_turbo` (single-frame): "
          f"{turbo_numbers['step_s']:.4f} s a step [{card}]")
    numbers = step_numbers(hp, [sec for sec, _, _ in steps], steps[0][1])
    numbers.update(block_budget=budget, shade_probed=probed, shade=shade, probe_s=probe_s,
                   dropped_blocks=[m["dropped_blocks"] for _, _, m in steps],
                   dropped_shade=[m["dropped_shade"] for _, _, m in steps],
                   active_share=shares, chunk_vs_cpu={"counts": counts, "errs": errs},
                   single_frame_step_s=turbo_numbers["step_s"])
    return launches, numbers


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
    return with_floor(entry, run_grid(xyzt.shape[0], plan.run))


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
    return with_floor({"name": "plane_product_density_fwd_bf16", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:513 (compute_dtype=bf16)", "plan": plan.__dict__,
            "max_abs_err": err, "k1_density_gap_share": k1_gap, "ms": ms,
            "kernel_alone_ms": alone_ms, "graph_alone_ms": graph_alone_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_rate": f32_rate_ms,
            "library_ms": library_ms}, run_grid(P, plan.run))


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
    return with_floor({"name": "plane_product_bwd_bf16", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product_bwd.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:444 (compute_dtype=bf16, its VJP)",
            "plan": plan.__dict__, "max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
            "kernel_alone_no_xyz_ms": alone_no_xyz_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_rate": f32_rate_ms,
            "bound_whole_planes_ms": whole_ms,
            "library_ms": library_ms, "f32_arm_alone_ms_here": f32_alone_ms,
            "f32_arm_alone_no_xyz_ms_here": f32_alone_no_xyz_ms, "active_share": active / P,
            "atomics": stats, "atomic_sectors": sectors},
                      run_grid(P, plan.run, K1B_BF16_THREADS))


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


def check_bf16_copies_after_steps(meta, params, o, d, device, tag="train_bf16", t=TIMES[0],
                                  when="after the steps"):
    """After optimizer steps have updated the planes in place (or a stage
    event has made new ones): the bf16 plane copies that K1.bf16 and
    K1d.bf16 read (grid_sample.bf16_planes, kept per plane version) equal
    the planes rounded to bf16 bit for bit, and both arms on those planes
    equal their plain versions, which read the float32 planes (app bit for
    bit, density rtol 1e-5), at the middle render chunk's samples at the
    keyframe time ``t``.  A copy left stale by an update that did not move
    the plane's version, or kept for a plane an event replaced, fails here."""
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
    xyzt = ray_ordered_xyzt(meta, o[mid:mid + CHUNK], d[mid:mid + CHUNK], t,
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
    print(f"[{tag}] {when}: the bf16 plane copies equal the planes rounded "
          f"to bf16 (0 values differ, limit 0); on {xyzt.shape[0]} ray-ordered samples of the "
          f"middle {CHUNK}-ray chunk at t={t}, K1.bf16's app equals its plain version "
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

    opt_state, counters = optim.init_state(start), trainer.init_counters(device)
    draws = [trainer.draw_train_inputs(gen, bmeta, hp, IMAGE, IMAGE)
             for _ in range(TRAIN_STEPS + 2)]
    train_params = start
    train_params, opt_state, counters, _ = train_step(train_params, opt_state, counters, draws[0],
                                                      1, 0, 0, *data, hp.L1_weight_initial, 0.0,
                                                      None)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    its = range(1, TRAIN_STEPS + 1)
    train_params, opt_state, counters, steps, launches = counted_steps(
        train_step, train_params, opt_state, counters, [draws[i] for i in its], its, data, hp,
        None)
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
    train_params, opt_state, counters, pruned, prune_launches = counted_steps(
        prune_step, train_params, opt_state, counters, draws[:PRUNE_STEPS],
        range(TRAIN_STEPS + 2, TRAIN_STEPS + 2 + PRUNE_STEPS), data, hp, alpha_state)
    # ------------------------------------------------------------------------

    for i, (sec, counts, m) in enumerate(pruned):
        print(f"[train_prune_bf16] step {i}: {sec:.4f} s, loss {m['loss']:.6f}; K4 launches "
              f"{counts['occupancy_nearest_fwd']} [{card}]")
        require(all(np.isfinite(v) for v in m.values()), f"bf16 pruned step {i}: metrics {m}")
        require(counts == {k: want.get(k, 0) for k in counts},
                f"bf16 pruned step {i}: launches {counts}, want {want}")
    profile_call("bf16 pruned train step (static_dynamic, full width)", lambda: prune_step(
        train_params, opt_state, counters, draws[-1], 1, 0, TRAIN_STEPS + 2 + PRUNE_STEPS,
        *data, hp.L1_weight_initial, 0.0, alpha_state))
    prune_numbers = step_numbers(hp, [sec for sec, _, _ in pruned], pruned[0][1])
    fresh = check_bf16_copies_after_steps(bmeta, train_params, o, d, device)
    return launches, prune_launches, {
        "step_s": float(np.median(secs)), "rays_per_s": 2 * hp.n_rays / float(np.median(secs)),
        "traced_step": traced, "chunk_grads": diagnosis, "copies_after_steps": fresh,
        "pruned": prune_numbers}, (train_params, data, hp)


# ---------------------------------------------------------------------------
# the Trainer stage loop: the port's training CLI, python -m nvfi_torch.train_nvfi
# ---------------------------------------------------------------------------

# the one shipped config whose own lists hold every stage event: alpha-mask
# builds at the first two upsamples, turbo and shade_follow_probe
TRAINER_CONFIG = ROOT / "configs" / "synth" / "chessboard_slow_turbo.yaml"
TRAINER_ITERS = 14
# the schedule compressed: upsamples after iterations 2, 4, 6, 8 and 10, so
# that 11 to 13 run at the final width (N_voxel_final over the shrunk box)
TRAINER_SCHEDULE = ["experiment.train_iters", str(TRAINER_ITERS),
                    "nvfi.upsamp_list", "[2,4,6,8,10]", "nvfi.update_AlphaMask_list", "[2,4]",
                    "experiment.save_every", "6", "experiment.print_every", "1"]
TRAINER_SAVES = (6, 12, 13)
TRAINER_RESUME = 6  # the checkpoint a second Trainer resumes from
TRAINER_PROFILED = TRAINER_ITERS - 2  # the traced step (final width), left out of the medians
BF16_CHECK_TIME = 0.25  # a keyframe time of chessboard's K = 4
# tests/test_train_e2e.py's small_cfg: the tiny scene that must learn
LEARNS_CFG = {
    "experiment": {
        "randomseed": 0, "lr_grid": 0.02, "lr_net": 1e-3, "lr_decay_iters": -1,
        "lr_decay_target_ratio": 0.1, "lr_upsample_reset": 1, "train_iters": 200,
        "L1_weight_inital": 8e-4, "L1_weight_reset": 4e-4, "TV_weight_density": 1.0,
        "TV_weight_app": 1.0, "vel_reg_weight": 1.0, "vel_reg_n_pts": 256,
        "save_every": 10**9, "print_every": 20, "validate_every": 10**9,
    },
    "dataset": {"near": 2.0, "far": 6.0, "white_background": True},
    "renderer": {"n_rays": 256},
    "nvfi": {
        "bbox_x": [-2, 2], "bbox_y": [-2, 2], "bbox_z": [-2, 2],
        "model_name": "TensorVMKeyframeTimeKplane",
        "N_voxel_init": 16384, "N_voxel_final": 16384,
        "upsamp_list": [], "update_AlphaMask_list": [],
        "density_n_comp": [8, 8, 8], "appearance_n_comp": [8, 8, 8],
        "app_dim": 8, "densityMode": "Density", "shadingMode": "MLP_PE",
        "alphaMask_thres": 1e-4, "rayMarch_weight_thres": 1e-4,
        "density_shift": -10, "distance_scale": 25,
        "pos_pe": 6, "view_pe": 6, "fea_pe": 6, "featureC": 32,
        "step_ratio": 0.5, "fea2denseAct": "softplus",
        "max_n_samples": 48, "num_keyframes": 4, "num_keyframes_end": 4,
        "tmax": 0.75, "use_vel": True,
    },
}
LEARNS_ITERS = 120
LEARNS_GAIN_DB = 4.0  # tests/test_train_e2e.py's bar


@contextlib.contextmanager
def uncounted():
    """Launches inside are comparisons: the counters are put back after."""
    saved = read_counts()
    try:
        yield
    finally:
        for name, (wrapper, attr) in COUNTERS.items():
            setattr(wrapper, attr, saved[name])


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


class StageRecorder:
    """While installed, every train step a Trainer builds (through
    trainer.make_train_step) is synchronized, timed and counted: one printed
    line a step with the wall time, loss, PSNRs, the launches of each kernel
    and the counters' running max; the launches must equal step_launches of
    the stage's meta.  The first step of each stage first checks its planes:
    contiguous, and K1's and K1b's 16-byte plans (the bf16 arm: the bf16
    copies, held to the planes by check_bf16_copies_after_steps).  Every
    _check_counters read is kept."""

    def __init__(self, tag, arm, card, o, d, device):
        self.tag, self.arm, self.card, self.o, self.d, self.device = tag, arm, card, o, d, device
        self.steps, self.stages, self.counter_reads = [], [], []

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(patched(trainer, "make_train_step",
                                          self.wrap(trainer.make_train_step)))
        check = trainer.Trainer._check_counters
        reads = self.counter_reads

        def recorded_check(tr, tag, reset=False):
            out = check(tr, tag, reset)
            reads.append((tag, out))
            return out

        self._stack.enter_context(patched(trainer.Trainer, "_check_counters", recorded_check))
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def check_planes(self, meta, params, it):
        planes = list(params["planes_space"]) + list(params["planes_time"])
        require(all(p.is_contiguous() and p.is_leaf for p in planes),
                f"{self.tag} it={it}: a plane is not a contiguous leaf")
        C, cd = planes[0].shape[-1], meta.density_n_comp
        dtype = BF16 if self.arm else torch.float32
        read = grid_sample.bf16_planes(planes, C) if self.arm else planes
        ptrs = [p.data_ptr() for p in read]
        fwd = grid_sample.plane_product_plan(C, cd, ptrs, dtype)
        bwd = grid_sample.plane_product_bwd_plan(C, cd, ptrs, dtype)
        width = 8 if self.arm else 4
        require(fwd.vec == width and bwd.vec == width,
                f"{self.tag} it={it}: the planes did not take the 16-byte plans: {fwd}, {bwd}")
        copies = None
        if self.arm:
            with uncounted():
                copies = check_bf16_copies_after_steps(
                    meta, params, self.o, self.d, self.device, tag=self.tag, t=BF16_CHECK_TIME,
                    when=f"at the first step of the stage from it={it}")
        stage = {"it": it, "grid": list(meta.grid_size), "keyframes": meta.num_keyframes,
                 "planes_MB": sum(p.numel() * 4 for p in planes) / 1e6,
                 "k1_plan": [fwd.vec, fwd.run], "k1b_plan": [bwd.vec, bwd.run],
                 "bf16_copies": copies}
        print(f"[{self.tag}] stage from it={it}: grid {meta.grid_size}, K={meta.num_keyframes}, "
              f"{stage['planes_MB']:.1f} MB of planes, all contiguous; K1 plan {fwd}, K1b plan "
              f"{bwd}")
        self.stages.append(stage)

    def wrap(self, build):
        def build_recorded(meta, hp, mode, H, W, focal, vel_pts=None, use_alpha=False,
                           device="cuda"):
            step = build(meta, hp, mode, H, W, focal, vel_pts, use_alpha, device)
            want = step_launches(meta, hp, self.arm)
            first = [True]

            def run(params, opt_state, counters, draws, frame_idx, key_idx, it, *rest):
                if first[0]:
                    first[0] = False
                    self.check_planes(meta, params, it)
                out = []

                def call():
                    out.append(step(params, opt_state, counters, draws, frame_idx, key_idx, it,
                                    *rest))

                torch.cuda.synchronize()
                count0 = read_counts()
                t0 = time.perf_counter()
                if it == TRAINER_PROFILED:
                    profile_call(f"{self.tag} step it={it}", call)
                else:
                    call()
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                count1 = read_counts()
                launches = {k: count1[k] - count0[k] for k in count1 if count1[k] != count0[k]}
                _, _, running, metrics = out[0]
                m = {k: float(v) for k, v in metrics.items()}
                run_max = {k: float(v) for k, v in running.items()}
                psnr_t = mse2psnr(m["rgb_loss_t"] or 1.0)
                psnr_0 = mse2psnr(m["rgb_loss_0"] or 1.0)
                print(f"[{self.tag}] it={it}: {sec:.4f} s, loss {m['loss']:.6f}, psnr_t "
                      f"{psnr_t:.2f}, psnr_0 {psnr_0:.2f}; launches {launches}; running max "
                      f"{run_max} [{self.card}]")
                require(np.isfinite(m["loss"]), f"{self.tag} it={it}: loss {m['loss']}")
                require(launches == want, f"{self.tag} it={it}: launches {launches}, want {want}")
                self.steps.append({"it": it, "s": sec, "grid": list(meta.grid_size),
                                   "block_budget": meta.block_budget,
                                   "shade_fraction": meta.shade_fraction,
                                   "traced": it == TRAINER_PROFILED, "loss": m["loss"],
                                   "launches": sum(launches.values())})
                return out[0]

            return run

        return build_recorded


def trainer_numbers(tag, tr, recorder, card):
    """The events' lines and the median step of each stage."""
    for e in tr.events:
        secs = ", ".join(f"{k} {v:.3f} s" for k, v in e["seconds"].items())
        occ = "-" if e["occupancy"] is None else f"{e['occupancy']:.4f}"
        print(f"[{tag}] event it={e['it']} {e['kind']}: grid {e['grid']}, keyframes "
              f"{e['keyframes']}, aabb {e['aabb']}, reso_mask {e['reso_mask']}, occupancy {occ}, "
              f"block_budget {e['block_budget']:.4f}, shade_fraction {e['shade_fraction']:.4f}; "
              f"{secs} [{card}]")
    stages = {}
    for st in recorder.steps:
        if not st["traced"]:
            key = (tuple(st["grid"]), st["block_budget"], st["shade_fraction"])
            stages.setdefault(key, []).append(st)
    medians = []
    for (grid, budget, shade), sts in stages.items():
        med = float(np.median([st["s"] for st in sts]))
        medians.append({"grid": list(grid), "block_budget": budget, "shade_fraction": shade,
                        "its": [st["it"] for st in sts], "median_s": med,
                        "launches_a_step": sts[0]["launches"]})
        print(f"[{tag}] stage grid {grid}, block_budget {budget:.4f}, shade {shade:.4f}: "
              f"iterations {[st['it'] for st in sts]}, median {med:.4f} s a step, "
              f"{sts[0]['launches']} counted launches a step [{card}]")
    return medians


def run_trainer_cli(tag, arm, card, o, d, device, logdir, extra):
    """train_nvfi.main on the compressed chessboard_slow_turbo schedule with
    the recorder installed; the counts around it are the path's."""
    args = ["--config", str(TRAINER_CONFIG), "--static_dynamic", "--synthetic", "--device",
            device.type, "--logdir", logdir, *extra, *TRAINER_SCHEDULE]
    if arm:
        args += ["nvfi.compute_dtype", "bfloat16"]
    print(f"[{tag}] python -m nvfi_torch.train_nvfi {' '.join(args)}")
    recorder = StageRecorder(tag, arm, card, o, d, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with recorder:
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = train_nvfi.main(args)
        launches = read_counts()
        # --------------------------------------------------------------------
    sec = time.perf_counter() - t0
    tr = out["trainer"]
    steps = recorder.steps
    require([st["it"] for st in steps] == list(range(TRAINER_ITERS)),
            f"{tag}: steps ran at {[st['it'] for st in steps]}")
    event_its = sorted({e["it"] for e in tr.events})
    require(event_its == [2, 4, 6, 8, 10], f"{tag}: events at {event_its}")
    kinds = [(e["it"], e["kind"]) for e in tr.events]
    require(kinds == [(2, "alpha"), (2, "upsample"), (4, "alpha"), (4, "upsample"),
                      (6, "upsample"), (8, "upsample"), (10, "upsample")], f"{tag}: {kinds}")
    require([st["it"] for st in recorder.stages] == [0] + [it + 1 for it in event_its],
            f"{tag}: the planes were checked at {[st['it'] for st in recorder.stages]}")
    dropped = [(t, r["max_dropped_blocks"]) for t, r in recorder.counter_reads
               if r["max_dropped_blocks"] != 0.0]
    require(not dropped and recorder.counter_reads, f"{tag}: dropped blocks at {dropped}")
    for it in TRAINER_SAVES:
        require(os.path.exists(os.path.join(logdir, f"model_{it:05d}.npz")),
                f"{tag}: no checkpoint of it={it}")
    final = tuple(tr.meta.grid_size)
    full = [st["it"] for st in steps if tuple(st["grid"]) == final]
    require(len(full) >= 3 and int(np.prod(final)) >= 0.9 * tr.hp.n_voxel_final,
            f"{tag}: {len(full)} steps at the final grid {final}")
    require(tr.meta.train_occupancy_prune and tr.alpha_state is not None,
            f"{tag}: turbo did not engage")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{tag}] {TRAINER_ITERS} iterations, {len(tr.events)} events, eval and all in "
          f"{sec:.1f} s; final grid {final} ({int(np.prod(final))} voxels, "
          f"{tr.meta.density_n_comp} + {tr.meta.app_n_comp} channels, K={tr.meta.num_keyframes}),"
          f" iterations {full} at that grid; {len(recorder.counter_reads)} counter reads, "
          f"dropped_blocks 0 in each; checkpoints {TRAINER_SAVES}; peak memory "
          f"{peak_gb:.2f} GB [{card}]")
    medians = trainer_numbers(tag, tr, recorder, card)
    numbers = {"seconds": sec, "events": [{k: v for k, v in e.items()} for e in tr.events],
               "stages": medians, "peak_memory_GB": peak_gb, "final_grid": list(final),
               "final_aabb": [list(r) for r in tr.meta.aabb], "traced_step": dict(LAST_PROFILE),
               "plane_checks": recorder.stages}
    return out, launches, numbers, recorder


def phase_trainer(card, o, d, device):
    """The port's training CLI on chessboard_slow_turbo.yaml (the compressed
    schedule, --eval_test), then a second Trainer resumed from model_00006
    that runs on to the end."""
    tag = "trainer"
    logdir = tempfile.mkdtemp(prefix="nvfi_trainer_")
    out, launches, numbers, _ = run_trainer_cli(tag, "", card, o, d, device, logdir,
                                                   ["--eval_test"])
    errors = out["eval"]
    require(errors is not None and np.isfinite(errors["psnr"]) and np.isfinite(errors["ssim"]),
            f"{tag}: eval {errors}")
    H, W = out["dataset"][6][:2]
    print(f"[{tag}] --eval_test: PSNR {errors['psnr']:.3f} dB, SSIM {errors['ssim']:.4f}, MSE "
          f"{errors['mse']:.6f} over the test split ({out['dataset'][3]['test']} views of "
          f"{H}x{W}, t in [0, 1]) [{card}]")
    numbers["eval"] = errors

    # -- resume: a second Trainer from model_00006 runs on to the end --------
    tr = out["trainer"]
    path = os.path.join(logdir, f"model_{TRAINER_RESUME:05d}")
    saved_params, saved_meta, _, saved_alpha, saved_extra = checkpoint.load(path, device=device)
    resumed = trainer.Trainer(tr.cfg, out["dataset"], mode="static_dynamic",
                              logdir=tempfile.mkdtemp(prefix="nvfi_resume_"), device=device)
    recorder = StageRecorder(f"{tag}:resume", "", card, o, d, device)
    with recorder:
        resumed.restore(path)
        require(resumed.meta == saved_meta, f"{tag}: resumed meta {resumed.meta} != saved "
                f"{saved_meta}")
        extra = {"global_step": resumed.global_step, "n_voxel_list": list(resumed.n_voxel_list),
                 "keyframe_list": list(resumed.keyframe_list), "mode": resumed.mode,
                 "l1_base": resumed.l1_base, "l1_step0": resumed.l1_step0,
                 "reso_mask": list(resumed.reso_mask)}
        require(extra == saved_extra and extra["global_step"] == TRAINER_RESUME + 1,
                f"{tag}: resumed extras {extra} != saved {saved_extra}")
        require(all(torch.equal(resumed.alpha_state[k], v) for k, v in saved_alpha.items()),
                f"{tag}: the resumed alpha state differs from the saved one")
        require(all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(resumed.params),
                                                      optim.tree_leaves(saved_params))
                    if a is not None), f"{tag}: the resumed params differ from the saved ones")
        require([e["kind"] for e in resumed.events] == ["restore"],
                f"{tag}: the resumed run did not re-probe: {resumed.events}")
        reset_counts()
        resumed.train()
        resume_launches = read_counts()
    got = (resumed.meta.grid_size, resumed.meta.aabb, resumed.meta.num_keyframes)
    want = (tr.meta.grid_size, tr.meta.aabb, tr.meta.num_keyframes)
    require(got == want, f"{tag}: the resumed run ends on {got}, the uninterrupted one on {want}")
    require([st["it"] for st in recorder.steps] == list(range(TRAINER_RESUME + 1, TRAINER_ITERS)),
            f"{tag}: the resumed run stepped at {[st['it'] for st in recorder.steps]}")
    print(f"[{tag}] resumed from model_{TRAINER_RESUME:05d}: meta, extras {extra}, alpha state and "
          f"params equal to the saved ones; re-probed (block_budget "
          f"{resumed.events[0]['block_budget']:.4f}, shade {resumed.events[0]['shade_fraction']:.4f}"
          f"); ran it={TRAINER_RESUME + 1}..{TRAINER_ITERS - 1} through "
          f"{[e['kind'] + '@' + str(e['it']) for e in resumed.events[1:]]} and ended on grid "
          f"{got[0]}, K={got[2]}, aabb {got[1]}, the uninterrupted run's")
    numbers["resume"] = {"events": resumed.events, "steps": recorder.steps}
    numbers["logdir"] = logdir
    return launches, resume_launches, numbers


def phase_trainer_bf16(card, o, d, device):
    """The CLI, schedule and config of `trainer` in bf16 (as bench.py sets
    compute_dtype); no resume, no eval."""
    logdir = tempfile.mkdtemp(prefix="nvfi_trainer_bf16_")
    _, launches, numbers, recorder = run_trainer_cli("trainer_bf16", "_bf16", card, o, d,
                                                        device, logdir, [])
    require(all(st["bf16_copies"]["stale_values"] == 0 for st in recorder.stages),
            "trainer_bf16: stale bf16 plane copies")
    numbers["logdir"] = logdir
    return launches, numbers


def phase_trainer_learns(card, device):
    """Trainer.train on the tiny scene and config of tests/test_train_e2e.py:
    PSNR must rise by more than 4 dB in 120 iterations, as there."""
    scene = make_synthetic_scene(n_train=10, n_val=2, n_test=2, H=32, W=32)
    tr = trainer.Trainer(CfgNode(LEARNS_CFG), scene, mode="static_dynamic", device=device)
    logs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    tr.train(iters=LEARNS_ITERS, log_fn=logs.append)
    torch.cuda.synchronize()
    launches = read_counts()
    # ------------------------------------------------------------------------
    sec = time.perf_counter() - t0
    gain = logs[-1]["psnr_0"] - logs[0]["psnr_0"]
    print(f"[trainer_learns] psnr_0 by iteration: "
          f"{[(m['it'], round(m['psnr_0'], 2)) for m in logs]}; gain {gain:.2f} dB (limit > "
          f"{LEARNS_GAIN_DB}) in {LEARNS_ITERS} iterations, {sec:.2f} s = "
          f"{sec / LEARNS_ITERS:.4f} s a step [{card}]")
    require(all(np.isfinite(m["loss"]) for m in logs), "trainer_learns: a loss is not finite")
    require(gain > LEARNS_GAIN_DB, f"trainer_learns: PSNR rose by {gain:.2f} dB only")
    return launches, {"psnr_0": [(m["it"], m["psnr_0"]) for m in logs], "gain_dB": gain,
                      "seconds": sec, "s_a_step": sec / LEARNS_ITERS}


# ---------------------------------------------------------------------------
# segmentation and motion transfer: the port's three drivers on the trainer's
# scenes
# ---------------------------------------------------------------------------

SEGM_ITERS = 20
SEGM_BUDGET = 8192
SEGM_SMOOTH_ITERS = 3  # in-process iterations with smooth_iter 1: the KNN arm with grads
# a seg step's grads, card against CPU, of a leaf's largest.  float64: the
# same formulas on both sides (JAX and the port agree to 2e-12 so on the
# CPU).  float32: the grads carry the rounding of the rigid-fit residual
# (~5e-3 of a leaf's largest, from the points that barely move), so each
# side's float32 grads are held to the float64 ones instead: the card's
# error may be at most SEGM_F32_RATIO times the CPU's, plus 1e-3 of the
# leaf's largest.  Runs on the H100 read 1.9-3.0 at most; the control step
# with TF32 on read 17.7 and 25.4.  With the fit itself in float32 (JAX's),
# the card's 3 x 3 SVD left the head bias's grad, a sum over all the points
# that nearly cancels, 8e-3-1.6e-2 off (2-8x the CPU's): the port fits in
# float64 (seg_loss.dynamic_loss), and that control is printed beside
SEGM_GRAD_GAP_F64 = 1e-8
SEGM_F32_RATIO = 6.0
SEGM_F32_SLACK = 1e-3
SEGM_VIEWS = 2
SEGM_EXPORT = 32  # --export_points: a 32^3 volume sweep
TRANSFER_GRID = 128  # test_segm_render's default --alpha_grid, given to test_transfer_vel


class CallTimer:
    """While installed, every call of ``owner.<name>`` is synchronized and
    timed, with the launches it made and what it returned, in ``calls``."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        fn = getattr(self.owner, self.name)
        calls = self.calls

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            c0 = read_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            c1 = read_counts()
            calls.append({"s": sec, "out": out,
                          "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}})
            return out

        self._patch = patched(self.owner, self.name, timed)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)

    def median(self):
        return float(np.median([c["s"] for c in self.calls]))


def sweep_launches(grid):
    """K1d launches of a 60-time mask build over ``grid``: one a chunk a time."""
    return ALPHA_TIMES * -(-int(np.prod(grid)) // ALPHA_CHUNK)


def phase_segm_train(card, scene_dir, device):
    """python -m nvfi_torch.train_segm on the f32 `trainer` scene (20
    iterations of 8192 points; 64^3 = 262,144 points into K1d an iteration),
    then an in-process SegmTrainer with smooth_iter 1 (the KNN arm), and one
    seg step of the card against the port on the CPU from identical inputs."""
    tag = "segm_train"
    logdir = tempfile.mkdtemp(prefix="nvfi_segm_")
    args = ["--scene_dir", scene_dir, "--iters", str(SEGM_ITERS), "--point_budget",
            str(SEGM_BUDGET), "--logdir", logdir, "--device", device.type]
    print(f"[{tag}] python -m nvfi_torch.train_segm {' '.join(args)}")
    timers = {n: CallTimer(segm.SegmTrainer, n) for n in ("sample_points", "flow_to", "seg_step")}
    with contextlib.ExitStack() as stack:
        for tm in timers.values():
            stack.enter_context(tm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        tr = train_segm.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
        sec = time.perf_counter() - t0
    P = tr.n_sample_res ** 3
    metrics = {k: float(v) for k, v in timers["seg_step"].calls[-1]["out"].items()}
    parts = {n: tm.median() for n, tm in timers.items()}
    print(f"[{tag}] {SEGM_ITERS} iterations in {sec:.2f} s = {sec / SEGM_ITERS:.4f} s an "
          f"iteration (synchronized medians: host sampling with K1d {parts['sample_points']:.4f}"
          f" s, flow {parts['flow_to']:.4f} s, seg step {parts['seg_step']:.4f} s); {P} points "
          f"into K1d an iteration, {tr.point_budget} kept, {tr.n_object} slots; launches "
          f"{ {k: v for k, v in launches.items() if v} }; last metrics {metrics} [{card}]")
    require(len(timers["seg_step"].calls) == SEGM_ITERS, f"{tag}: {len(timers['seg_step'].calls)} "
            "steps")
    require(P == 262144 and tr.point_budget == SEGM_BUDGET, f"{tag}: {P} points, budget "
            f"{tr.point_budget}")
    require(launches["plane_product_density_fwd"] == SEGM_ITERS and
            all(v == 0 for k, v in launches.items() if k != "plane_product_density_fwd"),
            f"{tag}: launches {launches}, want K1d {SEGM_ITERS} only")
    require(all(np.isfinite(v) for v in metrics.values()), f"{tag}: metrics {metrics}")
    mask_path = os.path.join(logdir, "mask_final")
    require(os.path.exists(mask_path + ".npz"), f"{tag}: no {mask_path}.npz")

    # the smooth arm (KNN with grads) in process, then one step card vs CPU
    cfg = load_config(os.path.join(scene_dir, "config.yaml"), ["segmentation.smooth_iter", "1"])
    params, meta, _, _, _ = checkpoint.load(checkpoint.find_checkpoint(scene_dir), device=device)
    st = segm.SegmTrainer(cfg, params, meta, point_budget=SEGM_BUDGET, device=device)
    with uncounted(), CallTimer(segm.SegmTrainer, "seg_step") as smooth:
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in st.train(iters=SEGM_SMOOTH_ITERS).items()}
        smooth_sec = time.perf_counter() - t0
        xyz = torch.as_tensor(st.sample_points(), device=device)
        flow = st.flow_to(xyz, 0.5 * (st.min_t + meta.tmax))
    want_loss = m["dynamic"] + st.loss_smooth_w * m["smooth"]
    require(abs(m["loss"] - want_loss) <= 1e-5 * abs(want_loss),
            f"{tag}: the smooth arm is not in the loss: {m}")
    # the same step's loss and grads on the card and the CPU, in float32 and
    # float64; then two controls of the float32 check on the card: float32
    # with TF32 on, and float32 with the rigid fit in float32 (JAX's)
    runs = {}  # key -> [card, CPU], each (grads, loss, seconds)
    cpu_dev = torch.device("cpu")
    for key, dt, tf32, fit in ((torch.float32, torch.float32, False, torch.float64),
                               (torch.float64, torch.float64, False, torch.float64),
                               ("tf32", torch.float32, True, torch.float64),
                               ("fit32", torch.float32, False, None)):
        mp = kplane.map_params(lambda x: x.to(dt), st.mask_params)
        for dev in ((device, cpu_dev) if key in (torch.float32, torch.float64) else (device,)):
            tr_ = segm.SegmTrainer(cfg, params, meta, point_budget=SEGM_BUDGET, device=dev,
                                   mask_params=kplane.map_params(lambda x: x.to(dev), mp),
                                   fit_dtype=fit)
            t0 = time.perf_counter()
            with uncounted(), tf32_matmuls(tf32):
                g, mt = tr_.grads(xyz.to(dev, dt), flow.to(dev, dt), True)
            runs.setdefault(key, []).append(
                ([x.cpu().double() for x in g], float(mt["loss"]), time.perf_counter() - t0))

    def rel(a, b):  # by leaf: max |a - b| / max |b|
        return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]

    def within(card_err, cpu_err):  # the float32 check
        return all(c <= SEGM_F32_RATIO * p + SEGM_F32_SLACK for c, p in zip(card_err, cpu_err))

    (card32, cpu32), (card64, cpu64) = runs[torch.float32], runs[torch.float64]
    gaps = {"loss_rel_f32": abs(card32[1] - cpu32[1]) / abs(cpu32[1]),
            "loss_rel_f64": abs(card64[1] - cpu64[1]) / abs(cpu64[1]),
            "f64_card_vs_cpu": rel(card64[0], cpu64[0]),
            "f32_card_vs_cpu": rel(card32[0], cpu32[0]),
            "f32_card_vs_f64": rel(card32[0], cpu64[0]),
            "f32_cpu_vs_f64": rel(cpu32[0], cpu64[0]),
            "tf32_card_vs_f64": rel(runs["tf32"][0][0], cpu64[0]),
            "fit32_card_vs_f64": rel(runs["fit32"][0][0], cpu64[0])}

    def ratio_max(card_err):
        return max(c / max(p, 1e-30) for c, p in zip(card_err, gaps["f32_cpu_vs_f64"]))

    gaps.update(f32_ratio_max=ratio_max(gaps["f32_card_vs_f64"]),
                tf32_ratio_max=ratio_max(gaps["tf32_card_vs_f64"]),
                tf32_within=within(gaps["tf32_card_vs_f64"], gaps["f32_cpu_vs_f64"]),
                fit32_ratio_max=ratio_max(gaps["fit32_card_vs_f64"]),
                fit32_within=within(gaps["fit32_card_vs_f64"], gaps["f32_cpu_vs_f64"]))

    def fmt(v):
        return [f"{x:.2e}" for x in v]

    print(f"[{tag}] smooth_iter 1: {SEGM_SMOOTH_ITERS} iterations in {smooth_sec:.2f} s "
          f"(seg step with the KNN of {SEGM_BUDGET} points: {smooth.median():.4f} s, "
          f"synchronized), metrics {m}; one step card vs CPU from identical xyz and flow: "
          f"loss rel err float32 {gaps['loss_rel_f32']:.2e} (limit 1e-4), float64 "
          f"{gaps['loss_rel_f64']:.2e}; grads by leaf (max err / leaf max): float64 card vs "
          f"CPU {max(gaps['f64_card_vs_cpu']):.2e} (limit {SEGM_GRAD_GAP_F64}); float32 card "
          f"vs CPU {fmt(gaps['f32_card_vs_cpu'])}, card vs float64 "
          f"{fmt(gaps['f32_card_vs_f64'])}, CPU vs float64 {fmt(gaps['f32_cpu_vs_f64'])} "
          f"(limit: the card's at most {SEGM_F32_RATIO} x the CPU's + {SEGM_F32_SLACK}; the "
          f"largest ratio {gaps['f32_ratio_max']:.2f}) (CPU step {cpu32[2]:.2f} s) [{card}]")
    print(f"[{tag}] control, the card's float32 step with TF32 on: card vs float64 "
          f"{fmt(gaps['tf32_card_vs_f64'])}, the largest ratio to the CPU's "
          f"{gaps['tf32_ratio_max']:.2f}: the float32 check would "
          f"{'PASS it (the check does not see TF32)' if gaps['tf32_within'] else 'fail it'}")
    print(f"[{tag}] control, the card's float32 step with the rigid fit in float32 (JAX's): "
          f"card vs float64 {fmt(gaps['fit32_card_vs_f64'])}, the largest ratio to the CPU's "
          f"{gaps['fit32_ratio_max']:.2f}: the float32 check would "
          f"{'pass it' if gaps['fit32_within'] else 'fail it'}")
    require(gaps["loss_rel_f32"] <= 1e-4 and gaps["loss_rel_f64"] <= 1e-12,
            f"{tag}: loss card vs CPU {gaps}")
    require(max(gaps["f64_card_vs_cpu"]) <= SEGM_GRAD_GAP_F64, f"{tag}: float64 grads {gaps}")
    require(within(gaps["f32_card_vs_f64"], gaps["f32_cpu_vs_f64"]),
            f"{tag}: the card's float32 grads are less accurate than the CPU's: {gaps}")
    query = check_occupancy_query(tag, st, cfg, device)
    return launches, {"seconds": sec, "s_an_iteration": sec / SEGM_ITERS, "parts_s": parts,
                      "points_into_k1d": P, "metrics": metrics, "smooth_s_a_step":
                      smooth.median(), "card_vs_cpu": gaps, "occupancy_query": query}, mask_path


@contextlib.contextmanager
def tf32_matmuls(on):
    """TF32 in cuBLAS's float32 matmuls while inside (``on``), off after."""
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# an alpha near a threshold of 1e-4 or 1e-3 is 1 - exp(-x) with exp(-x)
# just below 1, where float32 steps by 2^-24: the card's expf and the CPU's
# exp may differ there by a step or two, so a point may land on the other
# side of the threshold only where its CPU alpha lies within 8 such steps
# (4.8e-7) of it
ALPHA_FLIP_BAND = 8 * 2.0 ** -24


def alpha_gaps(tag, what, got, want, thres, strict, cpu_s):
    """An alpha chunk of the card against the CPU's: phase `alpha`'s
    tolerance (atol 1e-5, rtol 1e-3), and no point on the other side of the
    threshold (``strict``: the test is alpha > thres, else >=) but where
    float32's rounding of 1 - exp(-x) reaches it (ALPHA_FLIP_BAND)."""
    side = (lambda a: a > thres) if strict else (lambda a: a >= thres)
    err = float((got - want).abs().max())
    bad = int(((got - want).abs() > 1e-5 + 1e-3 * want.abs()).sum())
    flipped = side(got) != side(want)
    near = (want - thres).abs() <= ALPHA_FLIP_BAND
    flips, far_flips, n_near = int(flipped.sum()), int((flipped & ~near).sum()), int(near.sum())
    dist = float((want - thres)[flipped].abs().max()) if flips else 0.0
    print(f"[{tag}] {what}: {got.numel()} points card vs CPU max err {err:.3e} (atol 1e-5, "
          f"rtol 1e-3); {flips} points on the other side of {thres:.3e}, the farthest "
          f"{dist:.3e} from it, {far_flips} beyond {ALPHA_FLIP_BAND:.2e} (limit 0; {n_near} "
          f"points lie within that band); share above it {float(side(want).float().mean()):.4f}"
          f" (CPU {cpu_s:.1f} s)")
    require(bad == 0 and far_flips == 0 and bool(torch.isfinite(got).all()),
            f"{tag}: {what}: {bad} alphas off, {far_flips} flipped beyond the rounding band")
    return {"max_abs_err": err, "flips": flips, "flip_max_distance": dist, "near_band": n_near,
            "share": float(side(want).float().mean())}


def check_occupancy_query(tag, st, cfg, device):
    """One iteration's t = 0 occupancy query, as SegmTrainer.sample_points
    makes it (the n_sample_res^3 stratified points, K1d on the trainer
    scene's planes): the card against the port on the CPU, alpha and the
    kept set, then K1d against its plain version at those coordinates."""
    meta = st.meta
    rng = np.random.RandomState(SEED + 20)
    pts = segm.sample_volume_points(rng, meta.aabb_np.T, st.n_sample_res).reshape(-1, 3)
    xyz = torch.as_tensor(segm.normalize_coord_np(meta, pts).astype(np.float32))
    cpu_params = kplane.map_params(lambda x: x.cpu(), st.scene_params)
    cpu_st = segm.SegmTrainer(cfg, cpu_params, meta, point_budget=SEGM_BUDGET, device="cpu")
    with uncounted():
        got = st.alpha_at_t0(xyz.to(device)).cpu()
    t0 = time.perf_counter()
    want = cpu_st.alpha_at_t0(xyz)
    gaps = alpha_gaps(tag, f"alpha_at_t0 of an iteration's {st.n_sample_res}^3 points", got,
                      want, meta.alpha_mask_thres * st.alpha_scale, True,
                      time.perf_counter() - t0)
    xyzt = torch.cat([xyz, kplane.normalize_time(meta, torch.zeros(len(xyz), 1))], -1)
    ps, pt = st.scene_params["planes_space"], st.scene_params["planes_time"]
    with uncounted():
        _, gaps["k1d"] = k1d_at(f"{tag}: an iteration's {st.n_sample_res}^3 points at t = 0 on "
                                f"the trainer scene's {tuple(meta.grid_size)} planes", ps, pt,
                                xyzt.to(device).contiguous(), meta.density_n_comp)
    return gaps


def check_transfer_chunk_against_cpu(tag, out, device):
    """256 rays of the segmentation driver's second view, rendered with
    transfer, its mask and its MaskField, the card against the port on the
    CPU, the mask map included."""
    poses, times, (H, W, focal) = out["views"]
    meta, params, mp, state = out["meta"], out["params"], out["mask_params"], out["alpha_state"]
    cam = rays.Camera(poses[1], H, W, focal, near=meta.near_far[0], far=meta.near_far[1])
    idx = np.arange(256) * (H * W // 256)
    co, cd = cam.rays_o.reshape(-1, 3)[idx], cam.rays_d.reshape(-1, 3)[idx]
    t = float(times[1])
    steps = 1 if kplane.render_steps_for_time(meta, t, True) == 1 else meta.transfer_adv_steps
    kw = dict(white_bg=out["white_bg"], transfer_vel=True, adv_steps=steps)
    with uncounted():
        gpu = kplane.render_rays(params, meta, t, co, cd, alpha_state=state, mask_params=mp,
                                 device=device, **kw)
    to_cpu = functools.partial(kplane.map_params, lambda x: x.cpu())
    t0 = time.perf_counter()
    cpu = kplane.render_rays(to_cpu(params), meta, t, co, cd, alpha_state=to_cpu(state),
                             mask_params=to_cpu(mp), device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    gpu = {k: v.cpu() for k, v in gpu.items() if isinstance(v, torch.Tensor)}
    errs = {k: float((gpu[k] - cpu[k]).abs().max()) for k in ("rgb", "acc", "mask")}
    print(f"[{tag}] t={t:.4f} ({steps} RK2 steps to t = 0): 256-ray transfer chunk with the "
          f"mask and the head, card vs CPU max err {errs} (CPU chunk {cpu_s:.1f} s)")
    require(all(e <= 1e-4 for e in errs.values()), f"{tag}: card vs CPU {errs}")
    require(bool(((gpu["depth"] - cpu["depth"]).abs() <= 1e-4 * cpu["depth"].abs()).all()),
            f"{tag}: depth rtol 1e-4")
    require(np.abs(out["pred_masks"][1].reshape(-1, meta.mask_dim)[idx] -
                   gpu["mask"].numpy()).max() <= 1e-4, f"{tag}: the chunk disagrees with the view")


def phase_segm_render(card, scene_dir, mask_path, device):
    """python -m nvfi_torch.test_segm_render on the `trainer` scene and the
    MaskField of `segm_train`: the transfer mask at 128^3, two views through
    the head, the metrics and the PLY export."""
    tag = "segm_render"
    outdir = tempfile.mkdtemp(prefix="nvfi_segm_render_")
    args = ["--synthetic", "--scene_dir", scene_dir, "--ckpt_segm", mask_path, "--n_views",
            str(SEGM_VIEWS), "--export_points", str(SEGM_EXPORT), "--outdir", outdir,
            "--device", device.type]
    print(f"[{tag}] python -m nvfi_torch.test_segm_render {' '.join(args)}")
    builds, frames = CallTimer(kplane, "update_alpha_mask"), CallTimer(renderer, "render_image")
    with builds, frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = test_segm_render.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
        sec = time.perf_counter() - t0
    meta = out["meta"]
    grid = tuple(min(g, TRANSFER_GRID) for g in meta.grid_size)
    H, W, _ = out["views"][2]
    build = builds.calls[0]
    print(f"[{tag}] {sec:.2f} s in all; transfer mask {grid} ({meta.transfer_adv_steps} RK2 "
          f"steps, 60 times) in {build['s']:.2f} s with {build['launches']}, occupancy "
          f"{float(out['alpha_state']['volume'].mean()):.4f}; frames "
          f"{[round(c['s'], 4) for c in frames.calls]} s = "
          f"{[round(H * W / c['s']) for c in frames.calls]} rays/s with "
          f"{[c['launches'] for c in frames.calls]}; metrics {out['results']} [{card}]")
    require(len(builds.calls) == 1 and build["launches"] == {
        "plane_product_density_fwd": sweep_launches(grid)}, f"{tag}: the build {build}")
    require(tuple(out["alpha_state"]["volume"].shape) == grid[::-1], f"{tag}: mask grid")
    one = {"plane_product_fwd": 1, "composite_fwd": 1, "occupancy_trilinear_fwd": 1}
    require(len(frames.calls) == SEGM_VIEWS and all(c["launches"] == one for c in frames.calls),
            f"{tag}: frames {frames.calls}")
    want = {**{k: SEGM_VIEWS for k in one}, "plane_product_density_fwd": sweep_launches(grid) + 1}
    require({k: v for k, v in launches.items() if v} == want,
            f"{tag}: launches {launches}, want {want} (the export's K1d included)")
    require(all(np.isfinite(v) for v in out["results"].values()), f"{tag}: {out['results']}")
    masks = out["pred_masks"]
    require(masks.shape == (SEGM_VIEWS, H, W, meta.mask_dim) and np.isfinite(masks).all(),
            f"{tag}: masks {masks.shape}")
    # softmax slots: a pixel's masks sum to the weight above rayMarch_weight_thres
    gap = out["acc"] - masks.sum(-1)
    bound = meta.n_samples * meta.raymarch_weight_thres
    print(f"[{tag}] acc - sum of the masks: min {gap.min():.3e}, max {gap.max():.3e} (in "
          f"[-1e-5, {bound:.4f}]: the weight under rayMarch_weight_thres); acc mean "
          f"{out['acc'].mean():.4f}")
    require(gap.min() >= -1e-5 and gap.max() <= bound + 1e-5, f"{tag}: masks vs acc {gap}")
    plys = [p for p in out["exported"] if p.endswith(".ply")]
    require(len(plys) == 3, f"{tag}: {out['exported']}")
    for path in plys:
        counts, rows = ply_head(path, PLY_SAMPLE)
        require(counts["vertex"] > 0 and rows.shape == (min(PLY_SAMPLE, counts["vertex"]), 6)
                and np.isfinite(rows).all() and ((rows[:, 3:] >= 0) & (rows[:, 3:] <= 255)).all(),
                f"{tag}: {path}: {counts}, sample {rows.shape}")
        print(f"[{tag}] {os.path.basename(path)}: {counts['vertex']} vertices, "
              f"{counts['face']} faces, {counts['edge']} edges; the header and the first "
              f"{len(rows)} vertices read back, finite")
    box = point_viz.load_ply_mesh(plys[2])
    require(box["vertices"].shape == (8, 3) and box["edges"].shape == (12, 2),
            f"{tag}: the bbox {box['vertices'].shape}, {box['edges'].shape}")
    check_transfer_chunk_against_cpu(tag, out, device)
    mask_chunk = check_transfer_mask_chunk(tag, out, device)
    return launches, {"seconds": sec, "build_s": build["s"], "grid": list(grid),
                      "frame_s": [c["s"] for c in frames.calls], "metrics": out["results"],
                      "mask_gap": [float(gap.min()), float(gap.max())],
                      "transfer_mask_chunk": mask_chunk}


PLY_SAMPLE = 4096  # the vertices read back of each PLY file


def ply_head(path, n):
    """The element counts of a PLY file that point_viz.save_ply_mesh wrote,
    and its first n vertex rows (x, y, z, r, g, b)."""
    counts = {"vertex": 0, "face": 0, "edge": 0}
    with open(path) as fh:
        require(fh.readline().strip() == "ply", f"{path} is not a PLY file")
        for line in fh:
            tok = line.split()
            if tok[0] == "element":
                counts[tok[1]] = int(tok[2])
            elif tok[0] == "end_header":
                break
        rows = [fh.readline().split() for _ in range(min(n, counts["vertex"]))]
    return counts, np.array(rows, np.float64).reshape(-1, 6)


def check_transfer_mask_chunk(tag, out, device):
    """The middle chunk of the transfer mask sweep at its last time (the
    farthest from t = 0), the card against the port on the CPU (alpha, and
    which side of alphaMask_thres), then K1d against its plain version at
    the chunk's positions advected to t = 0."""
    meta, params = out["meta"], out["params"]
    grid = tuple(min(g, TRANSFER_GRID) for g in meta.grid_size)
    n_chunks = -(-int(np.prod(grid)) // ALPHA_CHUNK)
    xyz = grid_ordered_xyz(meta, grid, n_chunks // 2, device)
    t, steps = (ALPHA_TIMES - 1) / ALPHA_TIMES, meta.transfer_adv_steps
    with uncounted(), torch.inference_mode():
        got = kplane.dense_alpha_chunk(params, meta, xyz, t, steps, transfer=True).cpu()
        cpu_params = kplane.map_params(lambda x: x.cpu(), params)
        t0 = time.perf_counter()
        want = kplane.dense_alpha_chunk(cpu_params, meta, xyz.cpu(), t, steps, transfer=True)
        cpu_s = time.perf_counter() - t0
        gaps = alpha_gaps(tag, f"transfer mask chunk {n_chunks // 2} of {n_chunks} of {grid} at "
                          f"t={t:.4f} ({steps} RK2 steps to t = 0)", got, want,
                          meta.alpha_mask_thres, False, cpu_s)
        tt = torch.full((xyz.shape[0], 1), t, dtype=torch.float32, device=device)
        base = torch.zeros_like(tt)
        prev = kplane.integrate_pos(params, meta, xyz, tt, base, n_steps=steps)
        xyzt = torch.cat([prev, kplane.normalize_time(meta, base)], -1).contiguous()
        _, gaps["k1d"] = k1d_at(f"{tag}: that chunk advected to t = 0, the trainer scene's "
                                f"{tuple(meta.grid_size)} planes", params["planes_space"],
                                params["planes_time"], xyzt, meta.density_n_comp)
    return gaps


def phase_transfer(card, host_dir, donor_dir, device):
    """python -m nvfi_torch.test_transfer_vel: the f32 `trainer` scene with
    the velocity of the bf16 `trainer_bf16` run grafted in, the transfer
    mask at 128^3, two test views and the 16-frame GIF sweep; the view at
    t = 0 equal bit for bit to the host's own frame there."""
    tag = "transfer"
    args = ["--synthetic", "--scene_dir", host_dir, "--scene_dir2", donor_dir, "--n_views",
            str(SEGM_VIEWS), "--alpha_grid", str(TRANSFER_GRID), "--device", device.type]
    print(f"[{tag}] python -m nvfi_torch.test_transfer_vel {' '.join(args)}")
    builds, frames = CallTimer(kplane, "update_alpha_mask"), CallTimer(harness, "render_image")
    with builds, frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = test_transfer_vel.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
        sec = time.perf_counter() - t0
    meta, dataset = out["meta"], out["dataset"]
    grid = tuple(min(g, TRANSFER_GRID) for g in meta.grid_size)
    H, W, focal = dataset[6]
    build = builds.calls[0]
    n_frames = SEGM_VIEWS + 16  # the split's views, then the GIF's frames
    print(f"[{tag}] {sec:.2f} s in all; transfer mask {grid} ({meta.transfer_adv_steps} RK2 "
          f"steps) in {build['s']:.2f} s with {build['launches']}; {len(frames.calls)} frames "
          f"of {H}x{W}: median {frames.median():.4f} s = {H * W / frames.median():.0f} rays/s, "
          f"launches a frame {frames.calls[0]['launches']}; PSNR by view "
          f"{[round(p, 3) for p in out['psnr']]} [{card}]")
    require(len(builds.calls) == 1 and build["launches"] == {
        "plane_product_density_fwd": sweep_launches(grid)}, f"{tag}: the build {build}")
    one = {"plane_product_fwd": 1, "composite_fwd": 1, "occupancy_trilinear_fwd": 1}
    require(len(frames.calls) == n_frames and all(c["launches"] == one for c in frames.calls),
            f"{tag}: frames {[c['launches'] for c in frames.calls]}")
    want = {**{k: n_frames for k in one}, "plane_product_density_fwd": sweep_launches(grid)}
    require({k: v for k, v in launches.items() if v} == want, f"{tag}: launches {launches}, "
            f"want {want}")
    require(np.isfinite(out["preds"]).all() and np.isfinite(out["psnr"]).all(),
            f"{tag}: {out['psnr']}")
    require(os.path.getsize(out["gif"]) > 0, f"{tag}: no GIF")
    donor, _, _, _, _ = checkpoint.load(checkpoint.find_checkpoint(donor_dir), device=device)
    require(all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(out["params"]["vel"]),
                                                  optim.tree_leaves(donor["vel"]))),
            f"{tag}: the donor's velocity is not the grafted one")
    # the t = 0 view is the host's own frame at t = 0, bit for bit
    require(float(dataset[2]["test"][0]) == 0.0, f"{tag}: the first view is not at t = 0")
    host, host_meta, _, _, _ = checkpoint.load(checkpoint.find_checkpoint(host_dir),
                                               device=device)
    cam = rays.Camera(dataset[1]["test"][0], H, W, focal, near=meta.near_far[0],
                      far=meta.near_far[1])
    with uncounted():
        plain = render_image(host, kplane.eval_exact_meta(host_meta), 0.0, cam.rays_o,
                             cam.rays_d, white_bg=bool(load_config(os.path.join(
                                 host_dir, "config.yaml")).dataset.white_background),
                             alpha_state=out["alpha_state"], device=device)
    same = np.array_equal(plain["rgb"], out["preds"][0])
    print(f"[{tag}] t=0 view: the transfer frame {'equals' if same else 'DIFFERS FROM'} the "
          f"host's non-transfer frame bit for bit (max |diff| "
          f"{np.abs(plain['rgb'] - out['preds'][0]).max():.3e}); PSNR "
          f"{out['psnr'][0]:.3f} dB there; GIF {os.path.getsize(out['gif'])} bytes")
    require(same, f"{tag}: the t = 0 transfer frame differs from the host's")
    return launches, {"seconds": sec, "build_s": build["s"], "grid": list(grid),
                      "frame_median_s": frames.median(), "psnr": out["psnr"],
                      "errors": out["errors"]}


# ---------------------------------------------------------------------------
# the supervised run and the two scoring scripts, on the trainer's scene
# ---------------------------------------------------------------------------

SUPERVISE_TIMEOUT = 600  # s for the whole supervised run, both attempts
SUPERVISE_KILL_AFTER = 6  # the checkpoint whose appearance ends the first child
SUPERVISE_PROFILE = 2  # --profile: the traced steps of each attempt
VIDEO_FRAMES, VIDEO_RES, VIDEO_GRID = 40, 128, 128  # render_video's defaults
VIDEO_CPU_RAYS = 256  # a frame's rays rendered again on the CPU, spread over it
EVAL_RES, EVAL_FRAMES = 64, 8  # eval_all cut to its test split of 8 views at 64^2


def children_of(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return out


def trace_kernels(path):
    """{kernel name: launches} of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def phase_supervise(card, device):
    """python -m nvfi_torch.train_nvfi --supervise --profile 2 on the
    `trainer` phase's config and compressed schedule with multi-frame
    batches: once the first child has written model_00006, it is killed
    (SIGKILL to its pid, not to the supervisor); the supervisor must restart
    it once with --resume, the resumed run must end at the last iteration,
    and both attempts' traces must hold the port's kernels by name."""
    tag = "supervise"
    logdir = tempfile.mkdtemp(prefix="nvfi_supervise_")
    argv = [sys.executable, "-u", "-m", "nvfi_torch.train_nvfi", "--supervise", "--profile",
            str(SUPERVISE_PROFILE), "--config", str(TRAINER_CONFIG), "--static_dynamic",
            "--synthetic", "--device", device.type, "--logdir", logdir, *TRAINER_SCHEDULE,
            "experiment.multi_frame_batch", "true"]
    print(f"[{tag}] {' '.join(argv[1:])}")
    log_path = os.path.join(logdir, "supervised.log")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        parent = subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                  start_new_session=True)
    try:
        ckpt = os.path.join(logdir, f"model_{SUPERVISE_KILL_AFTER:05d}.json")
        while not os.path.exists(ckpt):
            require(parent.poll() is None, f"{tag}: the supervisor ended ({parent.returncode}) "
                    f"before model_{SUPERVISE_KILL_AFTER:05d}")
            require(time.perf_counter() - t0 < SUPERVISE_TIMEOUT, f"{tag}: no checkpoint")
            time.sleep(0.1)
        first = children_of(parent.pid)
        require(len(first) == 1, f"{tag}: the supervisor has children {first}")
        os.kill(first[0], signal.SIGKILL)
        killed_s = time.perf_counter() - t0
        rc = parent.wait(timeout=SUPERVISE_TIMEOUT)
    finally:
        if parent.poll() is None:
            for pid in children_of(parent.pid):
                os.kill(pid, signal.SIGKILL)
            os.killpg(parent.pid, signal.SIGKILL)
            parent.wait()
    sec = time.perf_counter() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith(("[supervise]", "[profile]", "[ckpt]")):
            print(f"[{tag}]   {line}")
    starts = [x for x in lines if x.startswith("[supervise] attempt")]
    print(f"[{tag}] killed the first child (pid {first[0]}) {killed_s:.1f} s in, after "
          f"model_{SUPERVISE_KILL_AFTER:05d}; the supervisor exited {rc} after {sec:.1f} s "
          f"[{card}]")
    require(rc == 0 and len(starts) == 2 and "--resume" in starts[1] and
            any("clean exit after 1 restart(s)" in x for x in lines),
            f"{tag}: rc {rc}, attempts {starts}; the log's end: {lines[-20:]}")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        its = [json.loads(x)["it"] for x in f]
    last = TRAINER_ITERS - 1
    require(its[-1] == last and os.path.exists(os.path.join(logdir, f"model_{last:05d}.npz")),
            f"{tag}: the resumed run logged {its}")
    resumed_from = SUPERVISE_KILL_AFTER + 1
    traces = sorted(os.listdir(os.path.join(logdir, "profile")))
    require(traces == ["trace_00000.json", f"trace_{resumed_from:05d}.json"],
            f"{tag}: traces {traces}")
    kernels = {}
    for name in traces:
        found = trace_kernels(os.path.join(logdir, "profile", name))
        ours = {k: v for k, v in found.items() if any(p in k for p in PORT_KERNELS)}
        print(f"[{tag}] {name}: {sum(found.values())} kernel events, the port's: "
              + ", ".join(f"{k[:70]} x{v}" for k, v in sorted(ours.items())))
        kernels[name] = ours
    named = {p for ours in kernels.values() for k in ours for p in PORT_KERNELS if p in k}
    want = {"plane_product_kernel", "plane_product_bwd_kernel", "composite_fwd_kernel",
            "composite_bwd_kernel", "occupancy_nearest_fwd_kernel", "row_gather_fwd_kernel"}
    require(want <= named, f"{tag}: the traces name {named}, not {want - named}")
    return {"seconds": sec, "killed_at_s": killed_s, "logged_its": its,
            "traced_port_kernels": {n: sum(v.values()) for n, v in kernels.items()}}


def phase_video(card, scene_dir, device):
    """python -m nvfi_torch.render_video on the `trainer` scene's f32
    checkpoint at its defaults (128^2, 40 frames over t in [0, 1], the mask
    at 128^3): frames a second, the mask build's seconds, launches a frame;
    frame 0 (t = 0) and one past tmax against the port on the CPU."""
    tag = "video"
    outdir = tempfile.mkdtemp(prefix="nvfi_video_")
    args = ["--scene_dir", scene_dir, "--synth_res", str(VIDEO_RES), "--n_frames",
            str(VIDEO_FRAMES), "--alpha_grid", str(VIDEO_GRID), "--outdir", outdir, "--device",
            device.type]
    print(f"[{tag}] python -m nvfi_torch.render_video {' '.join(args)}")
    builds, frames = CallTimer(kplane, "update_alpha_mask"), CallTimer(renderer, "render_image")
    with builds, frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = render_video.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
        sec = time.perf_counter() - t0
    meta, alpha_state = out["meta"], out["alpha_state"]
    grid = tuple(min(g, VIDEO_GRID) for g in meta.grid_size)
    build = builds.calls[0]
    frame_s = [c["s"] for c in frames.calls]
    n_chunks = -(-VIDEO_RES * VIDEO_RES // CHUNK)
    one = {"plane_product_fwd": n_chunks, "composite_fwd": n_chunks,
           "occupancy_trilinear_fwd": n_chunks}
    past = [i for i, t in enumerate(out["times"]) if t > meta.tmax]
    print(f"[{tag}] {sec:.2f} s in all: mask {grid} in {build['s']:.2f} s with "
          f"{build['launches']}, occupancy {float(alpha_state['volume'].mean()):.4f}; "
          f"{VIDEO_FRAMES} frames of {VIDEO_RES}^2: median {np.median(frame_s):.4f} s "
          f"(t <= tmax {np.median(frame_s[:past[0]]):.4f}, past it "
          f"{np.median(frame_s[past[0]:]):.4f}) = {len(frame_s) / sum(frame_s):.2f} frames/s "
          f"({VIDEO_RES * VIDEO_RES * len(frame_s) / sum(frame_s):.0f} rays/s); launches a "
          f"frame {frames.calls[0]['launches']} [{card}]")
    require(out["frames"].shape == (VIDEO_FRAMES, VIDEO_RES, VIDEO_RES, 3),
            f"{tag}: frames {out['frames'].shape}")
    require(len(builds.calls) == 1 and build["launches"] == {
        "plane_product_density_fwd": sweep_launches(grid)}, f"{tag}: the build {build}")
    require(len(frames.calls) == VIDEO_FRAMES and all(c["launches"] == one for c in frames.calls),
            f"{tag}: launches a frame {[c['launches'] for c in frames.calls]}, want {one}")
    require(os.path.exists(os.path.join(outdir, "video.gif")) and len(
        [n for n in os.listdir(outdir) if n.endswith(".png")]) == VIDEO_FRAMES, f"{tag}: outputs")
    # frame 0 and the first frame past tmax, some of their rays on the CPU: a
    # ray's samples do not depend on its chunk's other rays unless the chunk is
    # padded (zero origins, inside the box, move every ray's start to near)
    require(VIDEO_RES * VIDEO_RES % CHUNK == 0, f"{tag}: a padded chunk")
    cfg = load_config(os.path.join(scene_dir, "config.yaml"))
    params_cpu, _ = test_transfer_vel.load_scene(cfg, -1, scene_dir, torch.device("cpu"))
    alpha_cpu = {k: v.cpu() for k, v in alpha_state.items()}
    focal = 0.5 * VIDEO_RES / np.tan(0.5 * 0.6911112)
    stride = VIDEO_RES * VIDEO_RES // VIDEO_CPU_RAYS
    idx = np.arange(VIDEO_CPU_RAYS) * stride + stride // 2
    levels = {}
    thetas = np.linspace(-180, 180, VIDEO_FRAMES, endpoint=False)
    white_bg = bool(cfg.dataset.white_background)

    def spread(x):  # VIDEO_CPU_RAYS rays spread over the frame, as a (16, n / 16) image
        return x.reshape(-1, 3)[idx].reshape(16, VIDEO_CPU_RAYS // 16, 3)

    for i in (0, past[0]):
        o, d = rays.ray_bundle(_spherical_pose(float(thetas[i]), -30.0, 4.0), VIDEO_RES,
                               VIDEO_RES, focal)
        t = float(out["times"][i])
        with uncounted():
            cpu = renderer.render_image(params_cpu, meta, t, spread(o), spread(d),
                                        white_bg=white_bg, alpha_state=alpha_cpu,
                                        chunk=VIDEO_CPU_RAYS, device="cpu")
        want = (np.clip(cpu["rgb"], 0, 1) * 255).astype(np.uint8).reshape(-1, 3)
        got = out["frames"][i].reshape(-1, 3)[idx]
        levels[i] = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        print(f"[{tag}] frame {i} (t = {t:.4f}, {adv_steps_for(meta, t)} RK2 steps): "
              f"{VIDEO_CPU_RAYS} rays card vs CPU, largest difference {levels[i]} levels; "
              f"share of those pixels off the background "
              f"{float((np.abs(want.astype(np.int16) - 255 * white_bg) > 5).any(-1).mean()):.3f}")
        require(levels[i] <= 1, f"{tag}: frame {i} differs from the CPU's by {levels[i]} levels")
    return launches, {"seconds": sec, "build_s": build["s"], "grid": list(grid),
                      "frame_s": frame_s, "frames_per_s": len(frame_s) / sum(frame_s),
                      "launches_a_frame": frames.calls[0]["launches"], "cpu_levels": levels}


def phase_eval_all(card, scene_dir, device):
    """python -m nvfi_torch.eval_all on the `trainer` scene, cut to its test
    split (8 views at 64^2; 8 train frames made, none used): the PSNRs
    (interpolation / extrapolation at tmax), the velocity EPE at t = 0.2,
    0.5, 0.7 and the advection error from 0.5 back to 0, the velocity numbers
    against the port on the CPU."""
    tag = "eval_all"
    args = ["--scene_dir", scene_dir, "--res", str(EVAL_RES), "--frames", str(EVAL_FRAMES),
            "--device", device.type]
    print(f"[{tag}] python -m nvfi_torch.eval_all {' '.join(args)}")
    frames = CallTimer(harness, "render_image")
    with frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = eval_all.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
        sec = time.perf_counter() - t0
    require(len(out["psnr"]) == 8 and all(np.isfinite(out["psnr"])) and
            np.isfinite(out["errors"]["psnr"]), f"{tag}: PSNRs {out['psnr']}")
    vel = {t: v for t, v in out["velocity"].items()}
    require(all(np.isfinite(x) for v in vel.values() for x in v.values()) and
            all(np.isfinite(x) for x in out["advection"].values()), f"{tag}: {vel}")
    # the velocity numbers on the CPU, from the same checkpoint and objects
    cfg = load_config(os.path.join(scene_dir, "config.yaml"))
    params_cpu, meta_cpu = test_transfer_vel.load_scene(cfg, -1, scene_dir, torch.device("cpu"))
    objects = make_synthetic_scene(n_train=1, n_val=1, n_test=1, H=8, W=8,
                                   objects=str(cfg.dataset.get("synthetic_objects", "bat")))[7][
        "objects"]
    worst = 0.0
    for t, v in list(vel.items()) + [("advection", out["advection"])]:
        want = (velocity_eval.advection_error(params_cpu, meta_cpu, objects, 0.0, 0.5)
                if t == "advection" else velocity_eval.velocity_epe(params_cpu, meta_cpu,
                                                                    objects, t))
        for k, w in want.items():
            rel = abs(v[k] - w) / max(abs(w), 1e-12)
            worst = max(worst, rel)
            require(rel <= 1e-4, f"{tag}: {t} {k} card {v[k]} vs CPU {w}")
    print(f"[{tag}] {sec:.2f} s in all ({len(frames.calls)} frames, median "
          f"{np.median([c['s'] for c in frames.calls]):.4f} s); PSNR by view "
          f"{[round(p, 3) for p in out['psnr']]}; interpolation {out['interp']:.3f} dB, "
          f"extrapolation {out['extrap']:.3f} dB; velocity EPE (relative, moving) "
          f"{ {t: round(v['rel_epe_moving'], 4) for t, v in vel.items()} }; advection error "
          f"{out['advection']['adv_err_mean']:.4f} of {out['advection']['displacement_mean']:.4f} "
          f"displacement; velocity numbers card vs CPU within rtol {worst:.2e} [{card}]")
    return launches, {"seconds": sec, "psnr": out["psnr"], "interp": out["interp"],
                      "extrap": out["extrap"], "errors": out["errors"],
                      "velocity": {str(t): v for t, v in vel.items()},
                      "advection": out["advection"], "velocity_rtol_vs_cpu": worst}


# ---------------------------------------------------------------------------
# static TensoRF (VM and CP): kernels K6, K6d and K6b, the static CLI run,
# one full-width step three ways, a masked frame, the CP arm, a tiny scene
# ---------------------------------------------------------------------------

STATIC_MODELS = {"VM": "TensorVMSplit", "CP": "TensorCP"}
STATIC_ITERS = 14
# the schedule compressed: upsamples after iterations 2, 4, 6, 8 and 10, so
# that 11 to 13 run at the final width (N_voxel_final over the shrunk box),
# and alpha-mask builds with their shrink at 4 and 8 (bat lists none)
STATIC_SCHEDULE = ["experiment.train_iters", str(STATIC_ITERS),
                   "nvfi.upsamp_list", "[2,4,6,8,10]", "nvfi.update_AlphaMask_list", "[4,8]",
                   "experiment.print_every", "1"]
STATIC_EVENTS = [(2, "upsample"), (4, "alpha"), (4, "upsample"), (6, "upsample"),
                 (8, "alpha"), (8, "upsample"), (10, "upsample")]
STATIC_CP_ITERS = 4  # the CP arm: an upsample to the final width after 1, a mask at 2
STATIC_CP_SCHEDULE = ["experiment.train_iters", str(STATIC_CP_ITERS), "nvfi.upsamp_list", "[1]",
                      "nvfi.update_AlphaMask_list", "[2]", "experiment.print_every", "1"]
STATIC_STEP_LAUNCHES = {"plane_line_fwd": 1, "plane_line_bwd": 1, "composite_fwd": 1,
                        "composite_bwd": 1}
STATIC_MASK_GRID = (199, 199, 199)  # a fresh mask at bat's final width: 31 sweep chunks
STATIC_CPU_RAYS = 256  # the rays of the step and of each frame held against the CPU
STATIC_TRAIN_RAYS = 2048  # bat's renderer.n_rays: one batch a static step
STATIC_BLOB = 0.45  # the seeded density blob's width, in normalized coords
# static_frame's blob: a width an axis, so that its mask's box crops each axis
# by another share and the shrunk grid is non-cubic (a transposition of the
# planes' H and W or of the lines would show there, not on a cube)
STATIC_SHRINK_BLOB = (0.40, 0.28, 0.20)
# K6 / K6d / K6b on their one-channel arm (channels not a multiple of 4): a
# non-cubic grid, (Cd, Ca) a case; Cd 66 halves K6's run to fit shared memory
STATIC_NARROW_GRID = (37, 29, 45)
STATIC_NARROW_CHANNELS = ((6, 6), (66, 10))
STATIC_NARROW_P = 65536
# tests/test_static.py's static_cfg: the tiny scene that must learn
STATIC_LEARNS_CFG = {
    "experiment": {
        "randomseed": 0, "lr_grid": 0.02, "lr_net": 1e-3, "lr_decay_iters": -1,
        "lr_decay_target_ratio": 0.1, "lr_upsample_reset": 1, "train_iters": 150,
        "L1_weight_inital": 8e-4, "L1_weight_reset": 4e-4, "TV_weight_density": 0.0,
        "TV_weight_app": 0.0, "vel_reg_weight": 0.0, "vel_reg_n_pts": 64,
        "save_every": 10**9, "print_every": 20, "validate_every": 10**9,
    },
    "dataset": {"near": 2.0, "far": 6.0, "white_background": True},
    "renderer": {"n_rays": 256},
    "nvfi": {
        "bbox_x": [-2, 2], "bbox_y": [-2, 2], "bbox_z": [-2, 2],
        "model_name": "TensorVMSplit", "N_voxel_init": 16384, "N_voxel_final": 16384,
        "upsamp_list": [], "update_AlphaMask_list": [],
        "density_n_comp": [8, 8, 8], "appearance_n_comp": [8, 8, 8],
        "app_dim": 8, "densityMode": "Density", "shadingMode": "MLP_PE",
        "alphaMask_thres": 1e-4, "rayMarch_weight_thres": 1e-4,
        "density_shift": -10, "distance_scale": 25,
        "pos_pe": 6, "view_pe": 6, "fea_pe": 6, "featureC": 32,
        "step_ratio": 0.5, "fea2denseAct": "softplus",
        "max_n_samples": 48, "num_keyframes": 1, "num_keyframes_end": 1,
        "tmax": 0.0, "use_vel": False,
    },
}


def static_bat(decomposition, device, widths=(STATIC_BLOB,) * 3):
    """The static field at bat's widths (configs/synth/bat.yaml with the
    static model_name, its final 199^3 grid): seeded weights, then a smooth
    density blob over the density planes and lines (an untrained field is
    empty), ~20 at the centre, so sigma ~10 there; ``widths``: its width along
    each axis, in normalized coords."""
    cfg = load_config(str(CONFIG), ["nvfi.model_name", STATIC_MODELS[decomposition]])
    aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                     np.asarray(cfg.nvfi.bbox_z)], axis=-1)
    grid = n_to_reso(int(cfg.nvfi.N_voxel_final), aabb)
    meta = static.static_meta_from_cfg(cfg, aabb, grid, (cfg.dataset.near, cfg.dataset.far))
    params = tensorf_vm.init_params(torch.Generator().manual_seed(SEED), meta, device=device)
    gs, cd = meta.grid_size, meta.density_n_comp

    def profile(axis):
        u = np.linspace(-1, 1, gs[axis])
        return np.exp(-u**2 / (2.0 * widths[axis]**2))

    with torch.no_grad():
        if decomposition == "VM":
            amp = np.sqrt(20.0 / (3 * cd))
            for i, (m0, m1) in enumerate(grid_sample.MAT_SPACE):
                blob = np.outer(profile(m1), profile(m0))[..., None] * amp
                params["density_plane"][i] += torch.tensor(blob, dtype=torch.float32,
                                                           device=device)
        amp = (20.0 / cd) ** (1.0 / 3.0) if decomposition == "CP" else np.sqrt(20.0 / (3 * cd))
        for i in range(3):
            blob = profile(plane_line.VEC_MODE[i])[:, None] * amp
            params["density_line"][i] += torch.tensor(blob, dtype=torch.float32, device=device)
    return meta, params, bool(cfg.dataset.white_background), cfg


def static_groups(params, meta):
    cp = meta.decomposition == "CP"
    return (None if cp else params["density_plane"], params["density_line"],
            None if cp else params["app_plane"], params["app_line"])


def static_train_rays(o, d, n, seed):
    """``n`` distinct pixels of the image's rays (a train batch of the
    pose), and their flat indices."""
    idx = np.random.RandomState(seed).permutation(o.reshape(-1, 3).shape[0])[:n]
    return o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx], idx


def static_coords(meta, o, d, device, jitter_seed=None):
    """The normalized sample positions (N * S, 3) of rays (o, d), as
    render_rays builds them (with a per-ray jitter: the train step's)."""
    o = torch.as_tensor(o, dtype=torch.float32, device=device)
    d = torch.as_tensor(d, dtype=torch.float32, device=device)
    jitter = None
    if jitter_seed is not None:
        g = torch.Generator(device=device).manual_seed(jitter_seed)
        jitter = torch.rand(o.shape[0], 1, generator=g, device=device)
    pts, _, _ = tensorf_vm.sample_ray(meta, o, d, meta.n_samples, jitter)
    return tensorf_vm.normalize_coord(meta, pts).reshape(-1, 3).contiguous()


def plane_line_library(groups, xyz, density_only):
    """Library yardstick of K6 / K6d (never called by the port): three
    F.grid_sample on (1, C, H, W) planes and three on (1, C, L, 1) lines a
    kind (CP: the lines alone), the products and the density sum, in the
    library's channel-major layout."""
    dp, dl, ap, al = groups
    P = xyz.shape[0]
    zero = torch.zeros_like(xyz[:, 0])
    lgrid = [torch.stack([zero, xyz[:, plane_line.VEC_MODE[i]]], -1).view(1, P, 1, 2)
             for i in range(3)]
    pgrid = [torch.stack([xyz[:, m0], xyz[:, m1]], -1).view(1, P, 1, 2)
             for m0, m1 in grid_sample.MAT_SPACE]
    kinds = [(dp, dl)] + ([] if density_only else [(ap, al)])
    nchw = [([None] * 3 if planes is None else
             [p.permute(2, 0, 1)[None].contiguous() for p in planes],
             [ln.t()[None, :, :, None].contiguous() for ln in lines]) for planes, lines in kinds]

    def sample(x, grid):
        return F.grid_sample(x, grid, align_corners=True, padding_mode="zeros")[0, :, :, 0]

    def library():
        out = []
        for planes, lines in nchw:
            feats = [sample(lines[i], lgrid[i]) for i in range(3)]
            if planes[0] is None:
                feats = [feats[0] * feats[1] * feats[2]]
            else:
                feats = [sample(planes[i], pgrid[i]) * feats[i] for i in range(3)]
            out.append(feats)
        density = sum(f.sum(0) for f in out[0])
        return density if density_only else (density, torch.cat(out[1], 0))

    return library


def plane_line_counts(groups, density_only):
    """(bytes of the planes and lines read, Cd, Ca, modes)."""
    dp, dl, ap, al = groups
    kinds = [(dp, dl)] + ([] if density_only else [(ap, al)])
    n_bytes = sum(t.numel() * 4 for planes, lines in kinds for t in list(lines)
                  + list(planes or []))
    Ca = 0 if density_only else al[0].shape[-1]
    return n_bytes, dl[0].shape[-1], Ca, 1 if dp is None else 3


def lin_corners(u, size):
    """The two corners of a linear lookup along an axis of ``size`` points,
    as csrc/plane_line.cuh:linear_corners takes them: [(index, mask of the
    samples where that corner lies in the grid and weighs non-zero)] x 2."""
    x = (u + 1.0) * 0.5 * (size - 1)
    x0 = torch.floor(x)
    w1 = x - x0
    i0 = torch.clamp(x0, -2, size).long()
    return [(i0, (i0 >= 0) & (i0 <= size - 1) & (w1 != 1.0)),
            (i0 + 1, (i0 >= -1) & (i0 <= size - 2) & (w1 != 0.0))]


def plane_line_touched_bytes(groups, xyz, masks):
    """The plane and line bytes a lookup of these samples must move: the
    distinct 32-byte sectors of each plane and line that hold a corner row
    of non-zero weight.  ``masks``: for the density and the app kind, a list
    of (P,) bool masks of the samples that read it, one a mode (CP: the
    first serves the three lines), or None for a kind not read."""
    dp, dl, ap, al = groups
    sectors = 0
    for planes, lines, kind_masks in ((dp, dl, masks[0]), (ap, al, masks[1])):
        if kind_masks is None:
            continue
        C = lines[0].shape[-1]
        for i in range(3):
            x = xyz[kind_masks[0 if planes is None else i]]
            rows = torch.cat([idx[ok] for idx, ok in
                              lin_corners(x[:, plane_line.VEC_MODE[i]], lines[i].shape[0])])
            sectors += row_sectors(torch.unique(rows) * C, C, 4)
            if planes is not None:
                m0, m1 = grid_sample.MAT_SPACE[i]
                H, W = planes[i].shape[:2]
                rows = torch.cat([(iy * W + ix)[oy & ox]
                                  for iy, oy in lin_corners(x[:, m1], H)
                                  for ix, ox in lin_corners(x[:, m0], W)])
                sectors += row_sectors(torch.unique(rows) * C, C, 4)
    return 32 * sectors


def k6_at(tag, groups, xyz, density_only, yardsticks=True):
    """K6 (or K6d) against its plain version on these coords (rtol 1e-5, atol
    1e-5 of the largest value), and its times: through the wrapper, alone
    (graph_ms of the launch helper), plain and library (None without
    ``yardsticks``), bound."""
    dp, dl, ap, al = groups
    cp = dp is None
    P = xyz.shape[0]
    plan_args = groups[:2] if density_only else groups
    if density_only:
        got = [plane_line.plane_line_density(dp, dl, xyz)]
        with torch.no_grad():
            want = [plane_line.plane_line_reference(dp, dl, None, None, xyz, density_only=True)]
        wrapper = lambda: plane_line.plane_line_density(dp, dl, xyz)  # noqa: E731
        plain = lambda: plane_line.plane_line_reference(  # noqa: E731
            dp, dl, None, None, xyz, density_only=True)
    else:
        with torch.no_grad():
            got = list(plane_line.plane_line(*groups, xyz))
            want = list(plane_line.plane_line_reference(*groups, xyz))
        wrapper = lambda: plane_line.plane_line(*groups, xyz)  # noqa: E731
        plain = lambda: plane_line.plane_line_reference(*groups, xyz)  # noqa: E731
    torch.cuda.synchronize()
    name = ("K6d" if density_only else "K6") + (".CP" if cp else "")
    check_close(f"{name} ({tag})", got, want, rtol=1e-5, atol_rel=1e-5)
    err = max_err(got, want)
    with torch.no_grad():  # the library yardstick computes the same function
        lib = plane_line_library(groups, xyz, density_only)()
    lib = [lib] if density_only else [lib[0], lib[1].t()]
    check_close(f"{name} library ({tag})", lib, want, rtol=1e-4, atol_rel=1e-4)
    del lib
    if not density_only:
        full = plane_line.plane_line_density(dp, dl, xyz)
        require(torch.equal(full, got[0]), f"{name} ({tag}): K6d differs from K6's density")
    del got, want
    density = torch.empty(P, device=xyz.device)
    app = None
    if not density_only:
        app = torch.empty(P, al[0].shape[-1] * (1 if cp else 3), device=xyz.device)
    with torch.no_grad(), uncounted():
        ms = time_ms(wrapper)
        alone_ms = graph_ms(lambda: plane_line.launch_plane_line(
            *plan_args, *([None, None] if density_only else []), xyz, density, app,
            density_only))
        plain_ms = library_ms = None
        if yardsticks:
            plain_ms = time_ms(plain, reps=5, warmup=1)
            library_ms = time_ms(plane_line_library(groups, xyz, density_only), reps=5,
                                 warmup=1)
    read, Cd, Ca, modes = plane_line_counts(groups, density_only)
    # bytes: coords in, density and app out, and the plane and line sectors
    # these samples' corners touch (the whole planes and lines beside)
    every = [torch.ones(P, dtype=torch.bool, device=xyz.device)] * 3
    touched = plane_line_touched_bytes(groups, xyz, (every, None if density_only else every))
    io = P * 12 + P * 4 + P * modes * Ca * 4
    n_bytes = touched + io
    # a channel: VM 7 (plane) + 3 (line) + 1 (product); CP 3 x 3 + 2; the density
    # sum; ~24 a mode for the corner indices and weights
    n_ops = P * (11 * modes * (Cd + Ca) + modes * Cd + 24 * modes)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    whole_ms, _ = bound_ms(read + io, n_ops)
    plan = plane_line.plane_line_plan(Cd, Ca, cp, density_only,
                                      [t.data_ptr() for g in plan_args if g is not None
                                       for t in g])
    print(f"[{name}] {tag}: P={P} Cd={Cd} Ca={Ca} plan {plan}; max_abs_err={err:.3e}; kernel "
          f"{ms:.4f} ms ({alone_ms:.4f} alone), plain {plain_ms} ms, library {library_ms} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB with {touched / 1e6:.2f} MB of "
          f"plane and line sectors touched, {n_ops / 1e9:.2f} GFLOP; {whole_ms:.4f} ms with the "
          f"whole {read / 1e6:.2f} MB); bound / alone {b_ms / alone_ms:.3f}")
    return with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms, "bound_whole_planes_ms": whole_ms,
                       "touched_bytes": touched, "P": P, "plan": plan.__dict__},
                      run_grid(P, plan.run))


@contextlib.contextmanager
def recorded_plane_line_grads(seen):
    """Inside, every launch of K6b (the backward of K6) records its coords
    and incoming grads in ``seen``."""
    inner = plane_line.launch_plane_line_backward

    def recording(dp, dl, ap, al, xyz, g_density, g_app, grads):
        seen.append((xyz, g_density.clone(), g_app.clone()))
        return inner(dp, dl, ap, al, xyz, g_density, g_app, grads)

    with patched(plane_line, "launch_plane_line_backward", recording):
        yield


def static_target(device):
    """A grey target image of the look_at pose: (poses (1,4,4), images (1,H,W,3))."""
    pose = torch.tensor(look_at(4.0, 0.6, 0.35), device=device)[None]
    return pose, torch.full((1, IMAGE, IMAGE, 3), 0.5, device=device)


def static_step_grad_inputs(meta, params, white_bg, hp, device):
    """(xyz, g_density, g_app) of the K6b call of one real train step (the
    step's loss on a grey target through the kernels), recorded."""
    loss_fn = static.make_static_loss_fn(meta, hp, IMAGE, IMAGE, FOCAL, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    draws = static.draw_static_inputs(gen, hp, IMAGE, IMAGE)
    as_leaves(params)
    seen = []
    with recorded_plane_line_grads(seen), uncounted():
        loss, _ = loss_fn(params, draws, 0, 0, *static_target(device))
        loss.backward()
    for p in optim.tree_leaves(params):
        p.grad = None
    require(len(seen) == 1, f"{len(seen)} K6b calls in one static step")
    return seen[0]


def plane_line_grad_library(groups, xyz, g_density, g_app):
    """Library yardstick of K6b: autograd through :func:`plane_line_library`
    (F.grid_sample's backward) for the same incoming grads."""
    leaves = [t.detach().requires_grad_(True) for g in groups if g is not None for t in g]
    it = iter(leaves)
    lgroups = [None if g is None else [next(it) for _ in g] for g in groups]
    forward = plane_line_library(lgroups, xyz, False)

    def library():
        density, app = forward()
        return torch.autograd.grad([density, app], leaves, [g_density, g_app.t()])

    return library


def k6b_at(tag, groups, xyz, g_density, g_app, yardsticks=True):
    """K6b against its plain version (rtol 1e-4, atol 1e-5 of each grad's
    largest: f32 atomics) on a step's coords and incoming grads, and its
    times (plain and library None without ``yardsticks``)."""
    dp, dl, ap, al = groups
    cp = dp is None
    P = xyz.shape[0]
    name = "K6b" + (".CP" if cp else "")
    got = plane_line.plane_line_backward(*groups, xyz, g_density, g_app)
    want = plane_line.plane_line_backward_reference(*groups, xyz, g_density, g_app)
    torch.cuda.synchronize()
    flat_got = [t for g in got if g is not None for t in g]
    flat_want = [t for g in want if g is not None for t in g]
    check_close(f"{name} ({tag})", flat_got, flat_want, rtol=1e-4, atol_rel=1e-5)
    err = max_err(flat_got, flat_want)
    del got, want, flat_got, flat_want
    grads = [None if g is None else [torch.zeros_like(t) for t in g] for g in groups]
    with uncounted():
        ms = time_ms(lambda: plane_line.plane_line_backward(*groups, xyz, g_density, g_app))
        alone_ms = graph_ms(lambda: plane_line.launch_plane_line_backward(
            *groups, xyz, g_density, g_app, grads))
        plain_ms = library_ms = None
        if yardsticks:
            plain_ms = time_ms(lambda: plane_line.plane_line_backward_reference(
                *groups, xyz, g_density, g_app), reps=3, warmup=1)
            library_ms = time_ms(plane_line_grad_library(groups, xyz, g_density, g_app),
                                 reps=3, warmup=1)
    read, Cd, Ca, modes = plane_line_counts(groups, False)
    width = g_app.shape[1]
    active_d = float((g_density != 0).float().sum())
    active_a = float((g_app != 0).float().sum())  # (sample, channel) slots with a grad
    any_grad = (g_density != 0) | (g_app != 0).any(-1)
    # bytes: the incoming grads in, the coords of the samples with a grad, and
    # the plane and line sectors those samples' corners touch, read and their
    # grads written once (the whole planes and lines beside)
    dmask = g_density != 0
    amask = (g_app != 0).any(-1) if cp else (g_app.view(P, 3, Ca) != 0).any(-1)
    touched = plane_line_touched_bytes(groups, xyz, ([dmask] * 3,
                                                     [amask[:, i] for i in range(3)] if not cp
                                                     else [amask]))
    io = P * 4 + P * width * 4 + int(any_grad.sum()) * 12
    n_bytes = 2 * touched + io
    per_channel = 25 if not cp else 26  # lookup, the two grads, the corner updates
    n_ops = (active_d * modes * Cd + active_a) * per_channel
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    whole_ms, _ = bound_ms(2 * read + io, n_ops)
    plan = plane_line.plane_line_bwd_plan(
        P, Cd, Ca, sum(int(t.shape[0]) for t in dl), [0],
        plane_line.multiprocessors(torch.cuda.current_device()))
    share = float(any_grad.float().mean())
    print(f"[{name}] {tag}: P={P}, samples with a grad {share:.4f} (density slots "
          f"{active_d:.0f}, app slots {active_a:.0f}), plan {plan}; max_abs_err={err:.3e}; "
          f"kernel {ms:.4f} ms ({alone_ms:.4f} alone, memset excluded), plain {plain_ms} ms, "
          f"library {library_ms} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB "
          f"with {touched / 1e6:.2f} MB of plane and line sectors touched, read and written, "
          f"{n_ops / 1e9:.2f} GFLOP; {whole_ms:.4f} ms with the whole {read / 1e6:.2f} MB); "
          f"bound / alone {b_ms / alone_ms:.3f}")
    grid = (-(-P // plan.run) * (plan.d_chunks + plan.a_chunks), SAMPLE_THREADS)
    return with_floor({"max_abs_err": err, "ms": ms, "kernel_alone_ms": alone_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms, "bound_whole_planes_ms": whole_ms,
                       "touched_bytes": touched, "P": P, "active_share": share,
                       "plan": plan.__dict__}, grid)


def phase_static_kernels(decomposition, o, d, device):
    """K6, K6d and K6b of one arm at the static path's shapes: K6 at the
    train step's 2048 x 686 samples (a jittered batch of the look_at pose)
    and at a 4096-ray render chunk (the middle of the frame); K6d at the
    grid-ordered middle chunk of the 199^3 mask sweep and at the render
    chunk; K6b on the coords and incoming grads of one real train step."""
    meta, params, white_bg, cfg = static_bat(decomposition, device)
    groups = static_groups(params, meta)
    hp = replace(trainer.TrainHP.from_cfg(cfg), n_rays=STATIC_TRAIN_RAYS)
    sfx = "_cp" if decomposition == "CP" else ""
    print(f"[static.{decomposition}] bat widths: grid {meta.grid_size}, Cd {meta.density_n_comp},"
          f" Ca {meta.app_n_comp}, app_dim {meta.app_dim}, n_samples {meta.n_samples}, shader "
          f"{meta.shading_mode} {meta.feature_c} wide")
    to, td, _ = static_train_rays(o, d, hp.n_rays, SEED + 31)
    train_xyz = static_coords(meta, to, td, device, jitter_seed=SEED + 32)
    mid = IMAGE * IMAGE // 2
    chunk_xyz = static_coords(meta, o.reshape(-1, 3)[mid:mid + CHUNK],
                              d.reshape(-1, 3)[mid:mid + CHUNK], device)
    require(train_xyz.shape[0] == STATIC_TRAIN_RAYS * meta.n_samples,
            f"train shape {train_xyz.shape}")
    fwd = k6_at("train step", groups, train_xyz, False)
    fwd["render_chunk"] = k6_at(f"render chunk, {CHUNK} rays", groups, chunk_xyz, False)
    n_chunks = -(-int(np.prod(STATIC_MASK_GRID)) // ALPHA_CHUNK)
    sweep = grid_ordered_xyz(meta, STATIC_MASK_GRID, n_chunks // 2, device)
    dens = k6_at(f"grid-ordered sweep chunk {n_chunks // 2} of {n_chunks}", groups, sweep, True)
    dens["render_chunk"] = k6_at(f"render chunk, {CHUNK} rays", groups, chunk_xyz, True)
    del chunk_xyz, sweep
    xyz, g_density, g_app = static_step_grad_inputs(meta, params, white_bg, hp, device)
    bwd = k6b_at("train step", groups, xyz, g_density, g_app)
    del xyz, g_density, g_app
    torch.cuda.empty_cache()
    replaces = "nvfi_tpu/fields/tensorf_vm.py"
    entries = [
        dict(name=f"plane_line_fwd{sfx}", route="cuda", source="nvfi_torch/csrc/plane_line.cu",
             replaces=f"{replaces}:137", **fwd),
        dict(name=f"plane_line_density_fwd{sfx}", route="cuda",
             source="nvfi_torch/csrc/plane_line.cu", replaces=f"{replaces}:119", **dens),
        dict(name=f"plane_line_bwd{sfx}", route="cuda",
             source="nvfi_torch/csrc/plane_line_bwd.cu", replaces=f"{replaces}:137", **bwd),
    ]
    return entries


def phase_static_narrow(device):
    """K6, K6d and K6b on their one-channel arm (``vec`` 1: channels not a
    multiple of 4), VM and CP, on seeded planes and lines over the non-cubic
    STATIC_NARROW_GRID, at coords spread over [-1.1, 1.1]^3 (some outside the
    box) and incoming grads zero on a quarter of the samples; each against
    its plain version (K6 / K6d rtol 1e-5, atol 1e-5 of the largest value;
    K6b rtol 1e-4, atol 1e-5 of each grad's largest).  With Cd 66 the VM
    arm's run halves to fit its shared memory.  Returns the max errors by
    case."""
    gen = torch.Generator().manual_seed(SEED + 40)
    gs = STATIC_NARROW_GRID
    P = STATIC_NARROW_P

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    xyz = (torch.rand(P, 3, generator=gen) * 2.2 - 1.1).to(device)
    live = (torch.rand(P, generator=gen) >= 0.25).to(device)
    out = {}
    for Cd, Ca in STATIC_NARROW_CHANNELS:
        for arm in ("VM", "CP"):
            cp = arm == "CP"

            def planes(C):
                return None if cp else [rand(gs[m1], gs[m0], C) for m0, m1 in grid_sample.MAT_SPACE]

            def lines(C):
                return [rand(gs[plane_line.VEC_MODE[i]], C) for i in range(3)]

            groups = (planes(Cd), lines(Cd), planes(Ca), lines(Ca))
            tag = f"narrow {arm} Cd={Cd} Ca={Ca} grid {gs}"
            leaves = [t for g in groups if g is not None for t in g]
            plan = plane_line.plane_line_plan(Cd, Ca, cp, False, [t.data_ptr() for t in leaves])
            require(plan.vec == 1, f"{tag}: K6 plan {plan}")
            if not cp and Cd == max(c for c, _ in STATIC_NARROW_CHANNELS):
                require(plan.run < plane_line.PLANE_LINE_RUN, f"{tag}: K6 plan {plan}")
            with uncounted(), torch.no_grad():
                got = list(plane_line.plane_line(*groups, xyz))
                got.append(plane_line.plane_line_density(groups[0], groups[1], xyz))
                want = list(plane_line.plane_line_reference(*groups, xyz))
                want.append(want[0])
                check_close(f"K6 / K6d ({tag})", got, want, rtol=1e-5, atol_rel=1e-5)
                fwd_err = max_err(got, want)
                g_density = rand(P) * live
                g_app = rand(*got[1].shape) * live[:, None]
                bgot = plane_line.plane_line_backward(*groups, xyz, g_density, g_app)
                bwant = plane_line.plane_line_backward_reference(*groups, xyz, g_density, g_app)
                bgot = [t for g in bgot if g is not None for t in g]
                bwant = [t for g in bwant if g is not None for t in g]
                check_close(f"K6b ({tag})", bgot, bwant, rtol=1e-4, atol_rel=1e-5)
                bwd_err = max_err(bgot, bwant)
            torch.cuda.synchronize()
            print(f"[K6.narrow] {tag}, P={P}: K6 plan {plan}; K6 / K6d max_abs_err "
                  f"{fwd_err:.3e}, K6b max_abs_err {bwd_err:.3e}")
            out[f"{arm} Cd={Cd} Ca={Ca}"] = {"plan": plan.__dict__, "fwd_max_abs_err": fwd_err,
                                             "bwd_max_abs_err": bwd_err}
    return out


class StaticRecorder:
    """While installed, every step a StaticTrainer builds (through
    static.make_static_step) is synchronized, timed and counted: one line a
    step with the wall time, loss and the launches of each kernel, which
    must equal STATIC_STEP_LAUNCHES (``sfx`` "_cp": the CP arms).  The first
    step of each stage checks its planes and lines: contiguous leaves on
    K6's 16-byte plan."""

    def __init__(self, tag, card, sfx=""):
        self.tag, self.card = tag, card
        self.want = {k.replace("plane_line_fwd", "plane_line_fwd" + sfx)
                     .replace("plane_line_bwd", "plane_line_bwd" + sfx): v
                     for k, v in STATIC_STEP_LAUNCHES.items()}
        self.steps, self.stages = [], []

    def __enter__(self):
        self._patch = patched(static, "make_static_step", self.wrap(static.make_static_step))
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)

    def wrap(self, build):
        def build_recorded(meta, hp, H, W, focal, device="cuda"):
            step = build(meta, hp, H, W, focal, device)
            first = [True]

            def run(params, opt_state, draws, frame_idx, it, poses, images):
                if first[0]:
                    first[0] = False
                    leaves = [t for g in static_groups(params, meta) if g is not None for t in g]
                    require(all(t.is_contiguous() and t.is_leaf for t in leaves),
                            f"{self.tag} it={it}: a plane or line is not a contiguous leaf")
                    plan = plane_line.plane_line_plan(
                        meta.density_n_comp, meta.app_n_comp, meta.decomposition == "CP",
                        False, [t.data_ptr() for t in leaves])
                    require(plan.vec == 4, f"{self.tag} it={it}: K6 plan {plan}")
                    mb = sum(t.numel() * 4 for t in leaves) / 1e6
                    self.stages.append({"it": it, "grid": list(meta.grid_size), "MB": mb,
                                        "n_samples": meta.n_samples})
                    print(f"[{self.tag}] stage from it={it}: grid {meta.grid_size}, "
                          f"{meta.n_samples} samples a ray, {mb:.1f} MB of planes and lines, "
                          f"contiguous; K6 plan {plan}")
                torch.cuda.synchronize()
                count0 = read_counts()
                t0 = time.perf_counter()
                out = step(params, opt_state, draws, frame_idx, it, poses, images)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                count1 = read_counts()
                launches = {k: count1[k] - count0[k] for k in count1 if count1[k] != count0[k]}
                loss = float(out[2]["loss"])
                print(f"[{self.tag}] it={it}: {sec:.4f} s, loss {loss:.6f}, grid "
                      f"{meta.grid_size}, P {hp.n_rays * meta.n_samples}; launches {launches} "
                      f"[{self.card}]")
                require(np.isfinite(loss), f"{self.tag} it={it}: loss {loss}")
                require(launches == self.want,
                        f"{self.tag} it={it}: launches {launches}, want {self.want}")
                self.steps.append({"it": it, "s": sec, "grid": list(meta.grid_size),
                                   "loss": loss, "P": hp.n_rays * meta.n_samples})
                return out

            return run

        return build_recorded


def static_stage_medians(tag, tr, recorder, card):
    """The events' lines and the median step of each stage."""
    for e in tr.events:
        secs = ", ".join(f"{k} {v:.3f} s" for k, v in e["seconds"].items())
        occ = "-" if e["occupancy"] is None else f"{e['occupancy']:.4f}"
        print(f"[{tag}] event it={e['it']} {e['kind']}: grid {e['grid']}, aabb {e['aabb']}, "
              f"occupancy {occ}; {secs} [{card}]")
    stages = {}
    for st in recorder.steps:
        stages.setdefault(tuple(st["grid"]), []).append(st)
    medians = []
    for grid, sts in stages.items():
        med = float(np.median([st["s"] for st in sts]))
        medians.append({"grid": list(grid), "its": [st["it"] for st in sts], "median_s": med,
                        "P": sts[0]["P"], "rays_per_s": tr.hp.n_rays / med})
        print(f"[{tag}] stage grid {grid}: iterations {[st['it'] for st in sts]}, median "
              f"{med:.4f} s a step ({sts[0]['P']} samples, {tr.hp.n_rays / med:.0f} rays/s) "
              f"[{card}]")
    return medians


def run_static_cli(tag, decomposition, schedule, card, device):
    """train_nvfi.main with the static model on bat.yaml's synthetic scene
    and the recorder installed; the counts around it are the path's."""
    logdir = tempfile.mkdtemp(prefix=f"nvfi_{tag}_")
    args = ["--config", str(CONFIG), "--synthetic", "--device", device.type, "--logdir", logdir,
            "nvfi.model_name", STATIC_MODELS[decomposition], *schedule]
    print(f"[{tag}] python -m nvfi_torch.train_nvfi {' '.join(args)}")
    recorder = StaticRecorder(tag, card, "_cp" if decomposition == "CP" else "")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with recorder:
        # -- the main path: counts set to 0 just before, read just after ----
        reset_counts()
        out = train_nvfi.main(args)
        torch.cuda.synchronize()
        launches = read_counts()
        # --------------------------------------------------------------------
    sec = time.perf_counter() - t0
    tr = out["trainer"]
    require(isinstance(tr, static.StaticTrainer), f"{tag}: the CLI built {type(tr)}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    medians = static_stage_medians(tag, tr, recorder, card)
    print(f"[{tag}] {len(recorder.steps)} iterations, {len(tr.events)} events in {sec:.1f} s; "
          f"final grid {tr.meta.grid_size}, aabb {tr.meta.aabb}; peak memory {peak_gb:.2f} GB; "
          f"launches {dict((k, v) for k, v in launches.items() if v)} [{card}]")
    return out, launches, recorder, {"seconds": sec, "stages": medians, "events": tr.events,
                                     "peak_memory_GB": peak_gb, "final_grid": tr.meta.grid_size,
                                     "final_aabb": tr.meta.aabb, "plane_checks": recorder.stages}


def phase_static(card, device):
    """The static CLI run on bat.yaml at full width, the schedule compressed
    (STATIC_SCHEDULE): exact launches every step, the events, the median
    step by stage, peak memory."""
    out, launches, recorder, numbers = run_static_cli("static", "VM", STATIC_SCHEDULE, card,
                                                      device)
    tr = out["trainer"]
    require([st["it"] for st in recorder.steps] == list(range(STATIC_ITERS)),
            f"static: steps ran at {[st['it'] for st in recorder.steps]}")
    require([(e["it"], e["kind"]) for e in tr.events] == STATIC_EVENTS,
            f"static: events {[(e['it'], e['kind']) for e in tr.events]}")
    final = tuple(tr.meta.grid_size)
    full = [st["it"] for st in recorder.steps if tuple(st["grid"]) == final]
    require(len(full) >= 3 and int(np.prod(final)) >= 0.9 * tr.hp.n_voxel_final,
            f"static: {len(full)} steps at the final grid {final}")
    # K6d: one sweep of the mask's grid (the grid at the event, at most 200 a
    # side) in chunks of ALPHA_CHUNK at each alpha event
    grids = {st["it"]: st["grid"] for st in recorder.steps}
    want = {k: v * STATIC_ITERS for k, v in STATIC_STEP_LAUNCHES.items()}
    want["plane_line_density_fwd"] = sum(
        -(-int(np.prod([min(g, 200) for g in grids[it]])) // ALPHA_CHUNK)
        for it, kind in STATIC_EVENTS if kind == "alpha")
    got = {k: v for k, v in launches.items() if v}
    require(got == want, f"static: launches {got}, want {want}")
    numbers["launches"] = {k: v for k, v in launches.items() if v}
    return launches, tr, numbers


def static_step_grads(meta, params, white_bg, hp, draws, device):
    """Per-leaf grads of the static loss on ``draws`` on ``device`` (params
    copied there), with the loss."""
    p = kplane.map_params(lambda x: x.detach().to(device).clone(), params)
    as_leaves(p)
    loss_fn = static.make_static_loss_fn(meta, hp, IMAGE, IMAGE, FOCAL, device)
    poses, images = (x.to(device) for x in static_target(device))
    d = static.StaticDraws(pix=draws.pix.to(device), jitter=draws.jitter.to(device),
                           coin=draws.coin)
    loss, _ = loss_fn(p, d, 0, 0, poses, images)
    loss.backward()
    return float(loss.detach()), {k: v.grad.detach().cpu() for k, v in flat_leaves(p).items()}


@contextlib.contextmanager
def static_plain_versions():
    """Inside, tensorf_vm's render takes the plain versions of K6 and K2
    under ordinary autograd on any device (the port never does this on a
    CUDA tensor)."""
    saved = tensorf_vm.plane_line, tensorf_vm.composite
    tensorf_vm.plane_line = plane_line.plane_line_reference
    tensorf_vm.composite = compositing.composite_reference
    try:
        yield
    finally:
        tensorf_vm.plane_line, tensorf_vm.composite = saved


def phase_static_step(card, device):
    """One step at full width (199^3, 2048 x 686 samples) from the start, on
    the seeded blob field against a grey target: the step's launches, its
    grads through the kernels against the card's plain versions (1e-4 +
    1e-4 x max|grad|), and a 256-ray batch's against the port on the CPU
    (1e-3 + 1e-3).  The CPU runs in float64: in float32 its scatter-adds
    into the plane grads, one after another, leave ~1e-3 of a leaf's
    largest grad in cells where many samples' terms cancel (the card's sums
    sit ~2e-5 from float64 there); its float32 gap is printed beside."""
    meta, params, white_bg, cfg = static_bat("VM", device)
    hp = replace(trainer.TrainHP.from_cfg(cfg), n_rays=STATIC_TRAIN_RAYS)
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    draws = static.draw_static_inputs(gen, hp, IMAGE, IMAGE)
    step = static.make_static_step(meta, hp, IMAGE, IMAGE, FOCAL, device)
    with uncounted():
        loss_k, grads_k = static_step_grads(meta, params, white_bg, hp, draws, device)
        with static_plain_versions():
            loss_p, grads_p = static_step_grads(meta, params, white_bg, hp, draws, device)
    grad_shares("static_step", f"{hp.n_rays}-ray step, kernels vs plain versions on the card",
                grads_k, grads_p, KERNEL_CHUNK_GRAD_RTOL, KERNEL_CHUNK_GRAD_ATOL_REL)
    small = replace(hp, n_rays=STATIC_CPU_RAYS)
    sd = static.StaticDraws(pix=draws.pix[:STATIC_CPU_RAYS],
                            jitter=draws.jitter[:STATIC_CPU_RAYS], coin=draws.coin)
    cpu = torch.device("cpu")
    with uncounted():
        _, grads_c = static_step_grads(meta, params, white_bg, small, sd, device)
        t0 = time.perf_counter()
        _, grads_cpu = static_step_grads(
            meta, kplane.map_params(lambda x: x.detach().cpu().double(), params), white_bg,
            small, sd, cpu)
        cpu_s = time.perf_counter() - t0
        _, grads_cpu32 = static_step_grads(
            meta, kplane.map_params(lambda x: x.detach().cpu(), params), white_bg, small, sd,
            cpu)
    grad_shares("static_step", f"{STATIC_CPU_RAYS}-ray batch, card kernels vs CPU float64 "
                f"({cpu_s:.1f} s)", grads_c, grads_cpu, CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL)
    grad_shares("static_step", "the same batch, CPU float32 vs CPU float64 (printed)",
                grads_cpu32, grads_cpu, CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL, check=False)
    opt_state = optim.init_state(params)
    poses, images = static_target(device)
    torch.cuda.synchronize()
    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    t0 = time.perf_counter()
    params, opt_state, metrics = step(params, opt_state, draws, 0, 0, poses, images)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    # ------------------------------------------------------------------------
    got = {k: v for k, v in launches.items() if v}
    require(got == STATIC_STEP_LAUNCHES, f"static_step: launches {got}")
    require(abs(float(metrics["loss"]) - loss_k) <= 1e-5 * abs(loss_k),
            f"static_step: loss {float(metrics['loss'])} vs {loss_k}")
    print(f"[static_step] loss {loss_k:.6f} (plain versions {loss_p:.6f}); one step at "
          f"{meta.grid_size} with {hp.n_rays} x {meta.n_samples} samples in {sec:.4f} s, launches "
          f"{got} [{card}]")
    return launches, {"seconds": sec, "loss": loss_k, "cpu_s": cpu_s}


def static_frame(tag, meta, params, white_bg, alpha_state, o, d, card, device):
    """One 400^2 frame through tensorf_vm.render_rays in 4096-ray chunks
    (with ``alpha_state``: masked), rays/s; its 256 spread rays against the
    port on the CPU (rgb and acc within 1e-4, depth rtol 1e-4)."""
    rays_o, rays_d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = rays_o.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = [tensorf_vm.render_rays(params, meta, rays_o[i:i + CHUNK], rays_d[i:i + CHUNK],
                                    white_bg=white_bg, alpha_state=alpha_state, device=device)
             for i in range(0, n, CHUNK)]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    img = {k: torch.cat([p[k] for p in parts]).cpu() for k in ("rgb", "acc", "depth")}
    del parts
    for k, v in img.items():
        require(bool(torch.isfinite(v).all()), f"{tag}: non-finite {k}")
    co, cd, idx = spread_rays(o, d, STATIC_CPU_RAYS)
    params_cpu = kplane.map_params(lambda x: x.detach().cpu(), params)
    state_cpu = None if alpha_state is None else checkpoint.alpha_state_from_numpy(
        checkpoint.alpha_state_to_numpy(alpha_state), "cpu")
    with uncounted():
        gpu = tensorf_vm.render_rays(params, meta, co, cd, white_bg=white_bg,
                                     alpha_state=alpha_state, device=device)
    cpu = tensorf_vm.render_rays(params_cpu, meta, co, cd, white_bg=white_bg,
                                 alpha_state=state_cpu, device="cpu")
    errs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in ("rgb", "acc", "depth")}
    require(errs["rgb"] <= 1e-4 and errs["acc"] <= 1e-4, f"{tag}: card vs CPU {errs}")
    require(bool(((gpu["depth"].cpu() - cpu["depth"]).abs() <= 1e-4 * cpu["depth"].abs()).all()),
            f"{tag}: depth rtol 1e-4")
    require(float((img["acc"][idx] - gpu["acc"].cpu()).abs().max()) <= 1e-6,
            f"{tag}: the spread rays disagree with the frame")
    share = float((img["acc"] > 0.5).float().mean())
    print(f"[{tag}] {IMAGE}x{IMAGE} in {sec:.3f} s = {n / sec:.0f} rays/s ({-(-n // CHUNK)} "
          f"chunks of {CHUNK} x {meta.n_samples} samples, grid {meta.grid_size}); acc>0.5 share "
          f"{share:.4f}, mean rgb {float(img['rgb'].mean()):.4f}; {STATIC_CPU_RAYS} spread rays "
          f"card vs CPU max err {errs} [{card}]")
    return {"seconds": sec, "rays_per_s": n / sec, "acc_share": share, "cpu_errs": errs}


def phase_static_frame(card, tr, white_bg, o, d, device):
    """A fresh 199^3 mask (K6d, 31 sweep chunks) and the masked 400^2 frame
    (K6, K3, K2 a chunk) on the field `static` trained and on a seeded blob
    field: 14 steps leave the trained field empty (no voxel over
    alphaMask_thres), so its frame tests the path, the blob's the values.
    The blob (STATIC_SHRINK_BLOB) is narrower along each axis by another
    share, so that StaticTrainer's event, the mask and then
    tensorf_vm.shrink to its box, crops it to a non-cubic grid; the shrunk
    field's frame is masked by the mask built before the shrink, in the box
    before it (the gap kept on purpose).  After the path, K6, K6d and K6b
    against their plain versions on the shrunk field."""
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    sweeps = -(-int(np.prod(STATIC_MASK_GRID)) // ALPHA_CHUNK)
    blob_meta, blob_params, _, cfg = static_bat("VM", device, widths=STATIC_SHRINK_BLOB)
    numbers = {}
    torch.cuda.synchronize()
    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    states = {}
    for name, (meta, params) in {"trained": (tr.meta, tr.params),
                                 "blob": (blob_meta, blob_params)}.items():
        t0 = time.perf_counter()
        state, new_aabb = tensorf_vm.update_alpha_mask(params, meta, STATIC_MASK_GRID,
                                                       device=device)
        torch.cuda.synchronize()
        mask_s = time.perf_counter() - t0
        occ = float(state["volume"].mean())
        states[name] = state, new_aabb
        print(f"[static_frame] {name} field ({meta.grid_size}, aabb {meta.aabb}): mask "
              f"{STATIC_MASK_GRID} in {mask_s:.3f} s, occupancy {occ:.4f}, proposed aabb "
              f"{np.round(new_aabb, 4).tolist()} [{card}]")
        frame = static_frame(f"static_frame.{name}", meta, params, white_bg, state, o, d, card,
                             device)
        numbers[name] = {"mask_s": mask_s, "occupancy": occ, **frame}
    blob_state, new_aabb = states["blob"]
    shrunk_params, shrunk_meta = tensorf_vm.shrink(blob_params, blob_meta, new_aabb)
    del blob_params
    print(f"[static_frame] shrunk blob field: grid {shrunk_meta.grid_size}, aabb "
          f"{shrunk_meta.aabb}, {shrunk_meta.n_samples} samples a ray; masked in the box "
          f"before the shrink {blob_meta.aabb} [{card}]")
    numbers["shrunk"] = {"grid": list(shrunk_meta.grid_size), "aabb": shrunk_meta.aabb,
                         **static_frame("static_frame.shrunk", shrunk_meta, shrunk_params,
                                        white_bg, blob_state, o, d, card, device)}
    launches = read_counts()
    # ------------------------------------------------------------------------
    want = {"plane_line_density_fwd": 2 * sweeps, "plane_line_fwd": 3 * n_chunks,
            "occupancy_trilinear_fwd": 3 * n_chunks, "composite_fwd": 3 * n_chunks}
    got = {k: v for k, v in launches.items() if v}
    require(got == want, f"static_frame: launches {got}, want {want}")
    blob, shrunk = numbers["blob"], numbers["shrunk"]
    require(0.01 <= blob["occupancy"] <= 0.9 and 0.02 <= blob["acc_share"] <= 0.95,
            f"static_frame: the blob field's mask {blob['occupancy']}, acc share "
            f"{blob['acc_share']}")
    gs = shrunk_meta.grid_size
    require(len(set(gs)) == 3 and max(gs) < max(blob_meta.grid_size),
            f"static_frame: the shrunk grid {gs} is not cropped to three sizes")
    require(shrunk["acc_share"] >= 0.5 * blob["acc_share"],
            f"static_frame: acc share {shrunk['acc_share']} after the shrink, "
            f"{blob['acc_share']} before")
    # the lookup's kernels on the shrunk, non-cubic field
    groups = static_groups(shrunk_params, shrunk_meta)
    hp = replace(trainer.TrainHP.from_cfg(cfg), n_rays=STATIC_TRAIN_RAYS)
    to, td, _ = static_train_rays(o, d, hp.n_rays, SEED + 31)
    train_xyz = static_coords(shrunk_meta, to, td, device, jitter_seed=SEED + 32)
    kernels_shrunk = {"grid": list(gs), "plane_line_fwd": k6_at(
        f"train step, shrunk grid {gs}", groups, train_xyz, False, yardsticks=False)}
    del train_xyz
    n_sweep = -(-int(np.prod(gs)) // ALPHA_CHUNK)
    sweep = grid_ordered_xyz(shrunk_meta, gs, n_sweep // 2, device)
    kernels_shrunk["plane_line_density_fwd"] = k6_at(
        f"grid-ordered sweep chunk {n_sweep // 2} of {n_sweep}, shrunk grid {gs}", groups, sweep,
        True, yardsticks=False)
    del sweep
    xyz, g_density, g_app = static_step_grad_inputs(shrunk_meta, shrunk_params, white_bg, hp,
                                                    device)
    kernels_shrunk["plane_line_bwd"] = k6b_at(f"train step, shrunk grid {gs}", groups, xyz,
                                              g_density, g_app, yardsticks=False)
    del xyz, g_density, g_app
    torch.cuda.empty_cache()
    return launches, numbers, kernels_shrunk


def phase_static_cp(card, o, d, device):
    """TensorCP at bat's widths through the CLI (STATIC_CP_SCHEDULE: an
    upsample to 199^3 after iteration 1, a mask and shrink at 2), then one
    unmasked 400^2 frame."""
    out, launches, recorder, numbers = run_static_cli("static_cp", "CP", STATIC_CP_SCHEDULE,
                                                      card, device)
    tr = out["trainer"]
    require(tr.meta.decomposition == "CP" and len(recorder.steps) == STATIC_CP_ITERS,
            f"static_cp: {tr.meta.decomposition}, {len(recorder.steps)} steps")
    require(launches["plane_line_density_fwd_cp"] > 0, "static_cp: no K6d.CP launch")
    before = read_counts()
    numbers["frame"] = static_frame("static_cp", tr.meta, tr.params,
                                    bool(tr.cfg.dataset.white_background), None, o, d, card,
                                    device)
    after = read_counts()
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    frame = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    require(frame == {"plane_line_fwd_cp": n_chunks, "composite_fwd": n_chunks},
            f"static_cp: frame launches {frame}")
    return {k: launches[k] + frame.get(k, 0) for k in launches}, numbers


def phase_static_learns(card, device):
    """StaticTrainer on the tiny scene and config of tests/test_static.py:
    psnr_0 must rise by more than 4 dB in 120 iterations, as there."""
    scene = make_synthetic_scene(n_train=6, n_val=1, n_test=1, H=32, W=32)
    tr = static.StaticTrainer(CfgNode(STATIC_LEARNS_CFG), scene, device=device)
    logs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # -- the main path: counts set to 0 just before, read just after --------
    reset_counts()
    tr.train(iters=LEARNS_ITERS, log_fn=logs.append)
    torch.cuda.synchronize()
    launches = read_counts()
    # ------------------------------------------------------------------------
    sec = time.perf_counter() - t0
    gain = logs[-1]["psnr_0"] - logs[0]["psnr_0"]
    print(f"[static_learns] psnr_0 by iteration: "
          f"{[(m['it'], round(m['psnr_0'], 2)) for m in logs]}; gain {gain:.2f} dB (limit > "
          f"{LEARNS_GAIN_DB}) in {LEARNS_ITERS} iterations, {sec:.2f} s [{card}]")
    require(all(np.isfinite(m["loss"]) for m in logs), "static_learns: a loss is not finite")
    require(gain > LEARNS_GAIN_DB, f"static_learns: PSNR rose by {gain:.2f} dB only")
    return launches, {"psnr_0": [(m["it"], m["psnr_0"]) for m in logs], "gain_dB": gain,
                      "seconds": sec}


def profile_call(tag, fn):
    """Device-time breakdown of one call of ``fn`` (torch.profiler), printed;
    returns {kernel name: (device ms, launches)}; its summary lands in
    ``LAST_PROFILE`` (empty where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    LAST_PROFILE.clear()
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
    timeline = []  # (phase, its start)

    def enter(name):
        timeline.append((name, time.perf_counter()))
        print(f"[chip_smoke] phase {name} from {timeline[-1][1] - t_start:.1f} s", flush=True)
        return name

    phase = enter("env")
    try:
        card = phase_env()
        phase = enter("build")
        phase_build()
        phase = enter("set-up")
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
        phase = enter("floor")
        floor = phase_floor(meta, device)
        phase = enter("K1")
        mid = IMAGE * IMAGE // 2  # the chunk of rays that phases K1 and profile use
        o_mid, d_mid = o.reshape(-1, 3)[mid:mid + CHUNK], d.reshape(-1, 3)[mid:mid + CHUNK]
        k1 = phase_k1(meta, params, o_mid, d_mid, device)
        phase = enter("K2")
        k2 = phase_k2(meta, white_bg, device)
        phase = enter("K1d")
        k1d = phase_k1d(meta, params, device)
        paths = {}
        phase = enter("render")
        paths["render"], unmasked = phase_render(meta, params, params_cpu, white_bg, card, o, d,
                                                 device)
        phase = enter("profile")
        phase_profile(meta, params, white_bg, o_mid, d_mid, device)
        phase = enter("alpha")
        paths["alpha"], alpha_state, new_aabb, alpha_sec = phase_alpha(meta, params, params_cpu,
                                                                       card, device)
        phase = enter("K3")
        k3 = phase_k3(meta, params, white_bg, alpha_state, new_aabb, o_mid, d_mid, device)
        phase = enter("K4")
        k4 = phase_k4(meta, alpha_state, new_aabb, device)
        phase = enter("split")
        paths["split"], masked, masked_secs = phase_split(
            meta, params, params_cpu, white_bg, card, pose, o, d, unmasked, alpha_state, device)
        phase = enter("split_sparse")
        paths["split_sparse"], picks, sparse = phase_split_sparse(
            meta, params, white_bg, card, pose, o, d, alpha_state, masked, masked_secs, device)
        del masked
        phase = enter("K5")
        paths["probe"], k5 = phase_k5(meta, picks, sparse, device)
        del picks
        phase = enter("K1b")
        k1b = phase_k1b(meta, params, white_bg, pose, unmasked, device)
        phase = enter("K2b")
        k2b = phase_k2b(meta, white_bg, device)
        phase = enter("K2.colourless")
        k2c, k2bc = phase_k2_colourless(meta, white_bg, device)
        phase = enter("train")
        paths["train"], hp, trained, data, train_numbers = phase_train(
            meta, params, white_bg, card, pose, o, d, unmasked, device)
        phase = enter("train_prune")
        paths["train_prune"], prune_numbers = phase_train_prune(meta, hp, trained, data,
                                                                alpha_state, card, device)
        phase = enter("train_turbo")
        paths["train_turbo"], turbo_numbers = phase_train_turbo(
            "train_turbo", meta, trained, data, hp, alpha_state, prune_numbers, card, pose,
            device, (KERNEL_CHUNK_GRAD_RTOL, KERNEL_CHUNK_GRAD_ATOL_REL),
            (CHUNK_GRAD_RTOL, CHUNK_GRAD_ATOL_REL), SEED + 18)
        del trained, data
        # multi-frame ray batches on a pool of 16 frames
        phase = enter("train_multi")
        paths["train_multi"], multi_numbers, multi = phase_train_multi(
            meta, params, white_bg, card, train_numbers, device)
        phase = enter("train_multi_turbo")
        paths["train_multi_turbo"], multi_turbo_numbers = phase_train_multi_turbo(
            meta, multi, alpha_state, card, turbo_numbers, device)
        del multi
        torch.cuda.empty_cache()
        # the bf16 compute mode, after every f32 phase
        phase = enter("K1.bf16")
        k1_bf16 = phase_k1_bf16(meta, params, o_mid, d_mid, device)
        phase = enter("K1d.bf16")
        k1d_bf16 = phase_k1d_bf16(meta, params, device)
        torch.cuda.empty_cache()
        phase = enter("render_bf16")
        paths["render_bf16"], _, render_bf16 = phase_render_bf16(
            meta, params, params_cpu, white_bg, card, o, d, unmasked,
            {t: unmasked[t]["rays_per_s"] for t in TIMES}, device)
        del params_cpu
        phase = enter("alpha_bf16")
        paths["alpha_bf16"], alpha_bf16_state, alpha_bf16 = phase_alpha_bf16(
            meta, params, white_bg, card, alpha_state, alpha_sec, o, d, unmasked, device)
        phase = enter("K1b.bf16")
        k1b_bf16 = phase_k1b_bf16(meta, params, white_bg, pose, unmasked, device)
        phase = enter("train_bf16")
        paths["train_bf16"], paths["train_prune_bf16"], train_bf16, trained = phase_train_bf16(
            meta, params, white_bg, card, pose, o, d, unmasked, alpha_bf16_state, device)
        phase = enter("train_turbo_bf16")
        trained, data, hp = trained
        paths["train_turbo_bf16"], turbo_bf16 = phase_train_turbo(
            "train_turbo_bf16", bf16_meta(meta), trained, data, hp, alpha_bf16_state,
            train_bf16["pruned"], card, pose, device,
            (BF16_KERNEL_CHUNK_GRAD_RTOL, BF16_KERNEL_CHUNK_GRAD_ATOL_REL),
            (BF16_CHUNK_GRAD_RTOL, BF16_CHUNK_GRAD_ATOL_REL), SEED + 19)
        del trained, data
        torch.cuda.empty_cache()
        # the Trainer stage loop through the port's training CLI
        phase = enter("trainer")
        paths["trainer"], paths["trainer_resume"], trainer_run = phase_trainer(card, o, d, device)
        phase = enter("trainer_bf16")
        paths["trainer_bf16"], trainer_bf16_run = phase_trainer_bf16(card, o, d, device)
        phase = enter("trainer_learns")
        paths["trainer_learns"], learns = phase_trainer_learns(card, device)
        # segmentation and motion transfer on the trainer's scenes
        phase = enter("segm_train")
        paths["segm_train"], segm_train, mask_path = phase_segm_train(
            card, trainer_run["logdir"], device)
        phase = enter("segm_render")
        paths["segm_render"], segm_render = phase_segm_render(card, trainer_run["logdir"],
                                                              mask_path, device)
        phase = enter("transfer")
        paths["transfer"], transfer = phase_transfer(card, trainer_run["logdir"],
                                                     trainer_bf16_run["logdir"], device)
        # the supervised multi-frame run and the scoring scripts
        phase = enter("supervise")
        supervise = phase_supervise(card, device)
        phase = enter("video")
        paths["video"], video = phase_video(card, trainer_run["logdir"], device)
        phase = enter("eval_all")
        paths["eval_all"], evaluated = phase_eval_all(card, trainer_run["logdir"], device)
        # the static TensoRF models: their kernels, the CLI, a full-width
        # step three ways, a masked frame, the CP arm and the tiny scene
        torch.cuda.empty_cache()
        phase = enter("K6")
        k6 = phase_static_kernels("VM", o, d, device)
        phase = enter("K6.CP")
        k6_cp = phase_static_kernels("CP", o, d, device)
        phase = enter("K6.narrow")
        k6_narrow = phase_static_narrow(device)
        phase = enter("static")
        paths["static"], static_tr, static_run = phase_static(card, device)
        phase = enter("static_step")
        paths["static_step"], static_step_run = phase_static_step(card, device)
        phase = enter("static_frame")
        paths["static_frame"], static_frame_run, k6_shrunk = phase_static_frame(
            card, static_tr, white_bg, o, d, device)
        del static_tr
        phase = enter("static_cp")
        paths["static_cp"], static_cp_run = phase_static_cp(card, o, d, device)
        phase = enter("static_learns")
        paths["static_learns"], static_learns_run = phase_static_learns(card, device)
    except Exception:
        traceback.print_exc()
        print(f"[chip_smoke] FAILED in phase {phase}", file=sys.stderr)
        sys.exit(1)
    t_end = time.perf_counter()
    # K1d at the segmentation and transfer paths' own inputs (the trainer scene)
    k1d["segm_occupancy_query"] = segm_train["occupancy_query"].pop("k1d")
    k1d["transfer_mask_chunk"] = segm_render["transfer_mask_chunk"].pop("k1d")
    # K1 and K1b alone on a multi-frame train chunk and a single-frame one
    for name, alone in multi_numbers.pop("kernels_alone").items():
        k1[f"train_{name}"], k1b[f"train_{name}"] = alone["k1"], alone["k1b"]
    # K6, K6d and K6b on the shrunk, non-cubic field and on their one-channel arm
    for entry in k6 + k6_cp:
        if entry["name"] in k6_shrunk:
            entry["shrunk_train_step" if entry["name"] != "plane_line_density_fwd"
                  else "shrunk_sweep_chunk"] = k6_shrunk[entry["name"]]
        entry["narrow"] = {case: numbers for case, numbers in k6_narrow.items()
                           if case.startswith("CP") == entry["name"].endswith("_cp")}
    entries = [k1, k1b, k1d, k2, k2b, k3, k4, k5, k1_bf16, k1b_bf16, k1d_bf16, k2c, k2bc, *k6,
               *k6_cp]
    for entry in entries:
        entry["launches_by_path"] = {name: counts[entry["name"]] for name, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["launches"] == 0:
            print(f"[chip_smoke] FAILED: {entry['name']} was launched on no main path",
                  file=sys.stderr)
            sys.exit(1)
    print(f"[chip_smoke] train step: {json.dumps(train_numbers)}")
    print(f"[chip_smoke] turbo: {json.dumps({'split_sparse': sparse, 'train_prune': prune_numbers, 'train_turbo': turbo_numbers, 'train_turbo_bf16': turbo_bf16})}")
    print(f"[chip_smoke] bf16: {json.dumps({'render': render_bf16, 'alpha': alpha_bf16, 'train': train_bf16})}")
    print(f"[chip_smoke] trainer: {json.dumps({'f32': trainer_run, 'bf16': trainer_bf16_run, 'learns': learns}, default=str)}")
    print(f"[chip_smoke] segmentation: {json.dumps({'segm_train': segm_train, 'segm_render': segm_render, 'transfer': transfer}, default=str)}")
    print(f"[chip_smoke] multi-frame: {json.dumps({'train_multi': multi_numbers, 'train_multi_turbo': multi_turbo_numbers, 'supervise': supervise}, default=str)}")
    print(f"[chip_smoke] scoring: {json.dumps({'video': video, 'eval_all': evaluated}, default=str)}")
    print(f"[chip_smoke] static: {json.dumps({'static': static_run, 'static_step': static_step_run, 'static_frame': static_frame_run, 'static_cp': static_cp_run, 'static_learns': static_learns_run}, default=str)}")
    floor["grids"] = {f"{b}x{t}": ms for (b, t), ms in sorted(FLOOR_MS.items())}
    print(f"[chip_smoke] floor: {json.dumps(floor)}")
    ends = [t for _, t in timeline[1:]] + [t_end]
    print(f"[chip_smoke] seconds by phase: "
          f"{json.dumps({name: round(e - t, 1) for (name, t), e in zip(timeline, ends)})}")
    print(f"[chip_smoke] all phases passed in {t_end - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Chip smoke test of the nvfi_torch port on one NVIDIA card (H100, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  env     the card's name and power limit, torch and CUDA versions; TF32 off
  build   compile nvfi_torch/csrc/*.cu with nvcc for sm_90a (one nvcc per
          source, all started together) and print the ptxas report
  K1      plane_product kernel vs plane_product_reference at the main-path
          shape of the bat model (199^3 grid, K=16, 72 channels, 4096*686
          samples); kernel, plain and library (F.grid_sample) times
  K2      composite kernel vs composite_reference at (4096, 686)
  render  the full-width bat model (configs/synth/bat.yaml, random seeded
          weights plus a seeded density blob) rendered 400x400 through
          render_image at t = 0.4 (keyframe), 0.425 (between keyframes) and
          0.9 (past tmax, 11 RK2 steps); launch counts, acc and weight
          checks, one 256-ray chunk per time against the port on the CPU,
          and a torch.profiler breakdown of one chunk
The last three lines are the card line from nvidia-smi, the kernels JSON line
and the result line {"ok": true, "device": {...}}.

The numbers it prints are this card's, at its power limit; bounds use the
H100 SXM data-sheet peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 without tensor
cores).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nvfi_torch.config import load_config
from nvfi_torch.fields import kplane
from nvfi_torch.ops import compositing, grid_sample, kernels
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
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
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")


def phase_k1(meta, params, device):
    """K1 at the main-path shape: the planes of the render, P = 4096 * 686."""
    P = CHUNK * meta.n_samples
    rng = np.random.RandomState(SEED + 1)
    xyzt = torch.tensor(rng.uniform(-1.1, 1.1, (P, 4)).astype(np.float32), device=device)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    got = grid_sample.plane_product(ps, pt, xyzt, cd)
    want = grid_sample.plane_product_reference(ps, pt, xyzt, cd)
    torch.cuda.synchronize()
    check_close("K1 plane_product", got, want, rtol=1e-5, atol_rel=1e-5)  # FMA contraction
    err = max_err(got, want)
    del want

    ms = time_ms(lambda: grid_sample.plane_product(ps, pt, xyzt, cd))
    plain_ms = time_ms(lambda: grid_sample.plane_product_reference(ps, pt, xyzt, cd))
    # library yardstick (never called by the port): six F.grid_sample on
    # (1, C, H, W) planes, the product chain and the density sum
    planes_nchw = [p.permute(2, 0, 1)[None].contiguous() for p in list(ps) + list(pt)]
    pairs = list(grid_sample.MAT_SPACE) + list(grid_sample.MAT_TIME)
    grids = [torch.stack([xyzt[:, a], xyzt[:, b]], -1).view(1, P, 1, 2) for a, b in pairs]

    def library():
        s = [F.grid_sample(p, g, align_corners=True, padding_mode="zeros")[0, :, :, 0]
             for p, g in zip(planes_nchw, grids)]
        f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5])
        return f[:cd].sum(0), f[cd:]

    library_ms = time_ms(library)
    del planes_nchw, grids
    C = ps[0].shape[-1]
    n_bytes = sum(p.numel() * 4 for p in list(ps) + list(pt)) + P * 16 + P * 4 + P * (C - cd) * 4
    n_ops = P * (6 * 7 * C + 5 * C + cd + 6 * 20)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"[K1] P={P} C={C} max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} GFLOP)")
    return {"name": "plane_product_fwd", "route": "cuda",
            "source": "nvfi_torch/csrc/plane_product.cu",
            "replaces": "nvfi_tpu/fields/kplane.py:444", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


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


def adv_steps_for(meta, t):
    """render_image's bucket: one RK2 step, or the full render bound."""
    return 1 if kplane.render_steps_for_time(meta, t) == 1 else meta.render_adv_steps


def phase_render(meta, params, white_bg, card, device):
    pose = look_at(4.0, 0.6, 0.35)
    o, d = rays.ray_bundle(pose, IMAGE, IMAGE, FOCAL)
    n_chunks = -(-IMAGE * IMAGE // CHUNK)
    # warm-up (cuBLAS handles, allocator) outside the counted main path
    kplane.render_rays(params, meta, TIMES[0], o.reshape(-1, 3)[:CHUNK],
                       d.reshape(-1, 3)[:CHUNK], white_bg=white_bg, adv_steps=1, device=device)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after --------
    grid_sample.plane_product.launches = 0
    compositing.composite.launches = 0
    images, per_image = {}, []
    for t in TIMES:
        k1, k2 = grid_sample.plane_product.launches, compositing.composite.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images[t] = render_image(params, meta, t, o, d, white_bg=white_bg, chunk=CHUNK,
                                 device=device)
        sec = time.perf_counter() - t0
        per_image.append((t, sec, grid_sample.plane_product.launches - k1,
                          compositing.composite.launches - k2,
                          torch.cuda.max_memory_allocated() / 2**30))
    launches = {"plane_product_fwd": grid_sample.plane_product.launches,
                "composite_fwd": compositing.composite.launches}
    # ------------------------------------------------------------------------

    for (t, sec, n1, n2, mem), img in zip(per_image, images.values()):
        share = float((img["acc"] > 0.5).mean())
        print(f"[render] t={t}: {IMAGE}x{IMAGE} in {sec:.3f} s = {IMAGE * IMAGE / sec:.0f} rays/s "
              f"({adv_steps_for(meta, t)} RK2 steps, {n1} K1 / {n2} K2 launches, peak "
              f"{mem:.2f} GiB) acc>0.5 share {share:.4f}, mean rgb "
              f"{float(img['rgb'].mean()):.4f} [{card}]")
        for k, v in img.items():
            require(np.isfinite(v).all(), f"t={t}: non-finite {k}")
        require(0.05 <= share <= 0.95, f"t={t}: share of rays with acc > 0.5 is {share}")
        require(n1 == n_chunks and n2 == n_chunks,
                f"t={t}: launches K1 {n1}, K2 {n2}, want {n_chunks} each")
    require(not np.allclose(images[TIMES[0]]["rgb"], images[TIMES[2]]["rgb"]),
            "renders at different times are identical")

    # one 256-ray chunk per time against the port on the CPU
    params_cpu = kplane.map_params(lambda x: x.cpu(), params)
    stride = IMAGE * IMAGE // 256
    idx = np.arange(256) * stride + stride // 2  # spread over the image
    co, cd = o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx]
    for t in TIMES:
        steps = adv_steps_for(meta, t)
        gpu = kplane.render_rays(params, meta, t, co, cd, white_bg=white_bg, adv_steps=steps,
                                 device=device)
        t0 = time.perf_counter()
        cpu = kplane.render_rays(params_cpu, meta, t, co, cd, white_bg=white_bg,
                                 adv_steps=steps, device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu = {k: v.cpu() for k, v in gpu.items()}
        errs = {k: float((gpu[k] - cpu[k]).abs().max()) for k in ("rgb", "acc", "depth")}
        above = float((cpu["weight"] > meta.raymarch_weight_thres).float().mean())
        print(f"[render] t={t}: 256-ray chunk card vs CPU max err {errs}, share of samples "
              f"above rayMarch_weight_thres {above:.4f} (CPU chunk {cpu_s:.1f} s)")
        require(errs["rgb"] <= 1e-4 and errs["acc"] <= 1e-4, f"t={t}: card vs CPU {errs}")
        require(bool(((gpu["depth"] - cpu["depth"]).abs()
                      <= 1e-4 * cpu["depth"].abs()).all()), f"t={t}: depth rtol 1e-4")
        require(above >= 1e-3, f"t={t}: share of samples above threshold {above}")
        acc_img = images[t]["acc"].reshape(-1)[idx]
        require(np.abs(acc_img - gpu["acc"].numpy()).max() <= 1e-4,
                f"t={t}: the chunk disagrees with the image")
    return launches


def phase_profile(meta, params, white_bg, o, d, device):
    """Device-time breakdown of one chunk per step bucket (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for t in (TIMES[0], TIMES[2]):
        steps = adv_steps_for(meta, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            kplane.render_rays(params, meta, t, o, d, white_bg=white_bg, adv_steps=steps,
                               device=device)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernel_rows = torch.autograd.DeviceType.CUDA  # kernels, not the ops that launch them
        rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == kernel_rows]
        busy_ms = sum(_device_us(e) for e in rows) / 1e3
        if busy_ms == 0:
            print(f"[profile] t={t}: the profiler saw no device time: not measured")
            continue
        print(f"[profile] t={t} ({steps} steps): chunk wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms (idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, traced)")
        for e in sorted(rows, key=lambda e: -_device_us(e))[:10]:
            print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  "
                  f"{e.key[:90]}")


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
        print(f"[set-up] bat: grid {meta.grid_size}, K={meta.num_keyframes}, "
              f"C={meta.density_n_comp}+{meta.app_n_comp}, app_dim {meta.app_dim}, "
              f"n_samples {meta.n_samples}, render_adv_steps {meta.render_adv_steps}, "
              f"vel {meta.vel_hidden} wide, shader {meta.shading_mode} {meta.feature_c} wide")
        phase = "K1"
        k1 = phase_k1(meta, params, device)
        phase = "K2"
        k2 = phase_k2(meta, white_bg, device)
        torch.cuda.empty_cache()
        phase = "render"
        launches = phase_render(meta, params, white_bg, card, device)
        phase = "profile"
        o, d = rays.ray_bundle(look_at(4.0, 0.6, 0.35), IMAGE, IMAGE, FOCAL)
        mid = IMAGE * IMAGE // 2
        phase_profile(meta, params, white_bg, o.reshape(-1, 3)[mid:mid + CHUNK],
                      d.reshape(-1, 3)[mid:mid + CHUNK], device)
    except Exception:
        traceback.print_exc()
        print(f"[chip_smoke] FAILED in phase {phase}", file=sys.stderr)
        sys.exit(1)
    k1["launches"], k2["launches"] = launches["plane_product_fwd"], launches["composite_fwd"]
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

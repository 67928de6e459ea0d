"""Turbo-mode budget calibration (host-side numpy, no kernel launches).

Port of ``nvfi_tpu/train/turbo.py:1-190``, kept as a copy of its own: the
JAX package's ``train`` package imports jax.  Turbo training
(``train_occupancy_prune`` + the block-sparse sample axis of
``fields/kplane.render_rays``) is exact as long as no ACTIVE sample-block is
dropped by the static ``block_budget``.  The right budget depends on the
alpha mask's occupancy, the aabb and the ray geometry, so this module
replays the training step's sampling (box entry, stratified jitter, the
dilated occupancy test, the ``meta.sample_block``-sized tiling) in numpy on
probe batches and returns a budget with a safety margin.  The per-step
``dropped_blocks`` / ``dropped_shade`` counts of ``render_rays`` stay the
runtime certificates.

Given the same inputs and seed every function returns the JAX package's
numbers exactly (the same numpy calls in the same order).  An alpha state
may hold torch tensors (on any device): they are read to the host once.
"""

from __future__ import annotations

import numpy as np
import torch


def trilinear_np(volume: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Numpy trilinear lookup with torch's align_corners=True and zeros
    padding: volume (D,H,W), coords (...,3) normalized (x,y,z) with x
    indexing W, y indexing H, z indexing D."""
    D, H, W = volume.shape

    def cw(u, size):
        x = (u + 1.0) * 0.5 * (size - 1)
        x0 = np.floor(x)
        w1 = x - x0
        i0 = x0.astype(np.int64)
        i1 = i0 + 1
        v0 = (i0 >= 0) & (i0 <= size - 1)
        v1 = (i1 >= 0) & (i1 <= size - 1)
        return (
            (np.clip(i0, 0, size - 1), np.clip(i1, 0, size - 1)),
            (1.0 - w1, w1),
            (v0, v1),
        )

    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    (ix0, ix1), (wx0, wx1), (vx0, vx1) = cw(x, W)
    (iy0, iy1), (wy0, wy1), (vy0, vy1) = cw(y, H)
    (iz0, iz1), (wz0, wz1), (vz0, vz1) = cw(z, D)
    flat = volume.reshape(-1)

    def corner(iz, iy, ix, wz, wy, wx, vz, vy, vx):
        w = wz * wy * wx * (vz & vy & vx)
        return flat[(iz * H + iy) * W + ix] * w

    return (
        corner(iz0, iy0, ix0, wz0, wy0, wx0, vz0, vy0, vx0)
        + corner(iz0, iy0, ix1, wz0, wy0, wx1, vz0, vy0, vx1)
        + corner(iz0, iy1, ix0, wz0, wy1, wx0, vz0, vy1, vx0)
        + corner(iz0, iy1, ix1, wz0, wy1, wx1, vz0, vy1, vx1)
        + corner(iz1, iy0, ix0, wz1, wy0, wx0, vz1, vy0, vx0)
        + corner(iz1, iy0, ix1, wz1, wy0, wx1, vz1, vy0, vx1)
        + corner(iz1, iy1, ix0, wz1, wy1, wx0, vz1, vy1, vx0)
        + corner(iz1, iy1, ix1, wz1, wy1, wx1, vz1, vy1, vx1)
    )


def dilated_occupied_np(volume: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Numpy replica of ``kplane.sample_occupied``'s dilated nearest test:
    volume (D,H,W) binary, coords (...,3) normalized (x,y,z)."""
    D, H, W = volume.shape
    dil = np.asarray(volume, dtype=np.float64)
    for ax, n in ((0, D), (1, H), (2, W)):
        idx = np.minimum(np.arange(n) + 1, n - 1)
        dil = np.maximum(dil, np.take(dil, idx, axis=ax))
    sizes = np.array([W, H, D], np.float64)
    pix = (coords + 1.0) * 0.5 * (sizes - 1.0)
    in_range = np.all((pix > -1.0) & (pix < sizes), axis=-1)
    i = np.clip(np.floor(pix).astype(np.int64), 0,
                [max(W - 2, 0), max(H - 2, 0), max(D - 2, 0)])
    flat = dil.reshape(-1)
    v = flat[(i[..., 2] * H + i[..., 1]) * W + i[..., 0]]
    return (v > 0) & in_range


def active_block_fraction(
    meta, alpha_volume: np.ndarray, alpha_aabb: np.ndarray, pose: np.ndarray,
    H: int, W: int, focal: float, n_rays: int, rng: np.random.RandomState,
    SB: int = 64,
):
    """One probe batch; returns (active-block fraction, max per-ray occupied
    samples).  The block criterion is ``kplane.render_rays``' block-sparse
    selection (the dilated occupancy test in the alpha volume's own aabb);
    the per-ray occupied count bounds the per-ray above-threshold shade
    samples, since weight > thres needs alpha > 0 at the sample, so a shade
    top-K of at least that count truncates nothing (dropped_shade == 0)."""
    a = meta.aabb_np.astype(np.float64)
    pix = rng.randint(0, H * W, size=n_rays)
    ii, jj = pix // W, pix % W
    x = (jj.astype(np.float64) - W * 0.5) / focal
    y = -(ii.astype(np.float64) - H * 0.5) / focal
    dirs = np.stack([x, y, -np.ones_like(x)], axis=-1)
    pose = np.asarray(pose, dtype=np.float64)
    ray_d = dirs @ pose[:3, :3].T
    ray_o = np.broadcast_to(pose[:3, 3], ray_d.shape)

    near, far = meta.near_far
    if meta.parity_sampling:
        inside_any = bool(np.any((ray_o >= a[0]) & (ray_o <= a[1])))
    else:
        inside_any = bool(np.any(np.all((ray_o >= a[0]) & (ray_o <= a[1]), axis=-1)))
    vec = np.where(ray_d == 0, 1e-6, ray_d)
    rate_a = (a[1] - ray_o) / vec
    rate_b = (a[0] - ray_o) / vec
    t_min = np.clip(np.max(np.minimum(rate_a, rate_b), axis=-1), near, far)
    if inside_any:
        t_min = np.full_like(t_min, near)

    n_samples = meta.n_samples
    ns_pad = -(-n_samples // SB) * SB
    rng_steps = np.arange(ns_pad, dtype=np.float64)[None, :]
    rng_steps = rng_steps + rng.rand(n_rays, 1)  # per-ray stratified jitter
    z_vals = t_min[:, None] + rng_steps * meta.step_size
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z_vals[..., None]
    valid = np.all((pts >= a[0]) & (pts <= a[1]), axis=-1)
    valid &= (np.arange(ns_pad) < n_samples)[None, :]

    aa = np.asarray(alpha_aabb, dtype=np.float64)
    xyz_norm = (pts - aa[0]) * (2.0 / (aa[1] - aa[0])) - 1.0
    occ = dilated_occupied_np(np.asarray(alpha_volume, dtype=np.float64), xyz_norm)
    valid &= occ

    nb = ns_pad // SB
    active = valid.reshape(n_rays * nb, SB).any(axis=-1)
    return float(active.mean()), int(valid.sum(axis=-1).max())


def _host(x) -> np.ndarray:
    """An array of the alpha state on the host (a tensor is read back)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def measure_block_budget(
    meta, alpha_state, poses, H: int, W: int, focal: float, n_rays: int,
    seed: int = 0, n_batches: int = 12, margin: float = 1.3, floor: float = 0.02,
    with_shade: bool = False,
):
    """Safe per-stage budgets from probe batches.

    Returns the block budget (max probe-batch active-block fraction x margin;
    1.0 = dense if sparsity would not save work), and with ``with_shade=True``
    a tuple ``(block_budget, shade_fraction)`` where the shade fraction covers
    the max per-ray occupied sample count with margin: a bound on the per-ray
    above-threshold samples, so the per-ray shade top-K at this fraction
    truncates nothing.  The per-step ``dropped_blocks`` / ``dropped_shade``
    counts remain the runtime certificates.
    """
    rng = np.random.RandomState(seed)
    poses = _host(poses)
    vol = _host(alpha_state["volume"])
    aabb = _host(alpha_state["aabb"])
    frac = 0.0
    max_occ = 0
    for b in range(n_batches):
        pose = poses[rng.randint(len(poses))]
        f, mo = active_block_fraction(meta, vol, aabb, pose, H, W, focal,
                                      n_rays, rng,
                                      SB=getattr(meta, "sample_block", 64))
        frac = max(frac, f)
        max_occ = max(max_occ, mo)
    budget = min(1.0, max(frac * margin + floor, 0.05))
    budget = budget if budget < 0.9 else 1.0
    if not with_shade:
        return budget
    n_s = max(meta.n_samples, 1)
    shade = min(1.0, max((max_occ * margin + 8.0) / n_s, 16.0 / n_s))
    return budget, shade


def shade_cap_policy(probed: float, cap: float, follow_probe: bool) -> float:
    """The per-stage shade fraction from the probe and the config's cap.

    Default (``follow_probe=False``): the probed bound capped at the config's
    ``shade_fraction``; the ``dropped_shade`` running max counts whatever the
    cap truncates.  With ``follow_probe=True`` the probed bound is used even
    above the cap: no shade truncation (the probe covers every
    above-threshold sample with margin), at the cost of near-dense shading.
    """
    probed = float(probed)
    return probed if follow_probe else min(probed, float(cap))

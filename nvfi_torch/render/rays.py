"""Camera / ray-bundle math (numpy, host side).

The port's own copy of ``nvfi_tpu/render/rays.py``: pinhole ray generation in
the OpenGL convention (camera looks down -z, +y up), uniform random pixel
sampling and the flattened multi-frame ray buffer.  Rays are made on the host
with numpy and moved to the device per chunk by the renderer.  NDC rays
(``ndc_rays``) come with the NDC sampling of ROADMAP.md A3 and are refused.
"""

from __future__ import annotations

import numpy as np


def _refuse_ndc(ndc: bool):
    if ndc:
        raise NotImplementedError("NDC rays are not ported yet (ROADMAP.md A3)")


def ray_bundle(pose: np.ndarray, H: int, W: int, focal: float, ndc: bool = False):
    """Full-image ray bundle.

    Args:
      pose: (4,4) or (3,4) camera-to-world matrix.
    Returns:
      origins (H,W,3), directions (H,W,3) — directions are NOT normalized
      (z-depth parameterization of samples).
    """
    _refuse_ndc(ndc)
    pose = np.asarray(pose, dtype=np.float32)
    X, Y = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(X - W * 0.5) / focal, -(Y - H * 0.5) / focal, -np.ones_like(X)], axis=-1
    )
    ray_d = np.sum(dirs[..., None, :] * pose[:3, :3], axis=-1)
    ray_o = np.broadcast_to(pose[:3, -1], ray_d.shape).copy()
    return ray_o, ray_d


def sample_pixels(rng: np.random.Generator, H: int, W: int, n: int):
    """``n`` distinct pixels, uniformly: (rows, columns)."""
    idx = rng.choice(H * W, size=n, replace=False)
    return idx // W, idx % W


class Camera:
    """Host-side camera: the precomputed full-image ray bundle and a pixel
    sampler."""

    def __init__(self, pose, H, W, focal, target=None, near=1.0, far=8.0, ndc=False):
        self.pose = np.asarray(pose, dtype=np.float32)
        self.H, self.W, self.focal = int(H), int(W), float(focal)
        self.near, self.far = float(near), float(far)
        self.target = None if target is None else np.asarray(target, dtype=np.float32)
        self.rays_o, self.rays_d = ray_bundle(self.pose, self.H, self.W, self.focal, ndc)

    def sample_rays(self, rng: np.random.Generator, n: int):
        """``n`` rays at distinct pixels: origins, directions and the target
        pixels (None without a target)."""
        ii, jj = sample_pixels(rng, self.H, self.W, n)
        o = self.rays_o[ii, jj]
        d = self.rays_d[ii, jj]
        px = None if self.target is None else self.target[ii, jj]
        return o, d, px


def batched_rays(all_targets, all_poses, all_times, H, W, focal, ndc=False):
    """Every training frame flattened into one epoch buffer.

    Returns rays_o (M,3), rays_d (M,3), pixels (M,3), times (M,), M the frames
    times H x W, frame after frame.
    """
    _refuse_ndc(ndc)
    os_, ds_, px_, ts_ = [], [], [], []
    for target, pose, t in zip(all_targets, all_poses, all_times):
        o, d = ray_bundle(pose, H, W, focal)
        os_.append(o.reshape(-1, 3))
        ds_.append(d.reshape(-1, 3))
        px_.append(np.asarray(target, dtype=np.float32).reshape(-1, 3))
        ts_.append(np.full((o.shape[0] * o.shape[1],), t, dtype=np.float32))
    return (
        np.concatenate(os_),
        np.concatenate(ds_),
        np.concatenate(px_),
        np.concatenate(ts_),
    )

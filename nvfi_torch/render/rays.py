"""Camera / ray-bundle math (numpy, host side).

The port's own copy of ``nvfi_tpu/render/rays.py``: pinhole ray generation in
the OpenGL convention (camera looks down -z, +y up), the NDC projection
(``ndc_rays``, on numpy arrays or, for the training step, torch tensors),
uniform random pixel sampling and the flattened multi-frame ray buffer.  Rays
are made on the host with numpy and moved to the device per chunk by the
renderer.
"""

from __future__ import annotations

import numpy as np


def ray_bundle(pose: np.ndarray, H: int, W: int, focal: float, ndc: bool = False,
               near: float = 1.0):
    """Full-image ray bundle (``ndc``: projected into NDC with the near plane
    ``near``).

    Args:
      pose: (4,4) or (3,4) camera-to-world matrix.
    Returns:
      origins (H,W,3), directions (H,W,3) — directions are NOT normalized
      (z-depth parameterization of samples).
    """
    pose = np.asarray(pose, dtype=np.float32)
    X, Y = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(X - W * 0.5) / focal, -(Y - H * 0.5) / focal, -np.ones_like(X)], axis=-1
    )
    ray_d = np.sum(dirs[..., None, :] * pose[:3, :3], axis=-1)
    ray_o = np.broadcast_to(pose[:3, -1], ray_d.shape).copy()
    if ndc:
        ray_o, ray_d = ndc_rays(H, W, focal, near, ray_o, ray_d)
    return ray_o, ray_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d, xp=np):
    """Shift the rays to the near plane and project them into NDC.

    ``xp``: the array namespace, ``np`` for host bundles or ``torch`` for the
    training step's rays on the device (JAX's ``xp=jnp``)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return xp.stack([o0, o1, o2], -1), xp.stack([d0, d1, d2], -1)


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
        self.rays_o, self.rays_d = ray_bundle(self.pose, self.H, self.W, self.focal, ndc, near)

    def sample_rays(self, rng: np.random.Generator, n: int):
        """``n`` rays at distinct pixels: origins, directions and the target
        pixels (None without a target)."""
        ii, jj = sample_pixels(rng, self.H, self.W, n)
        o = self.rays_o[ii, jj]
        d = self.rays_d[ii, jj]
        px = None if self.target is None else self.target[ii, jj]
        return o, d, px


def batched_rays(all_targets, all_poses, all_times, H, W, focal, ndc=False, near=1.0):
    """Every training frame flattened into one epoch buffer (``ndc``: its rays
    projected into NDC with the near plane ``near``).

    Returns rays_o (M,3), rays_d (M,3), pixels (M,3), times (M,), M the frames
    times H x W, frame after frame.
    """
    os_, ds_, px_, ts_ = [], [], [], []
    for target, pose, t in zip(all_targets, all_poses, all_times):
        o, d = ray_bundle(pose, H, W, focal, ndc, near)
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

"""Camera / ray-bundle math (numpy, host side).

The port's own copy of ``nvfi_tpu/render/rays.py:17-38`` (``ray_bundle``) and
its ``Camera``: pinhole ray generation in the OpenGL convention (camera looks
down -z, +y up).  Rays are made on the host with numpy and moved to the device
per chunk by the renderer.
"""

from __future__ import annotations

import numpy as np


def ray_bundle(pose: np.ndarray, H: int, W: int, focal: float, ndc: bool = False):
    """Full-image ray bundle.

    Args:
      pose: (4,4) or (3,4) camera-to-world matrix.
    Returns:
      origins (H,W,3), directions (H,W,3) — directions are NOT normalized
      (z-depth parameterization of samples).
    """
    if ndc:
        raise NotImplementedError("NDC rays are not ported yet (ROADMAP.md A1)")
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


class Camera:
    """Host-side camera: precomputed full-image ray bundle."""

    def __init__(self, pose, H, W, focal, target=None, near=1.0, far=8.0, ndc=False):
        self.pose = np.asarray(pose, dtype=np.float32)
        self.H, self.W, self.focal = int(H), int(W), float(focal)
        self.near, self.far = float(near), float(far)
        self.target = None if target is None else np.asarray(target, dtype=np.float32)
        self.rays_o, self.rays_d = ray_bundle(self.pose, self.H, self.W, self.focal, ndc)

"""Ray and pixel samplers (host side).

The port's own copy of ``nvfi_tpu/data/sampler.py:14-67``: numpy on the host
with the same ``np.random.default_rng(seed)``, so the ids, probabilities and
poses are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

from .blender import _spherical_pose


class SimpleSampler:
    """Batches from a shuffled permutation, reshuffled when a batch would run
    past its end."""

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = total
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.curr = total
        self.ids = None

    def nextids(self) -> np.ndarray:
        self.curr += self.batch
        if self.ids is None or self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr : self.curr + self.batch]


class RayImportanceSampler:
    """Importance sampling of pixels: each pixel weighted by its squared
    deviation from the per-pixel median over the images, drawn with
    replacement."""

    def __init__(self, all_rgbs: np.ndarray, batch: int, n_images: int, alpha: float = 0.1,
                 seed: int = 0):
        # all_rgbs: (n_images, H*W, 3)
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        rgbs = all_rgbs.reshape(n_images, -1, 3)
        median = np.median(rgbs, axis=0, keepdims=True)
        diff = np.square(rgbs - median).mean(-1)
        weights = diff / (diff + alpha**2)
        self.probs = (weights / weights.sum(axis=None)).reshape(-1)
        self.total = self.probs.shape[0]

    def nextids(self) -> np.ndarray:
        return self.rng.choice(self.total, size=self.batch, replace=True, p=self.probs)


class PatchSampler:
    """Random look-at poses on a sphere (``blender._spherical_pose``)."""

    def __init__(self, radius_range=(3.5, 4.5), phi_range=(-45.0, -15.0), seed: int = 0):
        self.radius_range = radius_range
        self.phi_range = phi_range
        self.rng = np.random.default_rng(seed)

    def next_pose(self) -> np.ndarray:
        theta = self.rng.uniform(-180.0, 180.0)
        phi = self.rng.uniform(*self.phi_range)
        radius = self.rng.uniform(*self.radius_range)
        return _spherical_pose(theta, phi, radius)

"""Visualization helpers (the port's own copy of what ``eval/harness.py``
needs from ``nvfi_tpu/utils/viz.py:35-55``): the depth colormap.  The
segmentation colorizer and the point-cloud export wait for the segmentation
slice (ROADMAP.md A8)."""

from __future__ import annotations

import numpy as np


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) jet-like colormap."""
    x = np.clip(np.nan_to_num(x), 0, 1)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def visualize_depth(depth: np.ndarray, minmax=None):
    """Depth map -> (rgb (H,W,3) float, (mi, ma))."""
    x = np.nan_to_num(np.asarray(depth, np.float64))
    if minmax is None:
        pos = x[x > 0]
        mi = float(pos.min()) if pos.size else 0.0
        ma = float(x.max())
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    return jet_colormap(x), (mi, ma)

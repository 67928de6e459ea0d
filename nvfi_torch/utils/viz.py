"""Visualization helpers (the port's own copy of ``nvfi_tpu/utils/viz.py``):
the depth colormap, the segmentation colorizer and the ASCII PLY point-cloud
export."""

from __future__ import annotations

import numpy as np

# distinct color table for instance masks (index 0 = background gray)
_SEGM_COLORS = np.array(
    [
        [0.7, 0.7, 0.7],
        [0.9, 0.1, 0.1],
        [0.1, 0.5, 0.9],
        [0.1, 0.8, 0.2],
        [0.95, 0.7, 0.1],
        [0.7, 0.2, 0.8],
        [0.1, 0.8, 0.8],
        [0.9, 0.4, 0.6],
        [0.5, 0.4, 0.1],
        [0.3, 0.3, 0.9],
    ],
    dtype=np.float32,
)


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


def build_segm_vis(segm: np.ndarray, with_background: bool = False) -> np.ndarray:
    """Instance-id map -> RGB visualization (reference's build_segm_vis)."""
    ids = np.asarray(segm, np.int64)
    table = _SEGM_COLORS
    if not with_background:
        table = np.roll(table, -1, axis=0)
    return table[ids % len(table)]


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write a point cloud as ASCII PLY (open3d-free)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_c = colors is not None
    if has_c:
        colors = (np.clip(np.asarray(colors).reshape(-1, 3), 0, 1) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]} {points[i,1]} {points[i,2]}"
            if has_c:
                row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
            f.write(row + "\n")

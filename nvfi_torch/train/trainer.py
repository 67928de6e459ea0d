"""Training helpers (port of ``nvfi_tpu/train/trainer.py``).

Only the grid-resolution helper is ported so far; the train step and the
stage loop are ROADMAP.md A4-A5.
"""

from __future__ import annotations

import numpy as np


def n_to_reso(n_voxels: int, aabb: np.ndarray) -> list:
    """Voxel count -> per-axis resolution.  The float floor matters: 8e6
    voxels in [-2, 2]^3 give 199, not 200, per axis."""
    xyz_min, xyz_max = np.asarray(aabb, dtype=np.float64)
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1 / 3)
    return [int(v) for v in ((xyz_max - xyz_min) / voxel_size)]

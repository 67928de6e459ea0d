"""The launch counters of the port's kernel wrappers, by kernel name.

Each wrapper adds one to its counter where it launches its kernel, and
nowhere else (a CPU tensor runs the plain version and counts nothing).
``COUNTERS`` maps a kernel's name to (wrapper, attribute); the bf16 arms of
K1, K1d and K1b and the colourless arms of K2 and K2b count apart.
``parallel.launch`` reads them in every rank, so a run over several
processes reports each rank's launches.
"""

from __future__ import annotations

from . import compositing, gather, grid_sample, occupancy, plane_line

COUNTERS = {
    "plane_product_fwd": (grid_sample.plane_product, "launches"),
    "plane_product_density_fwd": (grid_sample.plane_product_density, "launches"),
    "plane_product_density_raw_fwd": (grid_sample.plane_product_density_raw, "launches"),
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
    "plane_product_density_raw_fwd_bf16": (grid_sample.plane_product_density_raw,
                                           "launches_bf16"),
    "plane_product_bwd_bf16": (grid_sample.plane_product_backward, "launches_bf16"),
    "plane_line_fwd": (plane_line.plane_line, "launches"),
    "plane_line_fwd_cp": (plane_line.plane_line, "launches_cp"),
    "plane_line_density_fwd": (plane_line.plane_line_density, "launches"),
    "plane_line_density_fwd_cp": (plane_line.plane_line_density, "launches_cp"),
    "plane_line_bwd": (plane_line.plane_line_backward, "launches"),
    "plane_line_bwd_cp": (plane_line.plane_line_backward, "launches_cp"),
}


def reset_counts():
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)


def read_counts() -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}


def add_counts(*counts: dict) -> dict:
    """The kernel-by-kernel sum of several ``read_counts()`` (of ranks)."""
    return {name: sum(c[name] for c in counts) for name in COUNTERS}

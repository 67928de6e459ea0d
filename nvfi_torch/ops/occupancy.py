"""Alpha-mask (occupancy volume) lookups: kernels K3 and K4.

Port of the lookups of ``nvfi_tpu/fields/kplane.py``: ``_to_mask_coords``
(:1024), ``sample_alpha`` (:1039, the eight-corner trilinear value through
``grid_sample_3d``) and the one-gather test of ``sample_occupied``
(:1073-1084).  The volume is ``(D, H, W) = (gz, gy, gx)``; x indexes W.

``occupancy_trilinear`` and ``occupancy_nearest`` are the wrappers of the
hand-written CUDA kernels in ``csrc/occupancy.cu``; the ``*_reference``
functions are their plain PyTorch versions, which the wrappers run for CPU
tensors only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .grid_sample import grid_sample_3d


def denormalize(xyz_norm: torch.Tensor, aabb) -> torch.Tensor:
    """Coords normalized to ``aabb`` (a (2, 3) host array) -> world coords."""
    a = np.asarray(aabb, np.float32)
    size = torch.as_tensor(a[1] - a[0], device=xyz_norm.device)
    return (xyz_norm + 1.0) * size / 2.0 + torch.as_tensor(a[0], device=xyz_norm.device)


def to_mask_coords(xyz_norm: torch.Tensor, model_aabb, mask_aabb: torch.Tensor):
    """Re-normalize model-aabb coords into the mask's own aabb (the JAX
    package's ``kplane._to_mask_coords``).

    The operation order is the JAX package's, with a true division by the
    tensor ``A1 - A0``: the cell index downstream turns these floats into
    integers.  ``model_aabb`` None means the two boxes are the same.
    """
    if model_aabb is None:
        return xyz_norm
    world = denormalize(xyz_norm, model_aabb)
    return (world - mask_aabb[0]) * 2.0 / (mask_aabb[1] - mask_aabb[0]) - 1.0


def occupancy_trilinear_reference(volume, xyz_norm, model_aabb, mask_aabb):
    """Plain version of K3: (..., 3) coords -> (...,) trilinear mask value."""
    return grid_sample_3d(volume, to_mask_coords(xyz_norm, model_aabb, mask_aabb))


def occupancy_nearest_reference(dilated, xyz_norm, model_aabb, mask_aabb):
    """Plain version of K4: (..., 3) coords -> (...,) bool, one gather into
    the corner-dilated volume and the in-range test."""
    c = to_mask_coords(xyz_norm, model_aabb, mask_aabb)
    D, H, W = dilated.shape
    sizes = torch.tensor([W, H, D], dtype=c.dtype, device=c.device)
    pix = (c + 1.0) * 0.5 * (sizes - 1.0)
    # cells outside the volume by a full cell have no in-range corner
    in_range = torch.all((pix > -1.0) & (pix < sizes), dim=-1)
    top = torch.tensor([max(W - 2, 0), max(H - 2, 0), max(D - 2, 0)], device=c.device)
    i = torch.minimum(torch.clamp(torch.floor(pix).to(torch.int64), min=0), top)
    v = dilated.reshape(-1)[(i[..., 2] * H + i[..., 1]) * W + i[..., 0]]
    return (v > 0) & in_range


def _launch(name, volume, xyz_norm, model_aabb, mask_aabb, out_dtype):
    """Check the arguments, allocate the output and launch K3 or K4."""
    dev = xyz_norm.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for what, x in (("volume", volume), ("xyz", xyz_norm), ("mask aabb", mask_aabb)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")
    if volume.dim() != 3 or volume.numel() == 0 or volume.numel() >= 2**31:
        raise ValueError(f"{name}: volume shape {tuple(volume.shape)} is not a non-empty "
                         "(D, H, W) of fewer than 2^31 values")
    if xyz_norm.dim() < 1 or xyz_norm.shape[-1] != 3:
        raise ValueError(f"{name}: coords must be (..., 3), got {tuple(xyz_norm.shape)}")
    if tuple(mask_aabb.shape) != (2, 3):
        raise ValueError(f"{name}: mask aabb must be (2, 3), got {tuple(mask_aabb.shape)}")
    batch = xyz_norm.shape[:-1]
    out = torch.empty(batch, dtype=out_dtype, device=dev)
    P = out.numel()
    if P == 0:
        return out, False
    a = np.zeros((2, 3), np.float32) if model_aabb is None else np.asarray(model_aabb, np.float32)
    a0 = (ctypes.c_float * 3)(*a[0].tolist())
    asize = (ctypes.c_float * 3)(*(a[1] - a[0]).tolist())
    D, H, W = volume.shape
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = getattr(lib, f"nvfi_{name}_fwd")(
            volume.data_ptr(), D, H, W, xyz_norm.data_ptr(), P, a0, asize,
            mask_aabb.data_ptr(), int(model_aabb is not None), out.data_ptr(),
            kernels.stream_ptr(dev),
        )
    kernels.check(err, f"{name}_fwd")
    return out, True


def occupancy_trilinear(volume, xyz_norm, model_aabb, mask_aabb):
    """K3: trilinear value (...,) of the mask volume at (..., 3) coords that
    are normalized to ``model_aabb`` (None: already to the mask's box).

    For CPU tensors this runs :func:`occupancy_trilinear_reference`.  For CUDA
    tensors it launches ``nvfi_occupancy_trilinear_fwd`` (csrc/occupancy.cu)
    or raises; ``occupancy_trilinear.launches`` counts the launches.
    """
    if xyz_norm.device.type == "cpu":
        return occupancy_trilinear_reference(volume, xyz_norm, model_aabb, mask_aabb)
    out, launched = _launch("occupancy_trilinear", volume, xyz_norm, model_aabb, mask_aabb,
                            torch.float32)
    occupancy_trilinear.launches += launched
    return out


occupancy_trilinear.launches = 0


def occupancy_nearest(dilated, xyz_norm, model_aabb, mask_aabb):
    """K4: bool (...,) occupancy test, one gather into the corner-dilated
    volume; a weak superset of ``occupancy_trilinear(...) > 0``.

    For CPU tensors this runs :func:`occupancy_nearest_reference`.  For CUDA
    tensors it launches ``nvfi_occupancy_nearest_fwd`` (csrc/occupancy.cu) or
    raises; ``occupancy_nearest.launches`` counts the launches.
    """
    if xyz_norm.device.type == "cpu":
        return occupancy_nearest_reference(dilated, xyz_norm, model_aabb, mask_aabb)
    out, launched = _launch("occupancy_nearest", dilated, xyz_norm, model_aabb, mask_aabb,
                            torch.bool)
    occupancy_nearest.launches += launched
    return out


occupancy_nearest.launches = 0

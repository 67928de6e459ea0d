"""Alpha-mask (occupancy volume) lookups: kernels K3 and K4.

Port of the lookups of ``nvfi_tpu/fields/kplane.py``: ``_to_mask_coords``
(:1024), ``sample_alpha`` (:1039, the eight-corner trilinear value through
``grid_sample_3d``) and the one-gather test of ``sample_occupied``
(:1073-1084).  The volume is ``(D, H, W) = (gz, gy, gx)``; x indexes W.

``occupancy_trilinear`` and ``occupancy_nearest`` are the wrappers of the
hand-written CUDA kernels in ``csrc/occupancy.cu``; the ``*_reference``
functions are their plain PyTorch versions, which the wrappers run for CPU
tensors only.

K3 reads, beside the volume, its *cell bits* (:func:`occupancy_bits`): one
bit a cell, packed along W, 0 where all eight corners of the cell hold +0.0.
Where a sample's cell has bit 0 (and its pixel coords are finite) the
trilinear value is exactly +0.0, and the kernel writes it without a gather.
K4 reads only the *occupied bits* of the corner-dilated volume
(:func:`occupied_bits`): one bit a cell in the same layout, set where
``dilated[cell] > 0``.  Both are derived state: built once per mask wherever
an alpha state is made (``kplane.update_alpha_mask``,
``checkpoint.alpha_state_from_numpy``) and never saved.
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


def mask_pixels(xyz_norm, model_aabb, mask_aabb, shape):
    """(..., 3) model-aabb coords -> (..., 3) pixel coords (x, y, z) in the
    (D, H, W) volume of ``shape``, rounded as the kernels round them."""
    c = to_mask_coords(xyz_norm, model_aabb, mask_aabb)
    D, H, W = shape
    sizes = torch.tensor([W, H, D], dtype=c.dtype, device=c.device)
    return (c + 1.0) * 0.5 * (sizes - 1.0)


def mask_cells(pix, shape):
    """K4's cell of each sample: clip(floor(pix), 0, size - 2) per axis,
    (..., 3) int64 (x, y, z).  An axis of size 1 has the one cell 0."""
    D, H, W = shape
    top = torch.tensor([max(W - 2, 0), max(H - 2, 0), max(D - 2, 0)], device=pix.device)
    return torch.minimum(torch.clamp(torch.floor(pix).to(torch.int64), min=0), top)


def occupancy_bits_shape(shape):
    """(cells along D, cells along H, 32-bit words along W) of the cell bits
    of a (D, H, W) volume; an axis of size n has max(n - 1, 1) cells."""
    D, H, W = shape
    return max(D - 1, 1), max(H - 1, 1), -(-max(W - 1, 1) // 32)


def occupancy_bits(volume: torch.Tensor) -> torch.Tensor:
    """The cell bits of K3: (Dc, Hc, words) int32 on the volume's device.

    Cell c (``mask_cells``) has corners c and min(c + 1, size - 1) on each
    axis.  Its bit, bit ``c_x % 32`` of word ``c_x // 32`` of row (c_z, c_y),
    is 0 only where all eight corners hold +0.0 exactly (bit pattern 0); a
    -0.0, a NaN, an inf or any other value sets it.
    """
    if volume.dim() != 3 or volume.dtype != torch.float32:
        raise ValueError(f"occupancy_bits: want a (D, H, W) float32 volume, got "
                         f"{volume.dtype} {tuple(volume.shape)}")
    occ = volume.contiguous().view(torch.int32) != 0
    for ax in range(3):
        n = occ.shape[ax]
        cells = max(n - 1, 1)
        occ = occ.narrow(ax, 0, cells) | occ.narrow(ax, min(1, n - 1), cells)
    return _pack_cells(occ)


def occupied_bits(dilated: torch.Tensor) -> torch.Tensor:
    """The occupied bits of K4: (Dc, Hc, words) int32 on the device of the
    corner-dilated volume, in the layout of :func:`occupancy_bits`.

    The bit of cell c (``mask_cells``) is ``dilated[c] > 0``: exact for any
    volume, so a NaN, a -0.0 or a negative value leaves it 0.  For a binary
    volume and its own ``corner_dilate`` these are K3's cell bits; for any
    other ``dilated`` (one read from a checkpoint) they need not be.
    """
    if dilated.dim() != 3 or dilated.dtype != torch.float32:
        raise ValueError(f"occupied_bits: want a (D, H, W) float32 volume, got "
                         f"{dilated.dtype} {tuple(dilated.shape)}")
    Dc, Hc, _ = occupancy_bits_shape(dilated.shape)
    return _pack_cells(dilated[:Dc, :Hc, :max(dilated.shape[2] - 1, 1)] > 0)


def _pack_cells(occ):
    """(Dc, Hc, Wc) bool -> (Dc, Hc, ceil(Wc / 32)) int32: cell x is bit x % 32
    of word x // 32."""
    Dc, Hc, Wc = occ.shape
    words = -(-Wc // 32)
    occ = torch.cat([occ, occ.new_zeros(Dc, Hc, words * 32 - Wc)], dim=2)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=occ.device),
        torch.arange(32, device=occ.device))
    packed = (occ.reshape(Dc, Hc, words, 32).to(torch.int64) * weights).sum(-1)
    packed = packed - (packed >> 31) * (1 << 32)  # the top bit as int32's sign
    return packed.to(torch.int32).contiguous()


def cell_bit(bits, cell):
    """(...,) int32 0/1: the bit of each cell (..., 3) (x, y, z) in packed
    cell bits (:func:`occupancy_bits`, :func:`occupied_bits`)."""
    word = bits[cell[..., 2], cell[..., 1], cell[..., 0] // 32]
    return torch.bitwise_right_shift(word, (cell[..., 0] % 32).to(torch.int32)) & 1


def occupancy_bits_skip(bits, shape, xyz_norm, model_aabb, mask_aabb):
    """(...,) bool: the samples whose cell has bit 0 and whose pixel coords
    are finite, which K3 writes as +0.0 without a gather (plain PyTorch)."""
    pix = mask_pixels(xyz_norm, model_aabb, mask_aabb, shape)
    cell = mask_cells(torch.nan_to_num(pix), shape)
    return torch.isfinite(pix).all(-1) & (cell_bit(bits, cell) == 0)


def occupancy_trilinear_reference(volume, xyz_norm, model_aabb, mask_aabb):
    """Plain version of K3: (..., 3) coords -> (...,) trilinear mask value."""
    return grid_sample_3d(volume, to_mask_coords(xyz_norm, model_aabb, mask_aabb))


def occupancy_nearest_reference(dilated, xyz_norm, model_aabb, mask_aabb):
    """Plain version of K4: (..., 3) coords -> (...,) bool, one gather into
    the corner-dilated volume and the in-range test."""
    D, H, W = dilated.shape
    pix = mask_pixels(xyz_norm, model_aabb, mask_aabb, dilated.shape)
    sizes = torch.tensor([W, H, D], dtype=pix.dtype, device=pix.device)
    # cells outside the volume by a full cell have no in-range corner
    in_range = torch.all((pix > -1.0) & (pix < sizes), dim=-1)
    i = mask_cells(pix, dilated.shape)
    v = dilated.reshape(-1)[(i[..., 2] * H + i[..., 1]) * W + i[..., 0]]
    return (v > 0) & in_range


NEAREST_THREADS = 128  # a block of K4 (csrc/occupancy.cu kNearestThreads), one thread a sample


def _launch(name, volume, bits, head, xyz_norm, model_aabb, mask_aabb, out_dtype):
    """Check the arguments, allocate the output and launch ``nvfi_{name}_fwd``
    with the wrapper's leading arguments ``head`` (the pointers it reads and
    D, H, W), then the coords, boxes, output and stream."""
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
    if bits.device != dev or bits.dtype != torch.int32 or not bits.is_contiguous():
        raise ValueError(f"{name}: cell bits must be contiguous int32 on {dev}, "
                         f"got {bits.dtype} on {bits.device}")
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
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = getattr(lib, f"nvfi_{name}_fwd")(
            *head, xyz_norm.data_ptr(), P, a0, asize, mask_aabb.data_ptr(),
            int(model_aabb is not None), out.data_ptr(), kernels.stream_ptr(dev),
        )
    kernels.check(err, f"{name}_fwd")
    return out, True


def occupancy_trilinear(volume, bits, xyz_norm, model_aabb, mask_aabb):
    """K3: trilinear value (...,) of the mask volume at (..., 3) coords that
    are normalized to ``model_aabb`` (None: already to the mask's box).
    ``bits`` are the volume's cell bits (:func:`occupancy_bits`); a shape that
    does not match the volume's raises on any device.

    For CPU tensors this runs :func:`occupancy_trilinear_reference`.  For CUDA
    tensors it launches ``nvfi_occupancy_trilinear_fwd`` (csrc/occupancy.cu)
    or raises; ``occupancy_trilinear.launches`` counts the launches.
    """
    _check_bits_shape("occupancy_trilinear", volume, bits, "occupancy_bits")
    if xyz_norm.device.type == "cpu":
        return occupancy_trilinear_reference(volume, xyz_norm, model_aabb, mask_aabb)
    out, launched = _launch("occupancy_trilinear", volume, bits,
                            (volume.data_ptr(), *volume.shape, bits.data_ptr()), xyz_norm,
                            model_aabb, mask_aabb, torch.float32)
    occupancy_trilinear.launches += launched
    return out


occupancy_trilinear.launches = 0


def _check_bits_shape(name, volume, bits, make):
    """Raise on any device where ``bits`` are not shaped for ``volume``."""
    want = occupancy_bits_shape(volume.shape) if volume.dim() == 3 else None
    if bits is None or want is None or tuple(bits.shape) != want:
        raise ValueError(f"{name}: cell bits of shape "
                         f"{None if bits is None else tuple(bits.shape)} do not match the "
                         f"volume {tuple(volume.shape)} (want {want}: {make}(volume))")


def occupancy_nearest(dilated, occupied, xyz_norm, model_aabb, mask_aabb):
    """K4: bool (...,) occupancy test of the corner-dilated volume, one cell
    lookup a sample; a weak superset of ``occupancy_trilinear(...) > 0``.
    ``occupied`` are the volume's occupied bits (:func:`occupied_bits`), the
    one thing the kernel reads besides the coords; a shape that does not
    match the volume's raises on any device.

    For CPU tensors this runs :func:`occupancy_nearest_reference`.  For CUDA
    tensors it launches ``nvfi_occupancy_nearest_fwd`` (csrc/occupancy.cu) or
    raises; ``occupancy_nearest.launches`` counts the launches.
    """
    _check_bits_shape("occupancy_nearest", dilated, occupied, "occupied_bits")
    if xyz_norm.device.type == "cpu":
        return occupancy_nearest_reference(dilated, xyz_norm, model_aabb, mask_aabb)
    out, launched = _launch("occupancy_nearest", dilated, occupied,
                            (occupied.data_ptr(), *dilated.shape), xyz_norm, model_aabb,
                            mask_aabb, torch.bool)
    occupancy_nearest.launches += launched
    return out


occupancy_nearest.launches = 0

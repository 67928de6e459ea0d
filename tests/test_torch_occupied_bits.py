"""The occupied bits that kernel K4 reads, and the thread plans of K4 and K5,
on the CPU.

K4 (``ops.occupancy.occupancy_nearest``) reads one bit a cell,
``dilated[cell] > 0``, packed along W in the layout of K3's cell bits
(``ops.occupancy.occupied_bits``), one sample a thread; K5
(``ops.gather.row_gather``) takes a thread per 16-byte piece of the output.
Held here: the bits against a numpy packing, on volumes that are not binary;
the test read through the bits against the plain version and the JAX
package's ``sample_occupied``; the bits of every state the port makes; and
CPU emulations of both kernels' thread plans, which must cover every output
element exactly once.  Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_torch.fields import kplane
from nvfi_torch.ops import gather, occupancy
from nvfi_torch.train.checkpoint import (alpha_state_from_numpy, alpha_state_to_numpy,
                                         params_from_numpy)
from test_torch_occupancy import MASK_GRID, _coords, _mask, scene

MODEL_AABB = np.array([[-2.0, -1.5, -2.5], [2.0, 2.5, 1.5]], np.float32)
MASK_AABB = np.array([[-1.6, -1.2, -2.1], [1.7, 2.2, 1.0]], np.float32)


def _odd_volume(shape, seed=0):
    """A (D, H, W) float32 volume of 0, 1, non-binary positives, negatives,
    -0.0 and NaN."""
    rng = np.random.RandomState(seed)
    choice = rng.randint(0, 6, shape)
    values = np.stack([np.zeros(shape), np.ones(shape), rng.uniform(1e-30, 3.0, shape),
                       -rng.uniform(1e-30, 3.0, shape), np.full(shape, -0.0),
                       np.full(shape, np.nan)]).astype(np.float32)
    return np.take_along_axis(values, choice[None], 0)[0]


def _numpy_bits(dilated):
    """dilated > 0 of every cell (max(n - 1, 1) a side), bit x % 32 of word
    x // 32, as int32."""
    D, H, W = dilated.shape
    Dc, Hc, Wc = max(D - 1, 1), max(H - 1, 1), max(W - 1, 1)
    words = np.zeros((Dc, Hc, -(-Wc // 32)), np.uint32)
    with np.errstate(invalid="ignore"):
        occ = dilated[:Dc, :Hc, :Wc] > 0
    for x in range(Wc):
        words[:, :, x // 32] |= occ[:, :, x].astype(np.uint32) << np.uint32(x % 32)
    return words.view(np.int32)


def _nearest_through_bits(occupied, shape, xyz_norm, model_aabb, mask_aabb):
    """K4's test as the kernel reads it, in plain PyTorch: the in-range test
    and the cell's bit in the occupied bits of a (D, H, W) ``shape``.  A
    non-finite pixel coord is out of range; its cell is taken at 0."""
    D, H, W = shape
    pix = occupancy.mask_pixels(xyz_norm, model_aabb, mask_aabb, shape)
    sizes = torch.tensor([W, H, D], dtype=pix.dtype, device=pix.device)
    in_range = torch.all((pix > -1.0) & (pix < sizes), dim=-1)
    cell = occupancy.mask_cells(torch.nan_to_num(pix), shape)
    return in_range & (occupancy.cell_bit(occupied, cell) == 1)


def _mask_coords(shape, n=3000, seed=1):
    """Coords in the mask's own box: random ones reaching past it, every
    voxel centre (grid-aligned), points a whole cell out, and NaN and inf."""
    D, H, W = shape
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    lin = [np.linspace(-1, 1, s, dtype=np.float32) for s in (W, H, D)]
    aligned = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    odd = np.array([[np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf], [-1, -1, -1],
                    [1, 1, 1], [3.0, 0, 0], [0, -3.0, 0]], np.float32)
    return np.concatenate([x, aligned, odd])


@pytest.mark.parametrize("W", [1, 2, 33, 199])
def test_occupied_bits_pack_dilated_above_zero(W):
    vol = _odd_volume((3, 2, W), seed=W)
    got = occupancy.occupied_bits(torch.tensor(vol))
    want = _numpy_bits(vol)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert tuple(got.shape) == occupancy.occupancy_bits_shape(vol.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_occupied_bits_of_a_binary_mask_are_its_cell_bits():
    """For a binary volume and its own corner dilation, K4's bits are K3's."""
    vol = torch.tensor(_mask()["volume"])
    assert torch.equal(occupancy.occupied_bits(kplane.corner_dilate(vol)),
                       occupancy.occupancy_bits(vol))
    # not so for a volume K3's bits see as occupied and K4's as empty
    odd = torch.tensor(_odd_volume((4, 5, 6), seed=3))
    assert not torch.equal(occupancy.occupied_bits(odd), occupancy.occupancy_bits(odd))


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("shape", [(7, 9, 11), (3, 1, 33), (2, 5, 1)])
def test_the_test_through_the_bits_equals_the_plain_version(shape, renorm):
    dilated = torch.tensor(_odd_volume(shape, seed=sum(shape)))
    bits = occupancy.occupied_bits(dilated)
    xyz = torch.tensor(_mask_coords(shape))
    model_aabb = MODEL_AABB if renorm else None
    aabb = torch.tensor(MASK_AABB)
    got = _nearest_through_bits(bits, shape, xyz, model_aabb, aabb)
    want = occupancy.occupancy_nearest_reference(dilated, xyz, model_aabb, aabb)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    # the wrapper on CPU tensors runs the plain version
    assert torch.equal(occupancy.occupancy_nearest(dilated, bits, xyz, model_aabb, aabb), want)


@pytest.mark.parametrize("cut", ["words", "cells", "none"])
def test_occupancy_nearest_refuses_bits_of_another_shape(cut):
    dilated = torch.tensor(_odd_volume((4, 5, 40)))
    bits = occupancy.occupied_bits(dilated)
    bits = {"words": bits[:, :, :1].contiguous(), "cells": bits[:2].contiguous(),
            "none": None}[cut]
    with pytest.raises(ValueError, match="occupied_bits"):
        occupancy.occupancy_nearest(dilated, bits, torch.zeros(4, 3), None, torch.tensor(MASK_AABB))


def test_every_alpha_state_carries_fresh_occupied_bits():
    tree, _, tmeta = scene()
    params = params_from_numpy(tree, "cpu")
    state, _ = kplane.update_alpha_mask(params, tmeta, (5, 4, 3), device="cpu")
    assert torch.equal(state["occupied"], occupancy.occupied_bits(state["dilated"]))
    # a mask read back, whose dilated volume is not the binary volume's dilation
    arrays = _mask()
    arrays["dilated"] = _odd_volume(arrays["volume"].shape, seed=5)
    arrays["occupied"] = np.zeros((1, 1, 1), np.int32)  # derived: rebuilt, never read
    loaded = alpha_state_from_numpy(arrays, "cpu")
    assert torch.equal(loaded["occupied"], occupancy.occupied_bits(loaded["dilated"]))
    assert torch.equal(loaded["bits"], occupancy.occupancy_bits(loaded["volume"]))
    assert sorted(alpha_state_to_numpy(loaded)) == ["aabb", "dilated", "volume"]
    # an old mask without a dilated volume has no occupied bits, and
    # sample_occupied falls back to the trilinear test
    old = alpha_state_from_numpy(_mask(dilated=False), "cpu")
    assert "occupied" not in old
    x = torch.tensor(_coords(200))
    assert torch.equal(kplane.sample_occupied(old, x, tmeta),
                       kplane.sample_alpha(old, x, tmeta) > 0)


@pytest.mark.parametrize("with_meta", [True, False])
def test_sample_occupied_through_the_bits_matches_jax(with_meta):
    _, jmeta, tmeta = scene()
    state = _mask(seed=4)
    x = _coords(seed=6)
    want = np.asarray(jkplane.sample_occupied({k: jnp.asarray(v) for k, v in state.items()},
                                              jnp.asarray(x), jmeta if with_meta else None))
    tstate = alpha_state_from_numpy(state, "cpu")
    tm = tmeta if with_meta else None
    got = kplane.sample_occupied(tstate, torch.tensor(x), tm)
    through_bits = _nearest_through_bits(
        tstate["occupied"], tstate["dilated"].shape, torch.tensor(x),
        tm.aabb_np if tm else None, tstate["aabb"])
    assert torch.equal(got, through_bits)
    # XLA and torch may round a coordinate within a last place of a cell edge
    # to either side of it; elsewhere the two agree exactly
    c = occupancy.to_mask_coords(torch.tensor(x), tm.aabb_np if tm else None, tstate["aabb"])
    pix = ((c + 1.0) * 0.5).numpy() * (np.array(MASK_GRID, np.float32) - 1)
    safe = (np.abs(pix - np.round(pix)) > 1e-3).all(-1)
    assert safe.mean() > 0.97
    np.testing.assert_array_equal(through_bits.numpy()[safe], want[safe])
    assert 0.2 < want.mean() < 0.95


def _k4_cover(P):
    """How often K4's threads write each sample (CPU emulation of the C
    entry's grid and the kernel's index arithmetic: one thread a sample)."""
    threads = occupancy.NEAREST_THREADS
    hits = np.zeros(P, np.int64)
    for block in range(-(-P // threads)):
        for t in range(threads):
            p = block * threads + t
            if p < P:
                hits[p] += 1
    return hits


@pytest.mark.parametrize("P", [1, 3, 127, 128, 129, 1023, 87808 // 64 + 7])
def test_k4_threads_write_every_sample_once(P):
    assert (_k4_cover(P) == 1).all()


def _k5_cover(n, C):
    """How often K5's threads write each output float (CPU emulation of the
    C entry's grid and the kernel's index arithmetic: a thread a piece of 4
    floats where C is a multiple of 4, else of 1, over the flat (row, piece)
    space)."""
    threads = gather.ROW_GATHER_THREADS
    width = 4 if C % 4 == 0 else 1
    cols = C // width
    total = n * cols
    hits = np.zeros((n, C), np.int64)
    for block in range(-(-total // threads)):
        for t in range(threads):
            j = block * threads + t
            if j < total:
                i = j // cols
                c = j - i * cols
                hits[i, c * width:(c + 1) * width] += 1
    return hits


@pytest.mark.parametrize("n,C", [(1, 5), (1, 16), (257, 48), (300, 16), (129, 48), (33, 7),
                                 (7, 3), (1024, 128), (5, 4), (64, 192)])
def test_k5_threads_write_every_output_float_once(n, C):
    assert (_k5_cover(n, C) == 1).all()

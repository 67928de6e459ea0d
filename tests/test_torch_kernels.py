"""The CUDA kernels of nvfi_torch (K1 plane_product and its density-only
entry K1d, K2 composite, K3 occupancy_trilinear, K4 occupancy_nearest, K5
row_gather) held against their plain PyTorch versions.

This file imports neither jax nor nvfi_tpu, so it also runs on a machine with
a card and no JAX:  python -m pytest --noconftest -q tests/test_torch_kernels.py
Tests marked ``cuda`` skip where there is no card.
"""

import numpy as np
import pytest
import torch

from nvfi_torch.ops import compositing, gather, grid_sample, occupancy

WRAPPERS = (grid_sample.plane_product, grid_sample.plane_product_density,
            compositing.composite, occupancy.occupancy_trilinear,
            occupancy.occupancy_nearest, gather.row_gather)
MODEL_AABB = np.array([[-2.0, -1.5, -2.5], [2.0, 2.5, 1.5]], np.float32)


def _plane_case(P, seed=0, gs=(12, 10, 9), K=4, Cd=4, Ca=37):
    """Non-cubic grid, random time planes, C = 41 (not a multiple of 32), and
    coords of which ~13% per axis lie outside [-1, 1]."""
    rng = np.random.RandomState(seed)
    C = Cd + Ca
    space = [rng.uniform(0.2, 1.0, (gs[m1], gs[m0], C)).astype(np.float32)
             for m0, m1 in grid_sample.MAT_SPACE]
    time = [rng.uniform(0.5, 1.5, (K, gs[m0], C)).astype(np.float32)
            for m0, _ in grid_sample.MAT_TIME]
    xyzt = rng.uniform(-1.15, 1.15, (P, 4)).astype(np.float32)
    edge = np.array([[-1, -1, -1, -1], [1, 1, 1, 1], [0.9999, -0.3, 1.0001, 0.2], [0, 0, 0, 0]])
    xyzt[:4] = edge[:P]
    return space, time, xyzt, Cd


def _composite_case(N, S, seed=1):
    rng = np.random.RandomState(seed)
    sigma = (np.abs(rng.randn(N, S)) * rng.uniform(0.0, 0.1, (N, 1))).astype(np.float32)
    sigma[rng.rand(N, S) < 0.3] = 0.0
    sigma[0, 5] = 1e3  # alpha rounds to exactly 1: the 1e-10 floor carries T
    dist = np.full((N, S), 1.25, np.float32)
    dist[:, -1] = 0.0
    z = np.cumsum(np.full((N, S), 0.05, np.float32), -1) + 2.0
    rgb_pts = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return sigma, dist, z, rgb_pts


def _mask_case(P, seed=2, grid=(11, 9, 7)):
    """A binary volume (gz, gy, gx) with its corner-dilated twin (numpy), a
    mask aabb that differs from the model's, and coords reaching past both;
    the first rows sit on voxel centres of the mask's own box."""
    rng = np.random.RandomState(seed)
    gx, gy, gz = grid
    vol = (rng.rand(gz, gy, gx) < 0.3).astype(np.float32)
    dil = vol.copy()
    for ax in range(3):
        idx = np.minimum(np.arange(dil.shape[ax]) + 1, dil.shape[ax] - 1)
        dil = np.maximum(dil, np.take(dil, idx, axis=ax))
    aabb = np.array([[-1.6, -1.2, -2.1], [1.7, 2.2, 1.0]], np.float32)
    xyz = rng.uniform(-1.3, 1.3, (P, 3)).astype(np.float32)
    lin = [np.linspace(-1, 1, s, dtype=np.float32) for s in grid]
    aligned = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    n = min(P // 2, len(aligned))
    xyz[:n] = aligned[:n]
    return vol, dil, aabb, xyz


def _gather_case(n, R, C, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(R, C).astype(np.float32), rng.randint(0, R, n).astype(np.int32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    for w in WRAPPERS:
        w.launches = 0
    space, time, xyzt, Cd = _plane_case(P=50)
    args = ([torch.tensor(p) for p in space], [torch.tensor(p) for p in time],
            torch.tensor(xyzt), Cd)
    for got, want in zip(grid_sample.plane_product(*args),
                         grid_sample.plane_product_reference(*args)):
        assert torch.equal(got, want)
    cargs = [torch.tensor(x) for x in _composite_case(N=3, S=40)] + [1e-4, True, 6.0]
    for got, want in zip(compositing.composite(*cargs), compositing.composite_reference(*cargs)):
        assert torch.equal(got, want)
    assert torch.equal(
        grid_sample.plane_product_density(*args),
        grid_sample.plane_product_reference(*args, density_only=True))
    vol, dil, aabb, xyz = [torch.tensor(a) for a in _mask_case(P=300)]
    for model_aabb in (MODEL_AABB, None):
        assert torch.equal(occupancy.occupancy_trilinear(vol, xyz, model_aabb, aabb),
                           occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, aabb))
        assert torch.equal(occupancy.occupancy_nearest(dil, xyz, model_aabb, aabb),
                           occupancy.occupancy_nearest_reference(dil, xyz, model_aabb, aabb))
    tab, idx = [torch.tensor(a) for a in _gather_case(40, 12, 7)]
    assert torch.equal(gather.row_gather(tab, idx), tab[idx.long()])
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("bad", ["too_large", "negative", "int64", "float64_table", "2d_idx"])
def test_row_gather_refuses_bad_arguments_on_any_device(bad):
    tab, idx = [torch.tensor(a) for a in _gather_case(10, 12, 8)]
    if bad == "too_large":
        idx[3] = 12
    elif bad == "negative":
        idx[3] = -1
    elif bad == "int64":
        idx = idx.long()
    elif bad == "float64_table":
        tab = tab.double()
    else:
        idx = idx.reshape(2, 5)
    with pytest.raises(IndexError if bad in ("too_large", "negative") else ValueError):
        gather.row_gather(tab, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_kernel_matches_plain_on_card(P):
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    n0 = grid_sample.plane_product.launches
    got = grid_sample.plane_product(ts, tt, x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd)
    torch.cuda.synchronize()
    assert grid_sample.plane_product.launches == n0 + 1
    for g, w in zip(got, want):  # tolerance: FMA contraction in the kernel
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_density_kernel_equals_the_full_kernel_on_card(P):
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    n0, n1 = grid_sample.plane_product_density.launches, grid_sample.plane_product.launches
    got = grid_sample.plane_product_density(ts, tt, x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd, density_only=True)
    full = grid_sample.plane_product(ts, tt, x, Cd)[0]
    torch.cuda.synchronize()
    assert grid_sample.plane_product_density.launches == n0 + 1
    assert grid_sample.plane_product.launches == n1 + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # FMA contraction
    assert torch.equal(got, full)  # the same body, the same channel order


@pytest.mark.cuda
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("P", [1, 20000])
def test_occupancy_kernels_match_plain_on_card(P, renorm):
    dev = _card()
    vol, dil, aabb, xyz = [torch.tensor(a, device=dev) for a in _mask_case(P=P)]
    model_aabb = MODEL_AABB if renorm else None
    n3, n4 = occupancy.occupancy_trilinear.launches, occupancy.occupancy_nearest.launches
    tri = occupancy.occupancy_trilinear(vol, xyz, model_aabb, aabb)
    occ = occupancy.occupancy_nearest(dil, xyz, model_aabb, aabb)
    tri_want = occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, aabb)
    occ_want = occupancy.occupancy_nearest_reference(dil, xyz, model_aabb, aabb)
    torch.cuda.synchronize()
    assert occupancy.occupancy_trilinear.launches == n3 + 1
    assert occupancy.occupancy_nearest.launches == n4 + 1
    assert occ.dtype == torch.bool and tri.shape == occ.shape == (P,)
    # the kernels round every step as the plain versions do (no FMA, a true
    # division), so they agree to the last place and in every bit
    torch.testing.assert_close(tri, tri_want, rtol=0, atol=1e-6)
    assert torch.equal(tri > 0, tri_want > 0)
    assert torch.equal(occ, occ_want)
    assert bool((occ | ~(tri > 0)).all())  # K4 keeps a superset of K3 > 0
    # batches keep their shape
    if P > 1:
        assert occupancy.occupancy_trilinear(vol, xyz.reshape(4, -1, 3), model_aabb,
                                             aabb).shape == (4, P // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,R,C", [(1024, 512, 128), (1, 3, 5), (3000, 700, 192), (257, 33, 7)])
def test_row_gather_kernel_matches_plain_on_card(n, R, C):
    dev = _card()
    tab, idx = [torch.tensor(a, device=dev) for a in _gather_case(n, R, C)]
    n0 = gather.row_gather.launches
    got = gather.row_gather(tab, idx)
    torch.cuda.synchronize()
    assert gather.row_gather.launches == n0 + 1
    assert torch.equal(got, gather.row_gather_reference(tab, idx))  # a copy: exact


@pytest.mark.cuda
@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_kernel_matches_plain_on_card(white_bg):
    dev = _card()
    args = [torch.tensor(a, device=dev) for a in _composite_case(N=300, S=686)]
    n0 = compositing.composite.launches
    got = compositing.composite(*args, 1e-4, white_bg, 6.0)
    want = compositing.composite_reference(*args, 1e-4, white_bg, 6.0)
    torch.cuda.synchronize()
    assert compositing.composite.launches == n0 + 1
    for g, w in zip(got, want):  # tolerance: the scan associates differently
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=8)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    with pytest.raises(ValueError):
        grid_sample.plane_product(ts, tt, x.double(), Cd)
    with pytest.raises(ValueError):
        grid_sample.plane_product([ts[0].transpose(0, 1)] + ts[1:], tt, x, Cd)
    sigma, dist, z, rgb = [torch.tensor(a, device=dev) for a in _composite_case(N=4, S=40)]
    with pytest.raises(ValueError):
        compositing.composite(sigma, dist, z, rgb[:, :, :2], 1e-4, True, 6.0)
    with pytest.raises(ValueError):
        compositing.composite(sigma.t(), dist, z, rgb, 1e-4, True, 6.0)
    with pytest.raises(ValueError):
        grid_sample.plane_product_density(ts, tt, x[:, :3].contiguous(), Cd)
    with pytest.raises(ValueError):
        grid_sample.plane_product_density(ts, [p.cpu() for p in tt], x, Cd)
    vol, dil, aabb, xyz = [torch.tensor(a, device=dev) for a in _mask_case(P=16)]
    for wrapper in (occupancy.occupancy_trilinear, occupancy.occupancy_nearest):
        with pytest.raises(ValueError):
            wrapper(vol.double(), xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol.permute(2, 1, 0), xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, xyz[:, :2].contiguous(), MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, xyz, MODEL_AABB, aabb.cpu())
    tab, idx = [torch.tensor(a, device=dev) for a in _gather_case(10, 12, 8)]
    with pytest.raises(ValueError):
        gather.row_gather(tab.t(), idx)
    with pytest.raises(ValueError):
        gather.row_gather(tab, idx.cpu())
    with pytest.raises(IndexError):
        gather.row_gather(tab, idx + 12)

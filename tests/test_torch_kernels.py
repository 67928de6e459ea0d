"""The two CUDA kernels of nvfi_torch (K1 plane_product, K2 composite) held
against their plain PyTorch versions.

This file imports neither jax nor nvfi_tpu, so it also runs on a machine with
a card and no JAX:  python -m pytest --noconftest -q tests/test_torch_kernels.py
Tests marked ``cuda`` skip where there is no card.
"""

import numpy as np
import pytest
import torch

from nvfi_torch.ops import compositing, grid_sample


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    grid_sample.plane_product.launches = 0
    compositing.composite.launches = 0
    space, time, xyzt, Cd = _plane_case(P=50)
    args = ([torch.tensor(p) for p in space], [torch.tensor(p) for p in time],
            torch.tensor(xyzt), Cd)
    for got, want in zip(grid_sample.plane_product(*args),
                         grid_sample.plane_product_reference(*args)):
        assert torch.equal(got, want)
    cargs = [torch.tensor(x) for x in _composite_case(N=3, S=40)] + [1e-4, True, 6.0]
    for got, want in zip(compositing.composite(*cargs), compositing.composite_reference(*cargs)):
        assert torch.equal(got, want)
    assert grid_sample.plane_product.launches == 0
    assert compositing.composite.launches == 0


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

"""nvfi_torch ops held against the JAX package on the CPU: plane sampling,
the plain version of kernel K1 (plane product) and of kernel K2
(compositing), and their wrappers on CPU tensors.

Inputs are made with numpy from fixed seeds and go through both packages.
The kernels themselves are held against these plain versions on a card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.ops.compositing import raw2alpha as jraw2alpha
from nvfi_tpu.ops.grid_sample import grid_sample_2d_block as jgrid_sample_2d_block
from nvfi_torch.ops import compositing, grid_sample


def _boundary_case():
    """The boundary / out-of-range case of tests/test_ops.py:44-57."""
    rng = np.random.RandomState(7)
    H, W, C, N = 8, 11, 6, 513
    plane = rng.randn(H, W, C).astype(np.float32)
    coords = rng.uniform(-1.7, 1.7, size=(N, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [0.9999, -0.3], [-1.0001, 0.4]]
    return plane, coords


@pytest.mark.parametrize("oracle", ["jax", "torch_grid_sample"])
def test_grid_sample_2d_block_matches(oracle):
    plane, coords = _boundary_case()
    ours = grid_sample.grid_sample_2d_block(torch.tensor(plane), torch.tensor(coords)).numpy()
    if oracle == "jax":
        ref = np.asarray(jgrid_sample_2d_block(jnp.array(plane), jnp.array(coords)))
    else:
        t_plane = torch.tensor(plane).permute(2, 0, 1)[None]
        t_grid = torch.tensor(coords).view(1, -1, 1, 2)
        ref = F.grid_sample(t_plane, t_grid, align_corners=True, padding_mode="zeros")
        ref = ref[0, :, :, 0].T.numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def _plane_case(seed=0, gs=(12, 10, 9), K=4, Cd=4, Ca=6, P=600):
    """Non-cubic grid (so a swapped axis shows), random time planes, and coords
    of which ~13% per axis lie outside [-1, 1] (as advected coords do)."""
    rng = np.random.RandomState(seed)
    C = Cd + Ca
    space = [rng.uniform(0.2, 1.0, (gs[m1], gs[m0], C)).astype(np.float32)
             for m0, m1 in jkplane.MAT_SPACE]
    time = [rng.uniform(0.5, 1.5, (K, gs[m0], C)).astype(np.float32)
            for m0, _ in jkplane.MAT_TIME]
    xyzt = rng.uniform(-1.15, 1.15, (P, 4)).astype(np.float32)
    xyzt[:4] = [[-1, -1, -1, -1], [1, 1, 1, 1], [0.9999, -0.3, 1.0001, 0.2], [0, 0, 0, 0]]
    return space, time, xyzt, Cd


def test_plane_product_reference_matches_jax():
    space, time, xyzt, Cd = _plane_case()
    fused = np.asarray(jkplane._plane_product([jnp.array(p) for p in space],
                                              [jnp.array(p) for p in time], jnp.array(xyzt)))
    want_density = fused[:, :Cd].sum(-1)
    want_app = fused[:, Cd:]
    ts = [torch.tensor(p) for p in space]
    tt = [torch.tensor(p) for p in time]
    for fn in (grid_sample.plane_product_reference, grid_sample.plane_product):
        density, app = fn(ts, tt, torch.tensor(xyzt), Cd)
        np.testing.assert_allclose(density.numpy(), want_density, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(app.numpy(), want_app, rtol=1e-5, atol=1e-5)


def _composite_case(seed=1, N=37, S=90):
    rng = np.random.RandomState(seed)
    sigma = (np.abs(rng.randn(N, S)) * rng.uniform(0.0, 0.1, (N, 1))).astype(np.float32)
    sigma[rng.rand(N, S) < 0.3] = 0.0  # samples outside the box
    sigma[0, 5] = 1e3  # alpha rounds to exactly 1: the 1e-10 floor carries T
    dist = np.full((N, S), 0.05, np.float32) * 25.0
    dist[:, -1] = 0.0
    z = np.cumsum(np.full((N, S), 0.05, np.float32), -1) + 2.0
    rgb_pts = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return sigma, dist, z, rgb_pts


def _jax_composite(sigma, dist, z, rgb_pts, thres, white_bg, far):
    """The dense branch of JAX kplane.render_rays (:884-990) around raw2alpha."""
    _, weight, _ = jraw2alpha(jnp.array(sigma), jnp.array(dist))
    app_mask = weight > thres
    acc = jnp.sum(weight, axis=-1)
    rgb = jnp.sum(weight[..., None] * jnp.where(app_mask[..., None], rgb_pts, 0.0), axis=-2)
    if white_bg:
        rgb = rgb + (1.0 - acc[..., None])
    rgb = jnp.clip(rgb, 0.0, 1.0)
    depth = jnp.sum(weight * z, axis=-1) + (1.0 - acc) * far
    return [np.asarray(x) for x in (weight, acc, rgb, depth)]


@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_reference_matches_jax(white_bg):
    # tolerance: the cumprod association differs between XLA and torch
    sigma, dist, z, rgb_pts = _composite_case()
    want = _jax_composite(sigma, dist, z, rgb_pts, 1e-4, white_bg, 6.0)
    args = [torch.tensor(x) for x in (sigma, dist, z, rgb_pts)]
    for fn in (compositing.composite_reference, compositing.composite):
        got = [x.numpy() for x in fn(*args, 1e-4, white_bg, 6.0)]
        for name, g, w in zip(("weight", "acc", "rgb", "depth"), got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
    assert want[1].min() < 0.5 < want[1].max()

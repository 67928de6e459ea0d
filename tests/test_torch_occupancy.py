"""The alpha-mask (occupancy) slice of nvfi_torch held against the JAX package
on the CPU: the trilinear lookup, the mask dilation, ``sample_alpha`` /
``sample_occupied``, the density-only feature and the mask build.

Inputs are made with numpy from fixed seeds; params come from the JAX
package's init (with a seeded density blob, so that the mask is neither empty
nor full) and are carried across with ``params_from_numpy``.  The mask grid
(11, 9, 7) is non-cubic and differs from the model grid, and the masks of the
lookup tests have an aabb of their own, so a swapped axis or a skipped
re-normalization fails.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.ops import grid_sample as jgrid_sample
from nvfi_tpu.ops import resize as jresize
from nvfi_torch.fields import kplane
from nvfi_torch.ops import grid_sample, occupancy, resize
from nvfi_torch.train.checkpoint import alpha_state_from_numpy, params_from_numpy

META = dict(
    grid_size=(12, 10, 9), num_keyframes=4, tmax=0.75,
    aabb=((-2.0, -1.5, -2.5), (2.0, 2.5, 1.5)), near_far=(2.0, 6.0),
    density_n_comp=4, app_n_comp=6, app_dim=8, feature_c=16, vel_hidden=16,
    density_shift=-8.0, distance_scale=25.0,
    alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4, max_n_samples=64,
)
MASK_GRID = (11, 9, 7)
# dense alpha: softplus, exp and the MLP sums round differently in XLA and torch
ALPHA_ATOL = 2e-6


@functools.lru_cache(maxsize=None)
def scene():
    """JAX params as a numpy tree with a Gaussian density blob in the space
    planes (alpha ~1 at the centre, under alphaMask_thres far out) and the
    velocity output scaled up so that advection moves points by a few cells;
    and the two metas."""
    jmeta = jkplane.KPlaneMeta(**META)
    tree = jax.tree.map(np.array, jkplane.init_params(jax.random.PRNGKey(0), jmeta))
    rng = np.random.RandomState(0)
    cd = jmeta.density_n_comp
    amp = (12.0 / cd) ** (1.0 / 3.0) * rng.uniform(0.9, 1.1, cd)
    for i, (m0, m1) in enumerate(jkplane.MAT_SPACE):
        h, w = jmeta.grid_size[m1], jmeta.grid_size[m0]
        v, u = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        blob = np.exp(-((u - 0.1) ** 2 + (v + 0.15) ** 2) / (2.0 * 0.25**2))[..., None] * amp
        tree["planes_space"][i][..., :cd] = blob.astype(np.float32)
    for p in tree["planes_time"]:
        p *= (1.0 + 0.05 * rng.randn(*p.shape)).astype(np.float32)
    last = tree["vel"]["weight_net"][-1]
    last["w"], last["b"] = last["w"] * 6.0, last["b"] * 6.0
    return tree, jmeta, kplane.KPlaneMeta(**META)


def _jparams(tree):
    return jax.tree.map(jnp.asarray, tree)


def _mask(seed=0, dilated=True):
    """A random binary mask with an aabb of its own, as numpy arrays."""
    rng = np.random.RandomState(seed)
    gx, gy, gz = MASK_GRID
    vol = (rng.rand(gz, gy, gx) < 0.35).astype(np.float32)
    state = {"volume": vol,
             "aabb": np.array([[-1.6, -1.2, -2.1], [1.7, 2.2, 1.0]], np.float32)}
    if dilated:
        state["dilated"] = np.asarray(jkplane.corner_dilate(jnp.asarray(vol)))
    return state


def _coords(n=4000, seed=1):
    """Coords reaching past the box; the first rows sit on the box's faces,
    its centre and its corners."""
    x = np.random.RandomState(seed).uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    x[:5] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1, -1, 0.5], [-1.0001, 0.3, 0.9999]]
    return x


def _away_from_cell_edges(pix, tol=1e-3):
    """Rows whose pixel coords are not within ``tol`` of an integer: there a
    last-place difference between XLA and torch cannot change floor()."""
    return (np.abs(pix - np.round(pix)) > tol).all(-1)


@pytest.mark.parametrize("case", ["random", "grid_aligned"])
def test_grid_sample_3d_matches_jax(case):
    rng = np.random.RandomState(2)
    vol = rng.rand(7, 9, 11).astype(np.float32)
    if case == "random":
        x = _coords()
    else:  # every voxel centre, and the same shifted outward by one cell
        lin = [np.linspace(-1, 1, s, dtype=np.float32) for s in (11, 9, 7)]
        x = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
        x = np.concatenate([x, x * np.float32(1.25)])
    want = np.asarray(jgrid_sample.grid_sample_3d(jnp.asarray(vol), jnp.asarray(x)))
    got = grid_sample.grid_sample_3d(torch.tensor(vol), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # eight-term f32 sum
    assert (want > 0).any() and (want == 0).any()
    if case == "grid_aligned":  # a voxel centre returns the voxel
        np.testing.assert_allclose(got[: vol.size].reshape(11, 9, 7),
                                   vol.transpose(2, 1, 0), atol=1e-5)


@pytest.mark.parametrize("kernel", [3, 5])
def test_max_pool3d_same_matches_jax(kernel):
    vol = np.random.RandomState(3).randn(7, 9, 11).astype(np.float32)
    want = np.asarray(jresize.max_pool3d_same(jnp.asarray(vol), kernel))
    got = resize.max_pool3d_same(torch.tensor(vol), kernel).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["binary", "real", "thin"])
def test_corner_dilate_matches_jax(kind):
    rng = np.random.RandomState(4)
    vol = {"binary": (rng.rand(7, 9, 11) < 0.2).astype(np.float32),
           "real": rng.randn(7, 9, 11).astype(np.float32),
           "thin": rng.randn(1, 2, 5).astype(np.float32)}[kind]
    want = np.asarray(jkplane.corner_dilate(jnp.asarray(vol)))
    got = kplane.corner_dilate(torch.tensor(vol)).numpy()
    np.testing.assert_array_equal(got, want)


def test_denormalize_coord_matches_jax():
    _, jmeta, tmeta = scene()
    x = _coords(200)
    want = np.asarray(jkplane.denormalize_coord(jmeta, jnp.asarray(x)))
    got = kplane.denormalize_coord(tmeta, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    back = kplane.normalize_coord(tmeta, got).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_meta", [True, False])
def test_sample_alpha_matches_jax(with_meta):
    _, jmeta, tmeta = scene()
    state = _mask()
    x = _coords()
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    want = np.asarray(jkplane.sample_alpha(jstate, jnp.asarray(x), jmeta if with_meta else None))
    got = kplane.sample_alpha(alpha_state_from_numpy(state, "cpu"), torch.tensor(x),
                              tmeta if with_meta else None).numpy()
    # the two coordinate maps and the eight-term sum, in f32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    flips = (got > 0) != (want > 0)
    assert not (flips & (np.maximum(got, want) > 5e-6)).any()
    assert 0.2 < (want > 0).mean() < 0.95
    # (N, S, 3) batches keep their shape
    got3 = kplane.sample_alpha(alpha_state_from_numpy(state, "cpu"),
                               torch.tensor(x).reshape(40, 100, 3), tmeta if with_meta else None)
    assert got3.shape == (40, 100) and np.array_equal(got3.numpy().reshape(-1), got)
    if with_meta:  # the re-normalization matters: without it the values differ
        plain = kplane.sample_alpha(alpha_state_from_numpy(state, "cpu"), torch.tensor(x), None)
        assert np.abs(plain.numpy() - got).max() > 0.1


@pytest.mark.parametrize("with_meta", [True, False])
@pytest.mark.parametrize("dilated", [True, False])
def test_sample_occupied_matches_jax(dilated, with_meta):
    _, jmeta, tmeta = scene()
    state = _mask(dilated=dilated)
    x = _coords()
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = alpha_state_from_numpy(state, "cpu")
    jm, tm = (jmeta, tmeta) if with_meta else (None, None)
    want = np.asarray(jkplane.sample_occupied(jstate, jnp.asarray(x), jm))
    got = kplane.sample_occupied(tstate, torch.tensor(x), tm)
    assert got.dtype == torch.bool and got.shape == (len(x),)
    c = occupancy.to_mask_coords(torch.tensor(x), tm.aabb_np if tm else None, tstate["aabb"])
    pix = ((c + 1.0) * 0.5).numpy() * (np.array(MASK_GRID, np.float32) - 1)
    safe = _away_from_cell_edges(pix)
    assert safe.mean() > 0.97
    np.testing.assert_array_equal(got.numpy()[safe], want[safe])
    assert 0.2 < want.mean() < 0.95
    # a weak superset of the trilinear test, grid-aligned coords included
    lin = [np.linspace(-1, 1, s, dtype=np.float32) for s in MASK_GRID]
    aligned = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    for pts in (torch.tensor(x), torch.tensor(aligned)):
        meta_for = tm if pts.shape[0] == len(x) else None  # aligned to the mask's own box
        occ = kplane.sample_occupied(tstate, pts, meta_for)
        tri = kplane.sample_alpha(tstate, pts, meta_for) > 0
        assert bool((occ | ~tri).all())


def test_density_feature_matches_jax_and_field_features():
    tree, jmeta, tmeta = scene()
    rng = np.random.RandomState(5)
    xyzt = rng.uniform(-1.15, 1.15, (3, 500, 4)).astype(np.float32)
    want = np.asarray(jkplane.density_feature(_jparams(tree), jmeta, jnp.asarray(xyzt)))
    params = params_from_numpy(tree, "cpu")
    got = kplane.density_feature(params, tmeta, torch.tensor(xyzt))
    assert got.shape == (3, 500, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)  # product chain, f32
    full = kplane.field_features(params, tmeta, torch.tensor(xyzt))[0]
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 1.0


@functools.lru_cache(maxsize=None)
def _jax_alpha_chunk(n_steps):
    """The body of the JAX package's ``compute_dense_alpha.alpha_chunk`` (an
    inner function there), composed from its public functions."""
    tree, jmeta, _ = scene()

    def fn(params, xyz_c, tval):
        t = jnp.full((xyz_c.shape[0], 1), tval, dtype=jnp.float32)
        base = jkplane.snap_to_keyframe(jmeta, t)
        prev = jkplane.integrate_pos(params, jmeta, xyz_c, t, base, n_steps=n_steps)
        xyzt = jnp.concatenate([prev, jkplane.normalize_time(jmeta, base)], axis=-1)
        feat = jkplane.density_feature(params, jmeta, xyzt)
        sigma = jkplane.feature2density(
            jmeta, feat, {"times": t[..., 0], "time_offset": (t - base)[..., 0]})
        return 1.0 - jnp.exp(-sigma * jmeta.step_size)

    return jax.jit(fn)


# a keyframe, between keyframes, past tmax (render_adv_steps RK2 steps)
@pytest.mark.parametrize("tval", [0.5, 0.6, 0.95])
def test_dense_alpha_chunk_matches_jax(tval):
    tree, jmeta, tmeta = scene()
    x = np.random.RandomState(6).uniform(-0.7, 0.7, (700, 3)).astype(np.float32)
    n_steps = jmeta.snap_steps if tval <= jmeta.tmax + 1e-6 else jmeta.render_adv_steps
    assert n_steps == (1 if tval < 0.9 else 3)
    want = np.asarray(_jax_alpha_chunk(n_steps)(_jparams(tree), jnp.asarray(x), jnp.float32(tval)))
    got = kplane.dense_alpha_chunk(params_from_numpy(tree, "cpu"), tmeta, torch.tensor(x),
                                   tval, n_steps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ALPHA_ATOL)
    above = (want > META["alpha_mask_thres"]).mean()  # both sides of the mask's threshold
    assert 0.05 < above < 0.95, above


# n_times 1: t = 0 only; 7: keyframes, between and past tmax; chunk 200 pads
# the 693-point grid, 4096 does not
@pytest.mark.parametrize("n_times,chunk", [(1, 200), (7, 200), (7, 4096)])
def test_compute_dense_alpha_matches_jax(n_times, chunk):
    tree, jmeta, tmeta = scene()
    want, want_xyz = jkplane.compute_dense_alpha(_jparams(tree), jmeta, MASK_GRID,
                                                 n_times=n_times, chunk=chunk)
    got, got_xyz = kplane.compute_dense_alpha(params_from_numpy(tree, "cpu"), tmeta, MASK_GRID,
                                              n_times=n_times, chunk=chunk, device="cpu")
    assert got.shape == MASK_GRID and got_xyz.shape == MASK_GRID + (3,)
    np.testing.assert_array_equal(got_xyz, np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=ALPHA_ATOL)


@functools.lru_cache(maxsize=None)
def jax_mask():
    """The JAX package's mask of the scene, as numpy arrays, with its aabb."""
    tree, jmeta, _ = scene()
    state, new_aabb = jkplane.update_alpha_mask(_jparams(tree), jmeta, MASK_GRID)
    return {k: np.asarray(v) for k, v in state.items()}, np.asarray(new_aabb)


def test_update_alpha_mask_matches_jax():
    tree, jmeta, tmeta = scene()
    want, want_aabb = jax_mask()
    got, got_aabb = kplane.update_alpha_mask(params_from_numpy(tree, "cpu"), tmeta, MASK_GRID,
                                             device="cpu")
    gx, gy, gz = MASK_GRID
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "volume": (gz, gy, gx), "aabb": (2, 3), "dilated": (gz, gy, gx)}
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in got.values())
    np.testing.assert_array_equal(got["aabb"].numpy(), want["aabb"])
    # the binary volumes may differ only where the pooled dense alpha lies
    # within the dense alpha's tolerance of the threshold
    dense = np.asarray(jkplane.compute_dense_alpha(_jparams(tree), jmeta, MASK_GRID)[0])
    pooled = np.asarray(jresize.max_pool3d_same(
        jnp.clip(jnp.asarray(dense), 0, 1).transpose(2, 1, 0), 3))
    band = np.abs(pooled - jmeta.alpha_mask_thres) <= ALPHA_ATOL + 1e-4 * jmeta.alpha_mask_thres
    differ = got["volume"].numpy() != want["volume"]
    assert not (differ & ~band).any(), int((differ & ~band).sum())
    assert band.mean() < 0.02
    assert 0.1 < want["volume"].mean() < 0.9  # neither empty nor full
    if not differ.any():
        np.testing.assert_array_equal(got["dilated"].numpy(), want["dilated"])
        np.testing.assert_array_equal(got_aabb, want_aabb)
        assert (want_aabb != jmeta.aabb_np).any()  # the blob is off centre: the box shrinks


def test_update_alpha_mask_of_an_empty_field_keeps_the_aabb():
    tree, _, tmeta = scene()
    params = params_from_numpy(tree, "cpu")
    for p in params["planes_space"]:
        p[..., : tmeta.density_n_comp] = 0.0
    state, new_aabb = kplane.update_alpha_mask(params, tmeta, (5, 4, 3), device="cpu")
    assert float(state["volume"].sum()) == 0.0 and float(state["dilated"].sum()) == 0.0
    np.testing.assert_array_equal(new_aabb, tmeta.aabb_np)


def test_transfer_mask_is_refused():
    tree, _, tmeta = scene()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kplane.update_alpha_mask(params_from_numpy(tree, "cpu"), tmeta, (5, 4, 3),
                                 transfer=True, device="cpu")

"""The static TensoRF lookup of nvfi_torch held against the JAX package on the
CPU: zeros-padded plane and line sampling (``grid_sample_2d`` /
``grid_sample_1d``), the plane x line and line x line x line features (the
plain versions of kernels K6 and K6d) and their gradient (the plain version
of K6b), the wrappers' CPU paths and the kernels' launch plans.

The grid (24, 20, 28) is non-cubic, so a swapped plane axis or a line on the
wrong axis fails; the coords reach past [-1, 1] and hit the box's corners
exactly, where zeros padding decides the value.  Inputs come from numpy
seeds.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import tensorf_vm as jtensorf_vm
from nvfi_tpu.ops import grid_sample as jgrid_sample
from nvfi_torch.fields import tensorf_vm
from nvfi_torch.ops import grid_sample, plane_line
from nvfi_torch.train import checkpoint

GRID = (24, 20, 28)
CD, CA = 8, 12


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _meta(mod, decomposition):
    return mod.StaticMeta(
        grid_size=GRID, aabb=((-2.0,) * 3, (2.0,) * 3), near_far=(2.0, 6.0),
        density_n_comp=CD, app_n_comp=CA, app_dim=8, density_shift=-10.0, distance_scale=25.0,
        alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4, decomposition=decomposition,
        feature_c=16, max_n_samples=32)


def _tree(decomposition, seed=0):
    """JAX's init with every plane and line redrawn from numpy (unit scale,
    so the products are not tiny)."""
    tree = jax.tree.map(np.array, jtensorf_vm.init_params(jax.random.PRNGKey(seed),
                                                          _meta(jtensorf_vm, decomposition)))
    rng = np.random.RandomState(seed)
    for k in ("density_plane", "density_line", "app_plane", "app_line"):
        if k in tree:
            tree[k] = [rng.randn(*p.shape).astype(np.float32) for p in tree[k]]
    return tree


def _coords(n=500, seed=1):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    xyz[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [-1.0000001, 0.9999999, 1.0000001],
               [3.0, -7.0, 0.5], [0.0, 0.0, 0.0]]
    return xyz


def _groups(params, cp):
    """(density planes, density lines, app planes, app lines) of a tree."""
    return (None if cp else params["density_plane"], params["density_line"],
            None if cp else params["app_plane"], params["app_line"])


def test_grid_sample_2d_1d_match_jax_bit_for_bit():
    """Eager JAX and torch run the same float32 ops in the same order."""
    rng = np.random.RandomState(2)
    plane = rng.randn(20, 24, 5).astype(np.float32)
    line = rng.randn(28, 5).astype(np.float32)
    xy = _coords()[:, :2]
    u = _coords(seed=3)[:, 2]
    got2 = grid_sample.grid_sample_2d(torch.tensor(plane), torch.tensor(xy)).numpy()
    want2 = np.asarray(jgrid_sample.grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy)))
    np.testing.assert_array_equal(got2, want2)
    got1 = grid_sample.grid_sample_1d(torch.tensor(line), torch.tensor(u)).numpy()
    want1 = np.asarray(jgrid_sample.grid_sample_1d(jnp.asarray(line), jnp.asarray(u)))
    np.testing.assert_array_equal(got1, want1)
    # a corner outside weighs zero: past the box on every axis the lookup is 0
    assert not got2[4].any() and np.abs(got2[1]).sum() > 0


def _jax_app_raw(params, cp, xyz):
    """JAX's app features before the basis (tensorf_vm.py:139-151 without
    the matmul)."""
    if cp:
        prod = None
        for i in range(3):
            s = jgrid_sample.grid_sample_1d(params["app_line"][i],
                                            xyz[..., jtensorf_vm.VEC_MODE[i]])
            prod = s if prod is None else prod * s
        return prod
    feats = []
    for i in range(3):
        m0, m1 = jtensorf_vm.MAT_SPACE[i]
        p = jgrid_sample.grid_sample_2d(params["app_plane"][i],
                                        jnp.stack([xyz[..., m0], xyz[..., m1]], -1))
        feats.append(p * jgrid_sample.grid_sample_1d(params["app_line"][i],
                                                     xyz[..., jtensorf_vm.VEC_MODE[i]]))
    return jnp.concatenate(feats, -1)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_plane_line_reference_matches_jax_features(decomposition):
    cp = decomposition == "CP"
    tree, xyz = _tree(decomposition), _coords()
    jmeta = _meta(jtensorf_vm, decomposition)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    density, app = plane_line.plane_line_reference(*_groups(params, cp), torch.tensor(xyz))
    want_d = np.asarray(jtensorf_vm.density_feature(jparams, jmeta, jnp.asarray(xyz)))
    want_raw = np.asarray(_jax_app_raw(jparams, cp, jnp.asarray(xyz)))
    want_app = np.asarray(jtensorf_vm.app_feature(jparams, jmeta, jnp.asarray(xyz)))
    assert app.shape == (500, CA if cp else 3 * CA)
    np.testing.assert_allclose(density.numpy(), want_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(app.numpy(), want_raw, rtol=1e-5, atol=1e-6)
    # the field's own entry points: K6 (+ basis) and K6d on the CPU
    tmeta = _meta(tensorf_vm, decomposition)
    d2, a2 = tensorf_vm.features(params, tmeta, torch.tensor(xyz))
    np.testing.assert_allclose(a2.numpy(), want_app, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(d2.numpy(), density.numpy())
    np.testing.assert_array_equal(tensorf_vm.app_feature(params, tmeta, torch.tensor(xyz)).numpy(),
                                  a2.numpy())
    d3 = tensorf_vm.density_feature(params, tmeta, torch.tensor(xyz))
    np.testing.assert_allclose(d3.numpy(), want_d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_plane_line_backward_reference_matches_jax_vjp(decomposition):
    """Every plane and line grad within 1e-5 of its largest value."""
    cp = decomposition == "CP"
    tree, xyz = _tree(decomposition, seed=4), _coords(seed=5)
    jmeta = _meta(jtensorf_vm, decomposition)
    rng = np.random.RandomState(6)
    width = CA if cp else 3 * CA
    g_d = rng.randn(500).astype(np.float32)
    g_a = rng.randn(500, width).astype(np.float32)
    g_d[::3] = 0.0
    g_a[::4] = 0.0
    names = ["density_line", "app_line"] if cp else ["density_plane", "density_line",
                                                     "app_plane", "app_line"]

    def f(*groups):
        params = dict(zip(names, groups))
        params["basis_mat"] = tree["basis_mat"]
        return (jtensorf_vm.density_feature(params, jmeta, jnp.asarray(xyz)),
                _jax_app_raw(params, cp, jnp.asarray(xyz)))

    _, vjp = jax.vjp(f, *[[jnp.asarray(p) for p in tree[n]] for n in names])
    want = dict(zip(names, vjp((jnp.asarray(g_d), jnp.asarray(g_a)))))
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    got = plane_line.plane_line_backward_reference(*_groups(params, cp), torch.tensor(xyz),
                                                   torch.tensor(g_d), torch.tensor(g_a))
    by_name = dict(zip(["density_plane", "density_line", "app_plane", "app_line"], got))
    for n in names:
        for g, w in zip(by_name[n], want[n]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=n)
    if cp:
        assert by_name["density_plane"] is None and by_name["app_plane"] is None


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_cpu_wrappers_launch_nothing_and_carry_grads(decomposition):
    """On CPU tensors K6, K6d and K6b run their plain versions and count no
    launch; plane_line's autograd reaches every plane and line."""
    cp = decomposition == "CP"
    wrappers = (plane_line.plane_line, plane_line.plane_line_density,
                plane_line.plane_line_backward)
    before = [(w.launches, w.launches_cp) for w in wrappers]
    params = checkpoint.static_params_from_numpy(_tree(decomposition), "cpu")
    groups = _groups(params, cp)
    leaves = [p.requires_grad_(True) for g in groups if g is not None for p in g]
    xyz = torch.tensor(_coords())
    density, app = plane_line.plane_line(*groups, xyz)
    (density.sum() + app.square().sum()).backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in leaves)
    with torch.no_grad():
        np.testing.assert_array_equal(
            plane_line.plane_line_density(groups[0], groups[1], xyz).numpy(), density.numpy())
        plane_line.plane_line_backward(*groups, xyz, torch.ones(500), torch.ones(*app.shape))
    assert [(w.launches, w.launches_cp) for w in wrappers] == before


def test_backward_refuses_coords_that_require_grad():
    params = checkpoint.static_params_from_numpy(_tree("VM"), "cpu")
    xyz = torch.tensor(_coords()).requires_grad_(True)
    with pytest.raises(ValueError, match="coords take no gradient"):
        plane_line.plane_line_backward(*_groups(params, False), xyz, torch.ones(500),
                                       torch.ones(500, 3 * CA))


def test_launch_plans_at_bat_widths():
    """K6: the 16-byte path, 64 samples a block; K6b at 199^3 (597 line
    rows): 20 channels a block, whose line sums fill 47.8 KB of shared
    memory, two density and three app chunks, about four blocks a
    multiprocessor of an H100's 132; odd widths take the scalar path."""
    fwd = plane_line.plane_line_plan(24, 48, False, False, [0, 16, 256])
    assert (fwd.vec, fwd.run, fwd.smem_bytes) == (4, 64, 64 * (12 + 4 * 3 * 6))
    assert plane_line.plane_line_plan(24, 48, True, True, [0]).smem_bytes == 64 * (12 + 4 * 6)
    assert plane_line.plane_line_plan(24, 48, False, False, [8]).vec == 1
    bwd = plane_line.plane_line_bwd_plan(2048 * 686, 24, 48, 597, [0, 16], 132)
    assert (bwd.vec, bwd.chunk, bwd.d_chunks, bwd.a_chunks) == (4, 20, 2, 3)
    assert bwd.smem_bytes == 597 * 20 * 4 <= plane_line.PLANE_LINE_SMEM_LIMIT
    blocks = -(-2048 * 686 // bwd.run) * (bwd.d_chunks + bwd.a_chunks)
    assert 4 * 132 <= blocks < 4 * 132 + 5
    odd = plane_line.plane_line_bwd_plan(1000, 6, 5, 90, [0], 132)
    assert (odd.vec, odd.chunk, odd.d_chunks, odd.a_chunks, odd.run) == (1, 24, 1, 1, 256)
    with pytest.raises(ValueError, match="shared memory"):
        plane_line.plane_line_bwd_plan(1000, 24, 48, 20000, [0], 132)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_static_params_cross_from_jax(decomposition):
    """A JAX static tree crosses into the port's layout unchanged; another
    layout is refused."""
    tree = jax.tree.map(np.array, jtensorf_vm.init_params(jax.random.PRNGKey(3),
                                                          _meta(jtensorf_vm, decomposition)))
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    back = checkpoint.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="neither the VM nor the CP"):
        checkpoint.static_params_from_numpy({"planes_space": []}, "cpu")


"""The static TensoRF render, mask and stage transitions of nvfi_torch held
against the JAX package on the CPU: ``render_rays`` at eval (with and without
a mask) and in training (injected jitter and coin), ``compute_dense_alpha``,
``update_alpha_mask``, ``shrink``, ``upsample`` and the regularizers, in the
VM and CP decompositions.

The scene: JAX's init on a non-cubic grid (24, 20, 28) in a box that is not
centred, with an off-centre Gaussian density blob written into the density
planes and lines (so the mask is neither empty nor full and the shrink
moves the box), params carried across with ``static_params_from_numpy``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import tensorf_vm as jtensorf_vm
from nvfi_torch.fields import tensorf_vm
from nvfi_torch.fields.kplane import sample_alpha
from nvfi_torch.train import checkpoint

META = dict(grid_size=(24, 20, 28), aabb=((-2.0, -1.5, -2.5), (2.0, 2.5, 1.5)),
            near_far=(2.0, 6.0), density_n_comp=8, app_n_comp=8, app_dim=8,
            density_shift=-10.0, distance_scale=25.0, alpha_mask_thres=1e-4,
            raymarch_weight_thres=1e-4, feature_c=16, max_n_samples=64)
TOL = {"rgb": (1e-5, 1e-5), "acc": (1e-5, 1e-5), "depth": (1e-5, 1e-5),
       "weight": (1e-5, 1e-5)}
MASK_GRID = (22, 19, 25)  # the mask's own resolution, non-cubic too
CENTRE = np.array([0.15, 0.3, -0.4])  # the blob's centre in world coords
SIGMA = 0.55  # its width, in world units


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _axis(meta, axis, n):
    """Normalized coords of the n grid points along ``axis`` in world units,
    and the blob's 1-d profile there."""
    a = np.asarray(meta.aabb, np.float64)
    x = np.linspace(a[0][axis], a[1][axis], n)
    return np.exp(-(x - CENTRE[axis]) ** 2 / (2 * SIGMA**2))


@functools.lru_cache(maxsize=None)
def scene(decomposition):
    """(numpy tree, JAX meta, port meta): a density feature ~15 at the
    blob's centre (softplus(15 - 10) ~ 5) and -3 far from it, from a
    constant first channel.  With a feature ~0 there the empty space's
    weights would sit at rayMarch_weight_thres (softplus(-10) x 25 x the
    step is ~1e-4), where rounding flips the app mask of sample after
    sample; at -3 they are 20 times below it."""
    jmeta = jtensorf_vm.StaticMeta(**META, decomposition=decomposition)
    tree = jax.tree.map(np.array, jtensorf_vm.init_params(jax.random.PRNGKey(0), jmeta))
    gs, cd = jmeta.grid_size, jmeta.density_n_comp
    rng = np.random.RandomState(0)
    noise = lambda *s: 0.01 * rng.randn(*s)  # noqa: E731

    def line(i, amp, floor):
        v = jtensorf_vm.VEC_MODE[i]
        out = _axis(jmeta, v, gs[v])[:, None] * amp + noise(gs[v], cd)
        out[:, 0] = floor
        return out.astype(np.float32)

    if decomposition == "VM":
        amp = np.sqrt(18.0 / (3 * (cd - 1)))
        for i, (m0, m1) in enumerate(jtensorf_vm.MAT_SPACE):
            plane = np.outer(_axis(jmeta, m1, gs[m1]), _axis(jmeta, m0, gs[m0]))[..., None] * amp
            plane = plane + noise(gs[m1], gs[m0], cd)
            plane[..., 0] = -1.0
            tree["density_plane"][i] = plane.astype(np.float32)
            tree["density_line"][i] = line(i, amp, 1.0)
    else:
        amp = (18.0 / (cd - 1)) ** (1.0 / 3.0)
        for i in range(3):
            floor = 3.0 ** (1.0 / 3.0)
            tree["density_line"][i] = line(i, amp, -floor if i == 0 else floor)
    return tree, jmeta, tensorf_vm.StaticMeta(**META, decomposition=decomposition)


def _rays(n=64, seed=0):
    """Rays from in front of the box towards the blob, spread over it (unit
    directions scaled by up to 10%: the view directions are not normalized)."""
    rng = np.random.RandomState(seed)
    o = np.tile(np.array([[0.4, 0.6, 4.2]], np.float32), (n, 1))
    d = CENTRE + rng.uniform(-1.2, 1.2, (n, 3)) - o
    d *= rng.uniform(0.9, 1.1, (n, 1)) / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _jax_render(tree, jmeta, o, d, **kw):
    out = jtensorf_vm.render_rays(jax.tree.map(jnp.asarray, tree), jmeta, jnp.asarray(o),
                                  jnp.asarray(d), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_close(got, want):
    """Within TOL; a ray's colour may also differ by the weight of a sample
    whose weight lies within 1e-6 of rayMarch_weight_thres, where rounding
    decides whether the app mask keeps its colour (in JAX and in K2 alike)."""
    for k, (rtol, atol) in TOL.items():
        g = got[k].detach().numpy()
        if k == "rgb":
            w = want["weight"]
            flip = (w * (np.abs(w - META["raymarch_weight_thres"]) <= 1e-6)).sum(-1)
            assert (flip > 0).mean() < 0.1
            bad = np.abs(g - want[k]) > atol + rtol * np.abs(want[k]) + flip[:, None]
            assert not bad.any(), (k, np.abs(g - want[k]).max())
        else:
            np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol, err_msg=k)


def _jax_mask(tree, jmeta, grid=MASK_GRID):
    state, new_aabb = jtensorf_vm.update_alpha_mask(jax.tree.map(jnp.asarray, tree), jmeta,
                                                    grid)
    return {k: np.asarray(v) for k, v in state.items()}, np.asarray(new_aabb)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
@pytest.mark.parametrize("masked", [False, True])
def test_eval_render_matches_jax(decomposition, masked):
    tree, jmeta, tmeta = scene(decomposition)
    o, d = _rays()
    state = None
    if masked:
        jstate, _ = _jax_mask(tree, jmeta)
        state = jstate
    want = _jax_render(tree, jmeta, o, d, key=None, training=False, white_bg=True,
                       alpha_state=None if state is None else jax.tree.map(jnp.asarray, state))
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    got = tensorf_vm.render_rays(
        params, tmeta, o, d, white_bg=True, device="cpu",
        alpha_state=None if state is None else checkpoint.alpha_state_from_numpy(state, "cpu"))
    assert got["weight"].shape == (64, tmeta.n_samples)
    assert float(got["acc"].max()) > 0.5  # the blob is seen
    _assert_close(got, want)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
@pytest.mark.parametrize("white_bg,key_seed", [(True, 3), (False, 3), (False, 4)])
def test_training_render_matches_jax_with_its_draws(decomposition, white_bg, key_seed):
    """JAX draws the jitter and the coin from its key; the port takes them
    as inputs.  Keys 3 and 4 flip the coin both ways."""
    tree, jmeta, tmeta = scene(decomposition)
    o, d = _rays(seed=1)
    key = jax.random.PRNGKey(key_seed)
    want = _jax_render(tree, jmeta, o, d, key=key, training=True, white_bg=white_bg)
    k_strat, k_bg = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_strat, (64, 1), jnp.float32))
    coin = bool(jax.random.uniform(k_bg, ()) < 0.5)
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    for p in jax.tree.leaves(params):
        p.requires_grad_(True)
    got = tensorf_vm.render_rays(params, tmeta, o, d, white_bg=white_bg, training=True,
                                 jitter=torch.tensor(jitter), bg_coin=coin, device="cpu")
    _assert_close(got, want)
    assert got["rgb"].requires_grad
    if not white_bg:
        assert coin == (key_seed == 3), "the two keys no longer flip the coin both ways"


def test_training_render_needs_its_draws():
    tree, _, tmeta = scene("VM")
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    o, d = _rays()
    with pytest.raises(ValueError, match="jitter"):
        tensorf_vm.render_rays(params, tmeta, o, d, white_bg=True, training=True, device="cpu")
    with pytest.raises(ValueError, match="bg_coin"):
        tensorf_vm.render_rays(params, tmeta, o, d, white_bg=False, training=True,
                               jitter=torch.zeros(64, 1), device="cpu")


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_dense_alpha_and_mask_match_jax(decomposition):
    """The dense alpha within 2e-6 (softplus and exp round differently in
    XLA and torch), the binary volume bit for bit, the proposed aabb and the
    stored (pre-shrink) aabb exact."""
    tree, jmeta, tmeta = scene(decomposition)
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    jalpha, jdense = jtensorf_vm.compute_dense_alpha(jax.tree.map(jnp.asarray, tree), jmeta,
                                                     MASK_GRID)
    alpha, dense = tensorf_vm.compute_dense_alpha(params, tmeta, MASK_GRID, device="cpu")
    np.testing.assert_array_equal(dense, np.asarray(jdense))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=0, atol=2e-6)
    jstate, jnew = _jax_mask(tree, jmeta)
    state, new = tensorf_vm.update_alpha_mask(params, tmeta, MASK_GRID, device="cpu")
    np.testing.assert_array_equal(state["volume"].numpy(), jstate["volume"])
    np.testing.assert_array_equal(new, jnew)
    np.testing.assert_array_equal(state["aabb"].numpy(), jstate["aabb"])
    occ = float(state["volume"].mean())
    assert 0.05 < occ < 0.8, occ
    # the cell bits K3 reads are built with the volume
    assert tuple(state["bits"].shape) == (24, 18, 1)


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_shrink_and_upsample_match_jax(decomposition):
    """Grid sizes and aabbs exact; crops exact; resized planes and lines
    within 1e-6 (the same separable formula, op for op)."""
    tree, jmeta, tmeta = scene(decomposition)
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    _, jnew = _jax_mask(tree, jmeta)
    jp, jm = jtensorf_vm.shrink(jax.tree.map(jnp.asarray, tree), jmeta, jnew)
    tp, tm = tensorf_vm.shrink(params, tmeta, jnew)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.grid_size != tmeta.grid_size and tm.aabb != tmeta.aabb
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(checkpoint.params_to_numpy(tp))):
        np.testing.assert_array_equal(b, np.asarray(a))
    res = (31, 26, 29)
    jp2, jm2 = jtensorf_vm.upsample(jp, jm, res)
    tp2, tm2 = tensorf_vm.upsample(tp, tm, res)
    assert dataclasses.asdict(tm2) == dataclasses.asdict(jm2) and tm2.grid_size == res
    for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(checkpoint.params_to_numpy(tp2))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)
    for name in ("density_line", "app_line") + (("density_plane", "app_plane")
                                               if decomposition == "VM" else ()):
        assert all(p.is_leaf and p.is_contiguous() and p.requires_grad for p in tp2[name])


def test_mask_lookup_after_a_shrink_keeps_jax_box():
    """Kept on purpose (ROADMAP.md C): update_alpha_mask stores the box
    before the shrink, and render_rays looks the mask up without the model's
    box, so after the shrink the eval lookup takes coords normalized to the
    new box as if they were the old box's.  The port renders what JAX
    renders, and the lookup it makes differs from a re-normalized one."""
    tree, jmeta, tmeta = scene("VM")
    jstate, jnew = _jax_mask(tree, jmeta)
    jp, jm = jtensorf_vm.shrink(jax.tree.map(jnp.asarray, tree), jmeta, jnew)
    params, tm = tensorf_vm.shrink(checkpoint.static_params_from_numpy(tree, "cpu"), tmeta,
                                   jnew)
    state = checkpoint.alpha_state_from_numpy(jstate, "cpu")
    o, d = _rays(seed=2)
    want = _jax_render(jax.tree.map(np.asarray, jp), jm, o, d, key=None, training=False,
                       white_bg=True, alpha_state=jax.tree.map(jnp.asarray, jstate))
    got = tensorf_vm.render_rays(params, tm, o, d, white_bg=True, alpha_state=state,
                                 device="cpu")
    _assert_close(got, want)
    pts, _, _ = tensorf_vm.sample_ray(tm, torch.tensor(o), torch.tensor(d), tm.n_samples)
    xyz = tensorf_vm.normalize_coord(tm, pts)
    as_jax = sample_alpha(state, xyz) > 0
    renormalized = sample_alpha(state, xyz, tm) > 0
    assert bool((as_jax != renormalized).any())


@pytest.mark.parametrize("decomposition", ["VM", "CP"])
def test_regularizers_match_jax(decomposition):
    tree, jmeta, tmeta = scene(decomposition)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    for name in ("density_l1", "tv_loss_density", "tv_loss_app"):
        want = float(getattr(jtensorf_vm, name)(jparams, jmeta))
        got = float(getattr(tensorf_vm, name)(params, tmeta))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), name

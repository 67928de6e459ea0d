"""The other shaders and the DensityLinear decoder of nvfi_torch (ROADMAP A3)
held against the JAX package on the CPU: ``eval_sh_bases``, ``render_rays``
in every shading mode and with DensityLinear (dense, the top-K shade, and
MLP_Fea in bf16; a train loss's gradients are in ``test_torch_shader_grads``), the
DensityLinear mask build (the plain version of kernel K1d.raw) in float32
and bf16, the parameter carry-over and checkpoints with an analytic
shader's ``None`` params, and the callers that pass no per-sample times,
which fail in JAX and in the port alike.

The scene is ``test_torch_render``'s at each mode's ``app_dim`` (SH 27,
RGB / RGBIdentity 3, RGBtLinear 6, else 8); the tolerances are those of
each test's MLP_PE counterpart.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import sh as jsh
from nvfi_tpu.fields import tensorf_vm as jtensorf_vm
from nvfi_tpu.physics import pde as jpde
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_torch.fields import kplane, sh, shaders, tensorf_vm
from nvfi_torch.ops import grid_sample
from nvfi_torch.physics import pde
from nvfi_torch.train import checkpoint, optim

import test_torch_render
from test_torch_train import _flat

APP_DIM = {"SH": 27, "RGB": 3, "RGBIdentity": 3, "RGBtLinear": 6}
# (shading mode, density mode): every shader under Density, and DensityLinear
# under MLP_PE
MODES = [("MLP_Fea", "Density"), ("MLP", "Density"), ("SH", "Density"), ("RGB", "Density"),
         ("RGBIdentity", "Density"), ("RGBtLinear", "Density"), ("MLP_PE", "DensityLinear")]
IDS = [s if d == "Density" else d for s, d in MODES]
T = 0.6  # between keyframes: every sample advected, aux["times"] != the keyframe's


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Eager steps slow down several times beside other workers at torch's
    default of a thread a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scene(shading, density, dtype="float32"):
    """JAX params of ``test_torch_render``'s scene in these modes (velocity
    scaled up), as a numpy tree, and the two metas."""
    fields = dict(test_torch_render.META, shading_mode=shading, density_mode=density,
                  app_dim=APP_DIM.get(shading, 8), compute_dtype=dtype)
    jmeta = jkplane.KPlaneMeta(**fields)
    tree = jax.tree.map(np.asarray, jkplane.init_params(jax.random.PRNGKey(0), jmeta))
    last = tree["vel"]["weight_net"][-1]
    last["w"], last["b"] = last["w"] * 20.0, last["b"] * 20.0
    return tree, jmeta, kplane.KPlaneMeta(**fields)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_bases_matches_jax(deg):
    rng = np.random.RandomState(deg)
    dirs = rng.randn(500, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jsh.eval_sh_bases(deg, jnp.asarray(dirs)))
    got = sh.eval_sh_bases(deg, torch.tensor(dirs)).numpy()
    assert got.shape == want.shape == (500, (deg + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    coeffs = rng.randn(500, 3, (deg + 1) ** 2).astype(np.float32)
    np.testing.assert_allclose(sh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(dirs)).numpy(),
                               np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs),
                                                      jnp.asarray(dirs))),
                               rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_render(jmeta, steps):
    return jax.jit(functools.partial(jkplane.render_rays, meta=jmeta, key=None, training=False,
                                     white_bg=True, adv_steps=steps))


def _check_render(got, want, tol=test_torch_render.TOL):
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    assert np.asarray(want["acc"]).mean() > 0.2


@pytest.mark.parametrize("shading,density", MODES, ids=IDS)
@pytest.mark.parametrize("top_k", [False, True], ids=["dense", "top_k"])
def test_render_rays_matches_jax_in_every_mode(shading, density, top_k):
    """The dense render and turbo's per-ray top-K shade (half the samples a
    ray), each mode's shader reading the samples' times where it needs them."""
    tree, jmeta, tmeta = _scene(shading, density)
    if top_k:
        jmeta = dataclasses.replace(jmeta, shade_fraction=0.5)
        tmeta = dataclasses.replace(tmeta, shade_fraction=0.5)
    o, d = test_torch_render._rays()
    steps = jkplane.render_steps_for_time(jmeta, T)
    want = _jax_render(jmeta, steps)(_jp(tree), t=jnp.float32(T), rays_o=jnp.asarray(o),
                                     rays_d=jnp.asarray(d))
    params = checkpoint.params_from_numpy(tree, "cpu")
    assert (params["shader"] is None) == (shading in shaders.ANALYTIC_SHADERS)
    got = kplane.render_rays(params, tmeta, T, o, d, white_bg=True, adv_steps=steps,
                             device="cpu")
    _check_render(got, want)
    assert float(got["dropped_shade"]) == float(want["dropped_shade"])


@pytest.mark.parametrize("density", ["Density", "DensityLinear"])
def test_bf16_mlp_fea_render_matches_jax(density):
    """MLP_Fea in bf16, its features' encoding in bf16; DensityLinear's
    decode meets the chain's products rounded to bf16 (the render casts its
    basis), as XLA gives them; the bf16 render's tolerances."""
    tree, jmeta, tmeta = _scene("MLP_Fea", density, "bfloat16")
    o, d = test_torch_render._rays()
    steps = jkplane.render_steps_for_time(jmeta, T)
    want = _jax_render(jmeta, steps)(_jp(tree), t=jnp.float32(T), rays_o=jnp.asarray(o),
                                     rays_d=jnp.asarray(d))
    params = checkpoint.params_from_numpy(tree, "cpu")
    got = kplane.render_rays(params, tmeta, T, o, d, white_bg=True, adv_steps=steps,
                             device="cpu")
    for k, atol in (("rgb", 5e-6), ("acc", 5e-6), ("depth", 2e-5), ("weight", 1e-5)):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)
    f32 = kplane.render_rays(params, dataclasses.replace(tmeta, compute_dtype="float32"), T, o,
                             d, white_bg=True, adv_steps=steps, device="cpu")
    assert np.abs(f32["rgb"].numpy() - got["rgb"].numpy()).max() > 1e-4  # bf16 is not f32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_density_plain_version_matches_jaxs_plane_product_channels(dtype):
    """K1d.raw's plain version: the (P, Cd) products of the density channels,
    JAX's ``_plane_product`` on the sliced planes (bf16: its last product
    unrounded, JAX's value where a float32 basis meets it, and rounded by
    one cast to JAX's bf16 value); at ``density_n_comp = 0``, K1's app is
    the same products of every channel."""
    tree, _, tmeta = _scene("MLP_PE", "DensityLinear")
    cd = tmeta.density_n_comp
    xyzt = np.random.RandomState(3).uniform(-1.1, 1.1, (3000, 4)).astype(np.float32)
    jps = [jnp.asarray(p[..., :cd]) for p in tree["planes_space"]]
    jpt = [jnp.asarray(p[..., :cd]) for p in tree["planes_time"]]
    cdt = None if dtype == "float32" else dtype
    fused = np.asarray(jax.jit(lambda a, b, x: jkplane._plane_product(a, b, x, cdt))(
        jps, jpt, jnp.asarray(xyzt)).astype(jnp.float32))
    ps = [torch.tensor(p) for p in tree["planes_space"]]
    pt = [torch.tensor(p) for p in tree["planes_time"]]
    tdt = getattr(torch, dtype)
    raw = grid_sample.plane_product_density_raw(ps, pt, torch.tensor(xyzt), cd,
                                                compute_dtype=tdt)
    assert raw.dtype == torch.float32 and raw.shape == (3000, cd)
    if dtype == "float32":  # XLA sums the corners in its own order
        np.testing.assert_allclose(raw.numpy(), fused, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(raw.to(torch.bfloat16).float().numpy(), fused)
        assert (raw.numpy() != fused).any()  # unrounded
    whole, app = grid_sample.plane_product(ps, pt, torch.tensor(xyzt), 0, compute_dtype=tdt)
    assert not whole.any() and app.shape == (3000, ps[0].shape[-1])
    if dtype == "float32":
        np.testing.assert_array_equal(app[:, :cd].numpy(), raw.numpy())
    summed = grid_sample.plane_product_density(ps, pt, torch.tensor(xyzt), cd,
                                               compute_dtype=tdt)
    np.testing.assert_allclose(raw.sum(-1).numpy(), summed.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_density_linear_mask_build_matches_jax(dtype):
    """``update_alpha_mask`` with DensityLinear: the sweep's density through
    K1d.raw's plain version and the basis decode at each time, against JAX's
    (uncast params: a float32 basis, so bf16 keeps the last product
    unrounded)."""
    tree, jmeta, tmeta = _scene("MLP_PE", "DensityLinear", dtype)
    tree = dict(tree, basis_mat_density={"w": np.abs(tree["basis_mat_density"]["w"]) * 40.0})
    grid = (9, 8, 7)
    want, _ = jkplane.compute_dense_alpha(_jp(tree), jmeta, grid, n_times=6, chunk=256)
    got, _ = kplane.compute_dense_alpha(checkpoint.params_from_numpy(tree, "cpu"), tmeta, grid,
                                        n_times=6, chunk=256, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want = np.asarray(want)
    assert want.max() > 0.02 and want.min() < 0.5 * want.max()  # a field, not a constant
    xyz = torch.tensor(np.random.RandomState(4).uniform(-1, 1, (500, 3)).astype(np.float32))
    t = torch.full((500, 1), 0.3)
    feat = kplane.density_feature(checkpoint.params_from_numpy(tree, "cpu"), tmeta,
                                  torch.cat([xyz, t], -1))
    assert feat.shape == (500, 2) and feat.dtype == torch.float32


def test_analytic_shader_params_convert_and_checkpoint(tmp_path):
    """An analytic shader has no params (``None``), and the new leaf
    ``basis_mat_density``: both packages' trees carry across, and a
    checkpoint with the Adam state round-trips either way."""
    tree, jmeta, tmeta = _scene("SH", "DensityLinear")
    assert tree["shader"] is None and tree["basis_mat_density"]["w"].shape == (4, 2)
    params = checkpoint.params_from_numpy(tree, "cpu")
    assert params["shader"] is None
    opt = optim.init_state(params)
    assert opt["m"]["shader"] is None
    # an Adam step skips the None subtree and moves the rest
    grads = kplane.map_params(torch.ones_like, params)
    before = params["basis_mat_density"]["w"].clone()
    optim.apply_updates(params, grads, opt, optim.make_lr_tree(params, 0.02, 1e-3), 1.0)
    assert opt["step"] == 1 and not torch.equal(before, params["basis_mat_density"]["w"])
    path = str(tmp_path / "port")
    checkpoint.save(path, params, tmeta, opt_state=opt)
    jparams, jmeta2, jopt, _, _ = jcheckpoint.load(path)
    assert jparams["shader"] is None and jopt["m"]["shader"] is None
    assert jmeta2.shading_mode == "SH" and jmeta2.density_mode == "DensityLinear"
    np.testing.assert_array_equal(np.asarray(jparams["basis_mat_density"]["w"]),
                                  params["basis_mat_density"]["w"].numpy())
    jpath = str(tmp_path / "jax")
    jcheckpoint.save(jpath, _jp(tree), jmeta)
    back, meta_back, _, _, _ = checkpoint.load(jpath, device="cpu")
    assert back["shader"] is None and meta_back == tmeta
    assert sorted(_flat(back)) == sorted(_flat(tree))
    fresh = kplane.init_params(torch.Generator().manual_seed(0), tmeta, device="cpu")
    assert fresh["shader"] is None and sorted(_flat(fresh)) == sorted(_flat(tree))
    bf16 = kplane.cast_compute(params, dataclasses.replace(tmeta, compute_dtype="bfloat16"))
    assert bf16["shader"] is None and bf16["basis_mat_density"]["w"].dtype == torch.bfloat16


def test_callers_without_times_fail_as_jaxs_do():
    """JAX passes ``aux=None`` in the PDE filter, the segmentation query and
    the static field; RGBtLinear and DensityLinear read ``aux["times"]``, so
    JAX fails there (a TypeError), and the port fails at the same places
    with a ValueError that says so."""
    tree, jmeta, tmeta = _scene("MLP_PE", "DensityLinear")
    x = np.random.RandomState(6).uniform(-1, 1, (64, 3)).astype(np.float32)
    t = np.full((64, 1), 0.3, np.float32)
    # jitted: JAX fails while it traces
    with pytest.raises(TypeError):
        jax.jit(functools.partial(jpde.occupancy_mask, meta=jmeta))(
            _jp(tree), xyz_norm=jnp.asarray(x), t=jnp.asarray(t))
    with pytest.raises(ValueError, match="aux"):
        pde.occupancy_mask(checkpoint.params_from_numpy(tree, "cpu"), tmeta, torch.tensor(x),
                           torch.tensor(t))
    with pytest.raises(TypeError):
        jkplane.feature2density(jmeta, jnp.ones((4, 2)), None)
    with pytest.raises(ValueError, match="aux"):
        kplane.feature2density(tmeta, torch.ones(4, 2))
    # the static field: its shader gets no times
    jsmeta = jtensorf_vm.StaticMeta(
        grid_size=(6, 5, 4), aabb=((-1.5,) * 3, (1.5,) * 3), near_far=(2.0, 6.0),
        density_n_comp=2, app_n_comp=3, app_dim=6, density_shift=-10.0, distance_scale=25.0,
        alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4, shading_mode="RGBtLinear",
        max_n_samples=16)
    stree = jax.tree.map(np.asarray, jtensorf_vm.init_params(jax.random.PRNGKey(1), jsmeta))
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (4, 1))
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (4, 1))
    with pytest.raises(TypeError):
        jax.jit(functools.partial(jtensorf_vm.render_rays, meta=jsmeta, key=None,
                                  training=False, white_bg=True))(
            _jp(stree), rays_o=jnp.asarray(o), rays_d=jnp.asarray(d))
    smeta = tensorf_vm.StaticMeta(**dataclasses.asdict(jsmeta))
    with pytest.raises(ValueError, match="aux"):
        tensorf_vm.render_rays(checkpoint.static_params_from_numpy(stree, "cpu"), smeta, o, d,
                               white_bg=True, device="cpu")


def test_shader_in_dims_and_unknown_modes():
    for mode in ("MLP_PE", "MLP_Fea", "MLP"):
        from nvfi_tpu.fields import shaders as jshaders
        assert shaders.shader_in_dim(mode, 27, 2, 6, 2) == jshaders.shader_in_dim(mode, 27, 2, 6,
                                                                                   2)
    assert shaders.shader_in_dim("MLP_Fea", 27, 2, 6, 2) == 150  # TensoRF's VM-192 shader
    with pytest.raises(ValueError):
        shaders.make_shader("RGBtFourier")
    with pytest.raises(ValueError):
        shaders.make_density_decoder("DensityFourier")
    with pytest.raises(ValueError):
        shaders.init_shader(torch.Generator(), "Nope", 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [1, 5000])
def test_raw_density_kernel_matches_plain_on_card(P, dtype):
    """K1d.raw against its plain version, both arms; the float32 arm equals
    K1's products at ``density_n_comp = 0`` bit for bit."""
    dev = _card()
    tree, _, tmeta = _scene("MLP_PE", "DensityLinear")
    cd = tmeta.density_n_comp
    ps = [torch.tensor(p, device=dev) for p in tree["planes_space"]]
    pt = [torch.tensor(p, device=dev) for p in tree["planes_time"]]
    x = torch.tensor(np.random.RandomState(3).uniform(-1.1, 1.1, (P, 4)).astype(np.float32),
                     device=dev)
    n0 = getattr(grid_sample.plane_product_density_raw,
                 "launches_bf16" if dtype == torch.bfloat16 else "launches")
    got = grid_sample.plane_product_density_raw(ps, pt, x, cd, compute_dtype=dtype)
    want = grid_sample.plane_product_reference(ps, pt, x, cd, density_only=True,
                                               compute_dtype=dtype, raw=True)
    torch.cuda.synchronize()
    assert getattr(grid_sample.plane_product_density_raw,
                   "launches_bf16" if dtype == torch.bfloat16 else "launches") == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        _, app = grid_sample.plane_product(ps, pt, x, 0)
        assert torch.equal(app[:, :cd], got)

"""nvfi_torch fields held against the JAX package on the CPU: encodings, MLP,
the MLP_PE shader, the gated velocity and the RK2 advection.

Params are made by the JAX package's init and carried across with
``params_from_numpy``; inputs are made with numpy from fixed seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import shaders as jshaders
from nvfi_tpu.fields import velocity as jvelocity
from nvfi_tpu.ops import encoding as jencoding
from nvfi_torch.fields import kplane, shaders, velocity
from nvfi_torch.ops import encoding
from nvfi_torch.train.checkpoint import params_from_numpy

META = dict(
    grid_size=(12, 10, 9), num_keyframes=4, tmax=0.75,
    aabb=((-2.0,) * 3, (2.0,) * 3), near_far=(2.0, 6.0),
    density_n_comp=4, app_n_comp=6, app_dim=8, density_shift=-4.0, distance_scale=25.0,
    alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4, feature_c=16, vel_hidden=16,
    max_n_samples=64,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


@pytest.mark.parametrize("which", ["positional_encoding", "position_encoder"])
def test_encodings_match_jax(which):
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    want = np.asarray(getattr(jencoding, which)(jnp.array(x), 6))
    got = getattr(encoding, which)(torch.tensor(x), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mlp_pe_shader_matches_jax():
    jparams = jshaders.init_shader(jax.random.PRNGKey(3), "MLP_PE", 8, 6, 6, 6, 16)
    jparams[-1]["b"] = jnp.full_like(jparams[-1]["b"], 0.3)  # exercise the last bias
    rng = np.random.RandomState(1)
    pts, view = (rng.uniform(-1.2, 1.2, (40, 3)).astype(np.float32) for _ in range(2))
    feats = rng.randn(40, 8).astype(np.float32)
    want = np.asarray(jshaders.make_shader("MLP_PE")(jparams, jnp.array(pts), jnp.array(view),
                                                     jnp.array(feats)))
    got = shaders.make_shader("MLP_PE")(_to_torch(jparams), torch.tensor(pts),
                                        torch.tensor(view), torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _gates():
    return {
        "aabb": (jvelocity.VelGate("aabb", 0.03), velocity.VelGate("aabb", 0.03)),
        "sur": (jvelocity.VelGate("sur", bounds=((-0.5, -0.6, -0.4), (0.5, 0.4, 0.6))),
                velocity.VelGate("sur", bounds=((-0.5, -0.6, -0.4), (0.5, 0.4, 0.6)))),
    }


def _vel_params(scale=1.0):
    """JAX velocity params with the output layer scaled so points really move."""
    p = _np_tree(jvelocity.init_velocity_params(jax.random.PRNGKey(5), 16))
    p["weight_net"][-1]["w"] = p["weight_net"][-1]["w"] * scale
    p["weight_net"][-1]["b"] = p["weight_net"][-1]["b"] * scale
    return p


@pytest.mark.parametrize("gate", ["aabb", "sur"])
def test_gated_velocity_matches_jax(gate):
    jgate, tgate = _gates()[gate]
    p = _vel_params()
    rng = np.random.RandomState(2)
    xyz = rng.uniform(-1.05, 1.05, (300, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (300, 1)).astype(np.float32)
    want = np.asarray(jvelocity.gated_velocity(p, jgate, jnp.array(xyz), jnp.array(t)))
    got = velocity.gated_velocity(params_from_numpy(p, "cpu"), tgate, torch.tensor(xyz),
                                  torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.abs(want).sum(-1) == 0).any() and (np.abs(want).sum(-1) > 0).any()


@pytest.mark.parametrize("gate", ["aabb", "sur"])
@pytest.mark.parametrize("n_steps", [1, 7])
def test_integrate_pos_matches_jax(gate, n_steps):
    jgate, tgate = _gates()[gate]
    jmeta = jkplane.KPlaneMeta(**META, vel_gate=jgate)
    tmeta = kplane.KPlaneMeta(**META, vel_gate=tgate)
    p = {"vel": _vel_params(scale=20.0)}
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-0.7, 0.7, (400, 3)).astype(np.float32)
    # times past tmax: the offset to the last keyframe needs several steps
    t = rng.uniform(0.0, 1.0, (400, 1)).astype(np.float32)
    jbase = jkplane.snap_to_keyframe(jmeta, jnp.array(t))
    want = np.asarray(jkplane.integrate_pos(p, jmeta, jnp.array(xyz), jnp.array(t), jbase,
                                            n_steps=n_steps))
    tt = torch.tensor(t)
    got = kplane.integrate_pos(params_from_numpy(p, "cpu"), tmeta, torch.tensor(xyz), tt,
                               kplane.snap_to_keyframe(tmeta, tt), n_steps=n_steps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    moved = np.any(want != xyz, axis=-1)
    assert moved.mean() > 0.1
    if gate == "sur":
        # the revert: points whose step would leave the surround box stay put
        # although their velocity is not zero
        jv = np.asarray(jvelocity.gated_velocity(p["vel"], jgate, jnp.array(xyz), jnp.array(t)))
        assert np.any(~moved & (np.abs(jv).sum(-1) > 0) & (np.abs(t[:, 0] - np.asarray(jbase)[:, 0]) > 0))


def test_time_and_coord_helpers_match_jax():
    jmeta, tmeta = jkplane.KPlaneMeta(**META), kplane.KPlaneMeta(**META)
    # 0.375 / 0.25 = 1.5 is a tie: both round half to even, to the keyframe 0.5
    t = np.array([[0.0], [0.1], [0.125], [0.375], [0.6], [0.74], [0.9], [1.0]], np.float32)
    for name in ("snap_to_keyframe", "normalize_time"):
        want = np.asarray(getattr(jkplane, name)(jmeta, jnp.array(t)))
        got = getattr(kplane, name)(tmeta, torch.tensor(t)).numpy()
        np.testing.assert_array_equal(got, want)
    xyz = np.random.RandomState(4).uniform(-2.5, 2.5, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(kplane.normalize_coord(tmeta, torch.tensor(xyz)).numpy(),
                               np.asarray(jkplane.normalize_coord(jmeta, jnp.array(xyz))),
                               rtol=1e-6, atol=1e-6)
    for prop in ("n_samples", "step_size", "dt_max", "max_adv_steps", "render_adv_steps",
                 "transfer_adv_steps", "snap_steps", "time_scale_factor"):
        assert getattr(tmeta, prop) == getattr(jmeta, prop), prop


@pytest.mark.parametrize("fea2dense", ["softplus", "relu", "relu_abs"])
def test_feature2density_matches_jax(fea2dense):
    jmeta = jkplane.KPlaneMeta(**META, fea2dense=fea2dense)
    tmeta = kplane.KPlaneMeta(**META, fea2dense=fea2dense)
    x = np.random.RandomState(6).uniform(-12, 30, (200, 1)).astype(np.float32)
    want = np.asarray(jkplane.feature2density(jmeta, jnp.array(x)))
    got = kplane.feature2density(tmeta, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_init_params_has_the_jax_layout():
    jmeta, tmeta = jkplane.KPlaneMeta(**META), kplane.KPlaneMeta(**META)
    jtree = jkplane.init_params(jax.random.PRNGKey(0), jmeta)
    ttree = kplane.init_params(torch.Generator().manual_seed(0), tmeta, device="cpu")
    jleaves, jdef = jax.tree.flatten(jtree)
    tleaves, tdef = jax.tree.flatten(ttree)
    assert jdef == tdef
    assert [tuple(x.shape) for x in jleaves] == [tuple(x.shape) for x in tleaves]
    assert all(x.dtype == torch.float32 for x in tleaves)
    ps = ttree["planes_space"][0]
    cd = tmeta.density_n_comp
    assert 0.08 <= float(ps[..., :cd].min()) and float(ps[..., :cd].max()) <= 0.4
    assert float(ps[..., cd:].max()) <= 0.05
    assert bool((ttree["planes_time"][1] == 1).all())
    again = kplane.init_params(torch.Generator().manual_seed(0), tmeta, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tleaves, jax.tree.leaves(again)))
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)

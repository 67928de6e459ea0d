"""The NDC and contracted samplings of nvfi_torch (ROADMAP A3) held against
the JAX package on the CPU: ``ndc_rays`` (host and torch forms) and the NDC
ray bundles, ``sample_ray_ndc`` / ``sample_ray_contracted`` with JAX's draws
injected, ``render_rays`` in both samplings (eval and a training loss's
gradients; a short NDC ``Trainer`` run is in ``test_torch_ndc_trainer``), the
refusals JAX also makes, and the eval split's unprojected rays (JAX's
harness builds its cameras without ``ndc``: an NDC-trained model is scored on
world rays under NDC sampling; the port keeps that, on purpose).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data.synthetic import RigidSphere, render_frame
from nvfi_tpu.eval import harness as jharness
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.render import rays as jrays
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import CfgNode
from nvfi_torch.eval import harness
from nvfi_torch.fields import kplane
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint, trainer

from test_train_e2e import small_cfg
from test_torch_train import _assert_trees_close, _pde_draws

H = W = 16
FOCAL = 0.5 * W / np.tan(0.5 * 0.6911112)
# the forward-facing rig of test_round5.py:152-198, the model in the NDC cube
NDC_CFG = {
    "renderer.n_rays": 32, "renderer.ndc": True, "experiment.vel_reg_n_pts": 64,
    "nvfi.bbox_x": [-1, 1], "nvfi.bbox_y": [-1, 1], "nvfi.bbox_z": [-1, 1],
    "dataset.near": 0.0, "dataset.far": 1.0, "nvfi.max_n_samples": 24,
    "nvfi.num_keyframes": 2, "nvfi.num_keyframes_end": 2,
    "nvfi.N_voxel_init": 4096, "nvfi.N_voxel_final": 4096, "nvfi.featureC": 16,
}
# a forward-facing meta for the render tests: NDC in the NDC cube; contracted
# in [-2, 2]^3 (contracted points lie within max-norm 2), near 0.1, far 50
META = dict(grid_size=(10, 9, 8), num_keyframes=3, tmax=0.75, density_n_comp=4,
            app_n_comp=6, app_dim=8, feature_c=16, vel_hidden=16, density_shift=-2.0,
            distance_scale=25.0, alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4,
            max_n_samples=40)
SAMPLINGS = {
    "ndc": dict(aabb=((-1.0,) * 3, (1.0,) * 3), near_far=(0.0, 1.0), ray_sampling="ndc"),
    "contracted": dict(aabb=((-2.0,) * 3, (2.0,) * 3), near_far=(0.1, 50.0),
                       ray_sampling="contracted", density_shift=-9.0),
}
T = 0.6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Eager steps slow down several times beside other workers at torch's
    default of a thread a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pose(dx=0.0):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = dx
    return pose


@functools.lru_cache(maxsize=None)
def _scene(sampling):
    """JAX params (velocity scaled up) as a numpy tree, the two metas."""
    fields = dict(META, **SAMPLINGS[sampling])
    jmeta = jkplane.KPlaneMeta(**fields)
    tree = jax.tree.map(np.asarray, jkplane.init_params(jax.random.PRNGKey(2), jmeta))
    last = tree["vel"]["weight_net"][-1]
    last["w"], last["b"] = last["w"] * 20.0, last["b"] * 20.0
    return tree, jmeta, kplane.KPlaneMeta(**fields)


def _rays(sampling, n=32):
    """Forward-facing rays of one camera (NDC: projected with near 1)."""
    o, d = rays.ray_bundle(_pose(0.2), H, W, FOCAL, sampling == "ndc")
    sel = np.random.RandomState(0).choice(H * W, n, replace=False)
    return o.reshape(-1, 3)[sel], d.reshape(-1, 3)[sel]


def test_ndc_rays_match_jax_on_the_host_and_in_torch():
    pose = _pose(0.3) @ np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    pose[:3, :3] = np.array([[0.99, 0.0, 0.14], [0.0, 1.0, 0.0], [-0.14, 0.0, 0.99]],
                            np.float32)
    for near in (1.0, 0.5):
        got = rays.ray_bundle(pose, H, W, FOCAL, ndc=True, near=near)
        want = jrays.ray_bundle(pose, H, W, FOCAL, ndc=True, near=near)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        o, d = rays.ray_bundle(pose, H, W, FOCAL)
        tgot = rays.ndc_rays(H, W, FOCAL, near, torch.tensor(o), torch.tensor(d), xp=torch)
        jgot = jrays.ndc_rays(H, W, FOCAL, near, jnp.asarray(o), jnp.asarray(d), xp=jnp)
        for g, w in zip(tgot, jgot):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    cam = rays.Camera(pose, H, W, FOCAL, near=0.5, ndc=True)
    jcam = jrays.Camera(pose, H, W, FOCAL, near=0.5, ndc=True)
    np.testing.assert_array_equal(cam.rays_o, jcam.rays_o)
    np.testing.assert_array_equal(cam.rays_d, jcam.rays_d)


def _jax_draws(sampling, key, n, S):
    """JAX render_rays' stratified draws for ``key``, as the port's jitter."""
    k_strat, _ = jax.random.split(key)
    if sampling == "ndc":
        return np.asarray(jax.random.uniform(k_strat, (n, S), jnp.float32))
    k1, k2 = jax.random.split(k_strat)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (n, S - S // 2 + 1), jnp.float32)),
                           np.asarray(jax.random.uniform(k2, (n, S // 2 + 1), jnp.float32))], 1)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("sampling", ["ndc", "contracted"])
def test_samplers_match_jax_with_its_draws(sampling, training):
    _, jmeta, tmeta = _scene(sampling)
    o, d = _rays(sampling)
    S, key = tmeta.n_samples, jax.random.PRNGKey(9)
    assert kplane.jitter_width(tmeta) == {"ndc": S, "contracted": S + 2}[sampling]
    jfn = {"ndc": jkplane.sample_ray_ndc, "contracted": jkplane.sample_ray_contracted}[sampling]
    want = jax.jit(functools.partial(jfn, jmeta, n_samples=S, training=training))(
        jnp.asarray(o), jnp.asarray(d), key=jax.random.split(key)[0] if training else None)
    tfn = {"ndc": kplane.sample_ray_ndc, "contracted": kplane.sample_ray_contracted}[sampling]
    jitter = torch.tensor(_jax_draws(sampling, key, len(o), S)) if training else None
    got = tfn(tmeta, torch.tensor(o), torch.tensor(d), S, jitter)
    pts, z, valid = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), pts, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(z, got[1].shape), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.broadcast_to(valid, got[2].shape))
    if sampling == "ndc":
        assert 0.2 < valid.mean() < 1.0  # some samples leave the cube
    else:
        assert np.abs(pts).max() <= 2.0 and np.abs(pts).max() > 1.5  # contracted


@functools.lru_cache(maxsize=None)
def _jax_render(jmeta, steps):
    return jax.jit(functools.partial(jkplane.render_rays, meta=jmeta, key=None, training=False,
                                     white_bg=True, adv_steps=steps))


@pytest.mark.parametrize("sampling", ["ndc", "contracted"])
def test_render_rays_matches_jax(sampling):
    tree, jmeta, tmeta = _scene(sampling)
    o, d = _rays(sampling)
    steps = jkplane.render_steps_for_time(jmeta, T)
    want = _jax_render(jmeta, steps)(_jp(tree), t=jnp.float32(T), rays_o=jnp.asarray(o),
                                     rays_d=jnp.asarray(d))
    got = kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"), tmeta, T, o, d,
                             white_bg=True, adv_steps=steps, device="cpu")
    tol = {"rgb": (1e-5, 1e-5), "acc": (1e-5, 1e-5), "depth": (1e-5, 1e-5),
           "weight": (1e-4, 1e-5)}
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k].numpy(), np.broadcast_to(want[k], got[k].shape),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert 0.05 < float(np.asarray(want["acc"]).mean()) < 0.99


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(jmeta):
    def loss(params, key, o, d, target):
        out = jkplane.render_rays(params, jmeta, jnp.float32(T), o, d, key=key, training=True,
                                  white_bg=True)
        return jnp.mean((out["rgb"] - target) ** 2)

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("sampling", ["ndc", "contracted"])
def test_training_render_grads_match_jax(sampling):
    """A training render's colour loss and per-leaf gradients, JAX's
    stratified draws injected (the gradient tolerances of test_torch_train)."""
    tree, jmeta, tmeta = _scene(sampling)
    o, d = _rays(sampling, n=24)
    target = np.random.RandomState(5).uniform(0, 1, (24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    want_loss, want = _jax_loss_grad(jmeta)(_jp(tree), key, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(target))
    params = kplane.map_params(lambda x: x.requires_grad_(True),
                               checkpoint.params_from_numpy(tree, "cpu"))
    out = kplane.render_rays(params, tmeta, T, o, d, white_bg=True, training=True,
                             jitter=_jax_draws(sampling, key, 24, tmeta.n_samples),
                             device="cpu")
    loss = torch.mean((out["rgb"] - torch.tensor(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert _assert_trees_close(kplane.map_params(lambda p: p.grad, params), want) >= 10


def _rig_dataset():
    """The forward-facing rig of test_round5.py (two spheres, three cameras
    offset along x, four times) at 16 x 16: (JAX, port) datasets."""
    objects = [RigidSphere(center=(0.0, 0.0, -3.5), radius=0.8, color=(0.9, 0.3, 0.2),
                           v_lin=(0.5, 0.0, 0.0)),
               RigidSphere(center=(1.0, 0.5, -4.5), radius=0.7, color=(0.2, 0.5, 0.9))]
    imgs, poses, tlist = [], [], []
    for dx in (-0.3, 0.0, 0.3):
        for t in (0.0, 0.25, 0.5, 0.75):
            imgs.append(render_frame(objects, _pose(dx), H, W, FOCAL, t)[0])
            poses.append(_pose(dx))
            tlist.append(float(t))
    ds = ({"train": np.stack(imgs), "test": np.stack(imgs[:2])},
          {"train": poses, "test": poses[:2]}, {"train": tlist, "test": tlist[:2]},
          {"train": len(imgs), "test": 2}, None, None, (H, W, FOCAL))
    return ds, ds


def test_refusals_jax_also_makes():
    """A block budget below 1 needs box sampling (turbo is refused under NDC
    and contracted sampling, at its first budgeted render); renderer.ndc and
    nvfi.contract_ray exclude each other in both Trainers."""
    for sampling in ("ndc", "contracted"):
        tree, jmeta, tmeta = _scene(sampling)
        o, d = _rays(sampling, n=8)
        with pytest.raises(ValueError, match="block_budget"):
            jkplane.render_rays(_jp(tree), dataclasses.replace(jmeta, block_budget=0.5), T,
                                jnp.asarray(o), jnp.asarray(d), key=None, training=False,
                                white_bg=True)
        with pytest.raises(ValueError, match="block_budget"):
            kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"),
                               dataclasses.replace(tmeta, block_budget=0.5), T, o, d,
                               white_bg=True, device="cpu")
    jcfg = small_cfg(**NDC_CFG, **{"nvfi.contract_ray": True})
    jds, tds = _rig_dataset()
    with pytest.raises(AssertionError, match="exclusive"):
        jtrainer.Trainer(jcfg, jds, mode="static_dynamic")
    with pytest.raises(AssertionError, match="exclusive"):
        trainer.Trainer(CfgNode(jcfg.to_dict()), tds, mode="static_dynamic", device="cpu")
    _, tmeta = None, trainer.Trainer(CfgNode(small_cfg(**{**NDC_CFG, "renderer.ndc": False,
                                                          "nvfi.contract_ray": True}).to_dict()),
                                     tds, mode="static_dynamic", device="cpu").meta
    assert tmeta.ray_sampling == "contracted"


def test_eval_split_scores_world_rays_under_ndc_sampling_as_jax_does():
    """JAX's eval harness builds its cameras without ``ndc``, so an NDC
    model is rendered on world rays sampled over NDC depth.  The port keeps
    this gap on purpose: its split equals JAX's and equals render_image on the
    unprojected rays, not on the NDC ones."""
    tree, jmeta, tmeta = _scene("ndc")
    jds, tds = _rig_dataset()
    want, _ = jharness.render_split(_jp(tree), jmeta, jds, "test", white_bg=True, chunk=64,
                                    update_alpha=False)
    params = checkpoint.params_from_numpy(tree, "cpu")
    got, _ = harness.render_split(params, tmeta, tds, "test", white_bg=True, chunk=64,
                                  update_alpha=False, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pose, t = tds[1]["test"][0], tds[2]["test"][0]
    world = render_image(params, kplane.eval_exact_meta(tmeta), t,
                         *rays.ray_bundle(pose, H, W, FOCAL), white_bg=True, chunk=64,
                         device="cpu")["rgb"]
    ndc = render_image(params, kplane.eval_exact_meta(tmeta), t,
                       *rays.ray_bundle(pose, H, W, FOCAL, ndc=True), white_bg=True, chunk=64,
                       device="cpu")["rgb"]
    np.testing.assert_allclose(got[0], world, rtol=1e-6, atol=1e-6)
    assert np.abs(got[0] - ndc).max() > 1e-3

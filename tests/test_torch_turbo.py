"""Turbo (the JAX package's ``block_budget`` and ``shade_fraction`` below 1) in
nvfi_torch held against the JAX package on the CPU: the block-sparse sample
axis and the per-ray top-K shade of ``render_rays`` (eval and training, their
counts ``dropped_blocks`` / ``dropped_shade`` included), the budget probe of
``train/turbo.py``, ``trainer.ray_chunking`` under a block budget, and
``render_split(sparse_budget=...)``.

The scene (non-cubic grid (12, 10, 9), K = 4, 32 samples a ray, a density
blob) and its JAX-built mask come from ``test_torch_occupancy``; blocks of 12
samples pad each ray to 36.  With 40 rays of 32 samples (more than 512) the
top-K shade is on.  Tolerances are the render's (``TOL`` of
``test_torch_render``) and the train slice's per-leaf gradient tolerance
(``test_torch_train._assert_trees_close``: rtol 2e-4, 2e-5 of a leaf's
largest grad).
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.train import trainer as jtrainer
from nvfi_tpu.train import turbo as jturbo
from nvfi_torch.eval import harness
from nvfi_torch.fields import kplane
from nvfi_torch.render import rays
from nvfi_torch.train import checkpoint, trainer, turbo

import test_torch_render
from test_torch_occupancy import jax_mask, scene
from test_torch_train import _assert_trees_close  # the train slice's grad tolerance

TOL = test_torch_render.TOL
SB = 12  # 32 samples a ray, padded to 3 blocks of 12
# the scene's 40 eval rays with the mask: 80 of 120 blocks active, at most 19
# samples a ray above rayMarch_weight_thres
BUDGET = 0.7  # B = 88 blocks: none dropped, 32 skipped
SHADE = 0.6  # K = 24 samples a ray: none dropped


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _metas(**change):
    _, jmeta, tmeta = scene()
    change = {"sample_block": SB, **change}
    return dataclasses.replace(jmeta, **change), dataclasses.replace(tmeta, **change)


def _rays(n=40):
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[0.2, 0.6, 4.5]], np.float32), (n, 1))
    d = np.concatenate([rng.randn(n, 2).astype(np.float32) * 0.1,
                        -np.ones((n, 1), np.float32)], -1)
    return o, d


@functools.lru_cache(maxsize=None)
def _jax_render_fn(meta, steps):
    return jax.jit(functools.partial(jkplane.render_rays, meta=meta, key=None,
                                     training=False, white_bg=True, adv_steps=steps))


def _both(t, mask=True, **change):
    """(JAX's eval render, the port's) of the scene's rays at t."""
    tree, _, _ = scene()
    jmeta, tmeta = _metas(**change)
    state = jax_mask()[0] if mask else None
    o, d = _rays()
    steps = jkplane.render_steps_for_time(jmeta, t)
    want = _jax_render_fn(jmeta, steps)(
        _jp(tree), t=jnp.float32(t), rays_o=jnp.asarray(o), rays_d=jnp.asarray(d),
        alpha_state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
    got = kplane.render_rays(
        checkpoint.params_from_numpy(tree, "cpu"), tmeta, t, o, d, white_bg=True,
        adv_steps=steps, device="cpu",
        alpha_state=None if state is None else checkpoint.alpha_state_from_numpy(state, "cpu"))
    return want, got


def _assert_render_close(got, want, keys=("rgb", "acc", "depth", "weight")):
    for k in keys:
        rtol, atol = TOL[k]
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in ("dropped_blocks", "dropped_shade"):
        assert got[k].shape == () and got[k].dtype == torch.float32
        assert float(got[k]) == float(want[k]), k


# a keyframe and a time between keyframes (advected)
@pytest.mark.parametrize("t", [0.5, 0.6])
def test_block_sparse_eval_render_matches_jax_and_the_dense_render(t):
    want, got = _both(t, block_budget=BUDGET)
    assert float(got["dropped_blocks"]) == 0.0 and float(got["dropped_shade"]) == 0.0
    _assert_render_close(got, want)
    assert got["weight"].shape == (40, 36)  # the padded axis
    # the padded samples carry no weight, and the rest is the dense render's
    dense = _both(t, block_budget=1.0)[1]
    assert not got["weight"][:, 32:].any()
    for k in ("rgb", "acc", "depth"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["weight"][:, :32].numpy(), dense["weight"].numpy(),
                               rtol=TOL["weight"][0], atol=TOL["weight"][1])
    assert float(want["acc"].mean()) > 0.1


def test_a_budget_too_small_drops_the_blocks_jax_drops():
    """B = 64 of the 80 active blocks: the first 64 in index order run (the
    top_k of a 0/1 score); the image and the count are JAX's."""
    want, got = _both(0.6, block_budget=0.5)
    assert float(got["dropped_blocks"]) == 16.0
    _assert_render_close(got, want)
    dense = _both(0.6, block_budget=1.0)[1]
    assert float((got["acc"] - dense["acc"]).abs().max()) > 1e-2  # the drop shows


# K = 24 covers every ray's samples above the threshold; K = 16 does not
@pytest.mark.parametrize("shade,dropped", [(SHADE, 0.0), (0.25, 76.0)])
def test_top_k_shading_matches_jax(shade, dropped):
    want, got = _both(0.6, shade_fraction=shade)
    assert float(got["dropped_shade"]) == dropped
    _assert_render_close(got, want)
    if dropped == 0.0:
        dense = _both(0.6)[1]
        for k in ("rgb", "acc", "depth"):
            rtol, atol = TOL[k]
            np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(), rtol=rtol, atol=atol)


def test_both_budgets_together_match_jax():
    want, got = _both(0.6, block_budget=BUDGET, shade_fraction=SHADE)
    assert float(got["dropped_blocks"]) == 0.0 == float(got["dropped_shade"])
    _assert_render_close(got, want)


def test_turbo_is_refused_where_jax_refuses_it():
    _, tmeta = _metas(block_budget=0.5, ray_sampling="contracted")
    tree, _, _ = scene()
    o, d = _rays(n=4)
    with pytest.raises(ValueError, match="ray_sampling"):
        kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"), tmeta, 0.5, o, d,
                           white_bg=True, device="cpu")


# ---------------------------------------------------------------------------
# the training render: both budgets with train_occupancy_prune, grads
# ---------------------------------------------------------------------------

def _train_rays(n=24):
    """Rays from above the box looking down -z; the first misses it."""
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[0.3, 0.4, 4.0]], np.float32), (n, 1))
    d = np.concatenate([rng.randn(n, 2).astype(np.float32) * 0.08,
                        -np.ones((n, 1), np.float32)], -1)
    d[0, :2] = [3.0, 3.0]
    return o, d, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def test_turbo_training_render_grads_match_jax():
    tree, _, _ = scene()
    jmeta, tmeta = _metas(train_occupancy_prune=True, block_budget=BUDGET, shade_fraction=0.5)
    state = jax_mask()[0]
    o, d, target = _train_rays()
    key, t = jax.random.PRNGKey(33), 0.6

    def jloss(params):
        out = jkplane.render_rays(params, jmeta, jnp.float32(t), jnp.asarray(o), jnp.asarray(d),
                                  key=key, training=True, white_bg=True,
                                  alpha_state={k: jnp.asarray(v) for k, v in state.items()})
        return jnp.sum((out["rgb"] - target) ** 2), out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_jp(tree))
    jitter = np.array(jax.random.uniform(jax.random.split(key)[0], (len(o), 1), jnp.float32))
    params = kplane.map_params(lambda x: x.requires_grad_(True),
                               checkpoint.params_from_numpy(tree, "cpu"))
    got = kplane.render_rays(params, tmeta, t, o, d, white_bg=True, training=True,
                             jitter=jitter, alpha_state=checkpoint.alpha_state_from_numpy(
                                 state, "cpu"), device="cpu")
    loss = torch.sum((got["rgb"] - torch.tensor(target)) ** 2)
    loss.backward()
    for k in ("rgb", "acc", "depth"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    for k in ("dropped_blocks", "dropped_shade"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["dropped_blocks"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    nonzero = _assert_trees_close(kplane.map_params(lambda p: p.grad, params), want_grads)
    assert nonzero >= 19  # planes, basis_mat, shader, the velocity net


# ---------------------------------------------------------------------------
# the budget probe, the chunking under a budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensors", [False, True])
def test_measure_block_budget_and_shade_cap_equal_jax(as_tensors):
    _, jmeta, tmeta = scene()
    state = jax_mask()[0]
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, 3] = [[0.2, 0.6, 4.5], [0.1, 0.4, 4.2]]
    for sb in (12, 16):
        jm, tm = (dataclasses.replace(m, sample_block=sb) for m in (jmeta, tmeta))
        kw = dict(H=10, W=12, focal=9.0, n_rays=64, seed=3, n_batches=3)
        want = jturbo.measure_block_budget(jm, state, poses, with_shade=True, **kw)
        tstate = checkpoint.alpha_state_from_numpy(state, "cpu") if as_tensors else state
        got = turbo.measure_block_budget(tm, tstate, torch.tensor(poses) if as_tensors
                                         else poses, with_shade=True, **kw)
        assert got == want and 0.05 <= got[0] < 0.9 and 0.0 < got[1] <= 1.0
        assert turbo.measure_block_budget(tm, tstate, poses, **kw) == want[0]
        for follow in (False, True):
            assert turbo.shade_cap_policy(got[1], 0.25, follow) == \
                jturbo.shade_cap_policy(want[1], 0.25, follow)
    rng = np.random.RandomState(4)
    coords = rng.uniform(-1.2, 1.2, (500, 3))
    vol = state["volume"].astype(np.float64)
    np.testing.assert_array_equal(turbo.trilinear_np(vol, coords),
                                  jturbo.trilinear_np(vol, coords))
    np.testing.assert_array_equal(turbo.dilated_occupied_np(vol, coords),
                                  jturbo.dilated_occupied_np(vol, coords))


def _jax_chunking(jmeta, jhp):
    """(ray_chunk, n_chunks) as the JAX package's loss computes them: the
    closure of its chunked render."""
    fn = jtrainer.make_loss_fn(jmeta, jhp, "static_dynamic", 8, 8, 6.0)
    while True:
        free = inspect.getclosurevars(fn).nonlocals
        if "ray_chunk" in free:
            return free["ray_chunk"], free["n_chunks"]
        fn = free.get("_chunked_mse") or free["render_batch"]


# the dense rule, bat's probed budget (a chunk twice the size) and one between
@pytest.mark.parametrize("budget", [1.0, 0.3, 0.6])
def test_ray_chunking_under_a_block_budget_matches_jax(budget):
    _, jmeta, tmeta = scene()
    jmeta, tmeta = (dataclasses.replace(m, block_budget=budget) for m in (jmeta, tmeta))
    hp = dict(n_rays=96, point_batch=16 * 32, vel_reg_n_pts=64)
    got = trainer.ray_chunking(tmeta, trainer.TrainHP(**hp))
    assert got == _jax_chunking(jmeta, jtrainer.TrainHP(**hp))
    assert got == {1.0: (16, 6), 0.3: (32, 3), 0.6: (24, 4)}[budget]
    draws = trainer.draw_train_inputs(torch.Generator().manual_seed(0), tmeta,
                                      trainer.TrainHP(**hp), 8, 8)
    assert draws.jitter_t.shape == (got[1], got[0], 1)


def test_train_step_keeps_the_counts_on_the_device_and_their_running_max():
    counters = trainer.init_counters()
    assert all(v.shape == () and v.device.type == "cpu" for v in counters.values())
    counters = trainer.update_counters(counters, {"dropped_blocks": torch.tensor(3.0),
                                                  "dropped_shade": torch.tensor(5.0)})
    counters = trainer.update_counters(counters, {"dropped_blocks": torch.tensor(1.0),
                                                  "dropped_shade": torch.tensor(7.0)})
    assert {k: float(v) for k, v in counters.items()} == {"dropped_blocks": 3.0,
                                                          "dropped_shade": 7.0}


# ---------------------------------------------------------------------------
# render_image and render_split on the block-sparse axis
# ---------------------------------------------------------------------------

def test_render_image_sums_the_chunks_counts_like_jax(capsys):
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = _metas(block_budget=0.5)
    state = jax_mask()[0]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, 0.6, 4.5]
    o, d = rays.ray_bundle(pose, 5, 7, 9.0)
    from nvfi_tpu.render.renderer import render_image as jrender_image
    want = jrender_image(_jp(tree), jmeta, 0.6, o, d, white_bg=True, chunk=16,
                         alpha_state={k: jnp.asarray(v) for k, v in state.items()})
    capsys.readouterr()
    got = harness.render_image(checkpoint.params_from_numpy(tree, "cpu"), tmeta, 0.6, o, d,
                               white_bg=True, chunk=16, device="cpu",
                               alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"))
    assert got["dropped"] == want["dropped"] > 0
    assert "WARNING" in capsys.readouterr().out
    for k in ("rgb", "acc", "depth"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _dataset():
    """Three 12x14 views of the scene, two keyframes and one between."""
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = [[0.2, 0.6, 4.5], [0.1, 0.4, 4.6], [0.3, 0.5, 4.4]]
    times = np.array([0.5, 0.6, 0.25], np.float32)
    images = np.random.RandomState(5).uniform(0, 1, (3, 12, 14, 3)).astype(np.float32)
    return ({"test": images}, {"test": poses}, {"test": times}, {"test": 3}, None, None,
            (12, 14, 11.0))


def test_render_split_with_a_sparse_budget_equals_the_dense_split_and_raises_on_a_drop():
    tree, _, tmeta = scene()
    tmeta = dataclasses.replace(tmeta, sample_block=SB)
    params = checkpoint.params_from_numpy(tree, "cpu")
    state = checkpoint.alpha_state_from_numpy(jax_mask()[0], "cpu")
    kw = dict(white_bg=True, chunk=64, alpha_state=state, device="cpu")
    dense, dense_err = harness.render_split(params, tmeta, _dataset(), "test", **kw)
    got, got_err = harness.render_split(params, tmeta, _dataset(), "test", sparse_budget=0.8,
                                        **kw)
    rtol, atol = TOL["rgb"]
    np.testing.assert_allclose(got, dense, rtol=rtol, atol=atol)
    assert np.std(dense) > 0.01
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got_err[k], dense_err[k], rtol=1e-4)
    with pytest.raises(RuntimeError, match="inexact eval render"):
        harness.render_split(params, tmeta, _dataset(), "test", sparse_budget=0.1, **kw)


# ---------------------------------------------------------------------------
# shade_reuse=False: where JAX's regather arm differs from the fused one
# ---------------------------------------------------------------------------

def test_regather_arm_differs_from_the_fused_one_in_bf16_and_is_refused():
    """JAX's regather arm (``shade_reuse=False``: density_feature, whose last
    product XLA keeps in f32, then app_feature) gives other bf16 values than
    its fused arm.  The port runs the fused arm: against JAX's fused bf16
    render at t = 0.6 it differs by 2.4e-7 (rgb) / 1.8e-7 (acc), against the
    regather arm by 9.5e-7 / 2.0e-6.  So the port refuses shade_reuse=False
    in bf16 (ROADMAP.md A6, the regather arm) instead of ignoring it."""
    tree, jmeta, tmeta = test_torch_render._scene()
    o, d = test_torch_render._rays()
    t = 0.6
    steps = jkplane.render_steps_for_time(jmeta, t)
    params = checkpoint.params_from_numpy(tree, "cpu")
    gaps = {}
    for reuse in (True, False):
        jm = dataclasses.replace(jmeta, compute_dtype="bfloat16", shade_reuse=reuse)
        want = _jax_render_fn(jm, steps)(_jp(tree), t=jnp.float32(t), rays_o=jnp.asarray(o),
                                         rays_d=jnp.asarray(d))
        got = kplane.render_rays(params, dataclasses.replace(tmeta, compute_dtype="bfloat16"),
                                 t, o, d, white_bg=True, adv_steps=steps, device="cpu")
        gaps[reuse] = {k: float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
                       for k in ("rgb", "acc")}
    assert gaps[True]["rgb"] <= 5e-7 and gaps[True]["acc"] <= 5e-7, gaps
    assert gaps[False]["rgb"] >= 6e-7 and gaps[False]["acc"] >= 1e-6, gaps
    for change in ({"compute_dtype": "bfloat16"}, {"shade_fraction": 0.25},
                   {"block_budget": 0.5}):
        with pytest.raises(NotImplementedError, match="regather arm"):
            kplane.render_rays(params, dataclasses.replace(tmeta, shade_reuse=False, **change),
                               t, o, d, white_bg=True, device="cpu")
    # in float32 and dense the two arms agree: the port accepts it
    kplane.render_rays(params, dataclasses.replace(tmeta, shade_reuse=False), t, o, d,
                       white_bg=True, device="cpu")

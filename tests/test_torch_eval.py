"""The alpha-mask eval path of nvfi_torch held against the JAX package on the
CPU: ``render_rays`` / ``render_image`` with a mask, ``render_split``, the
``alpha/`` arrays of a checkpoint both ways, and the copies of the metrics and
the depth colormap.

A threshold turns the dense alpha into the binary mask, so the two packages
may differ in a voxel whose alpha sits within rounding of the threshold.  The
render tests therefore hand both packages one and the same mask (built by the
JAX package, or synthetic with an aabb of its own), carried across with
``alpha_state_from_numpy``.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data import make_synthetic_scene
from nvfi_tpu.eval import harness as jharness
from nvfi_tpu.eval import metrics as jmetrics
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.render.renderer import render_image as jrender_image
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_tpu.utils import viz as jviz
from nvfi_torch.eval import harness, metrics
from nvfi_torch.fields import kplane
from nvfi_torch.ops import occupancy
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint
from nvfi_torch.utils import viz

from test_torch_occupancy import MASK_GRID, jax_mask, scene

# tolerances: MLP sums and the cumprod associate differently in XLA and torch
TOL = {"rgb": (1e-5, 1e-5), "acc": (1e-5, 1e-5), "depth": (1e-5, 1e-5), "weight": (1e-4, 1e-5)}


def _jparams(tree):
    return jax.tree.map(jnp.asarray, tree)


def _masks(kind):
    """'built': the JAX package's mask of the scene.  'shifted': a random
    binary volume in an aabb of its own, which prunes far more."""
    if kind == "built":
        return jax_mask()[0]
    rng = np.random.RandomState(7)
    gx, gy, gz = MASK_GRID
    vol = (rng.rand(gz, gy, gx) < 0.06).astype(np.float32)
    return {"volume": vol, "aabb": np.array([[-1.6, -1.2, -2.1], [1.7, 2.2, 1.0]], np.float32),
            "dilated": np.asarray(jkplane.corner_dilate(jnp.asarray(vol)))}


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


# a keyframe, between keyframes, past tmax (several RK2 steps)
@pytest.mark.parametrize("t", [0.5, 0.6, 0.95])
@pytest.mark.parametrize("mask", ["built", "shifted"])
def test_render_rays_with_mask_matches_jax(mask, t):
    tree, jmeta, tmeta = scene()
    state = _masks(mask)
    o, d = _rays()
    steps = jkplane.render_steps_for_time(jmeta, t)
    want = _jax_render_fn(jmeta, steps)(
        _jparams(tree), t=jnp.float32(t), rays_o=jnp.asarray(o), rays_d=jnp.asarray(d),
        alpha_state={k: jnp.asarray(v) for k, v in state.items()})
    params = checkpoint.params_from_numpy(tree, "cpu")
    got = kplane.render_rays(params, tmeta, t, o, d, white_bg=True, adv_steps=steps,
                             alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"),
                             device="cpu")
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    assert np.asarray(want["acc"]).mean() > 0.02
    # the mask prunes: the unmasked render has weight where the masked has none
    free = kplane.render_rays(params, tmeta, t, o, d, white_bg=True, adv_steps=steps,
                              device="cpu")
    pruned = (got["weight"] == 0) & (free["weight"] > 0)
    assert bool(pruned.any())
    if mask == "shifted":
        assert float((free["acc"] - got["acc"]).abs().max()) > 0.05


@pytest.mark.parametrize("t", [0.5, 0.6, 0.95])
def test_render_image_with_mask_matches_jax(t):
    """35 rays in chunks of 16: the padded last chunk goes through the mask
    lookup as well."""
    tree, jmeta, tmeta = scene()
    state = _masks("shifted")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, 0.4, 5.0]
    o, d = rays.ray_bundle(pose, 5, 7, 9.0)
    want = jrender_image(_jparams(tree), jmeta, t, o, d, white_bg=True, chunk=16,
                         alpha_state={k: jnp.asarray(v) for k, v in state.items()})
    got = render_image(checkpoint.params_from_numpy(tree, "cpu"), tmeta, t, o, d, white_bg=True,
                       chunk=16, alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"),
                       device="cpu")
    for k in ("rgb", "acc", "depth"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
    assert got["dropped"] == want["dropped"] == 0.0
    assert got["acc"].max() > 0.05


@functools.lru_cache(maxsize=None)
def _dataset():
    """Three 12x14 test views past and inside the training window."""
    return make_synthetic_scene(n_train=2, n_val=1, n_test=3, H=12, W=14, seed=0)


# 'given': both packages get the JAX-built mask.  'own': each builds its own
# (update_alpha): a voxel at the threshold may then differ, and with it a few
# samples whose alpha is about alphaMask_thres, so the images agree to 1e-3.
@pytest.mark.parametrize("mask", ["given", "own"])
def test_render_split_matches_jax(mask, tmp_path):
    tree, jmeta, tmeta = scene()
    dataset = _dataset()
    assert max(dataset[2]["test"]) > jmeta.tmax  # the split extrapolates
    state = jax_mask()[0] if mask == "given" else None
    want_preds, want_err = jharness.render_split(
        _jparams(tree), jmeta, dataset, "test", white_bg=True, chunk=64, alpha_grid=8,
        alpha_state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
    savedir = str(tmp_path / "imgs")
    got_preds, got_err = harness.render_split(
        checkpoint.params_from_numpy(tree, "cpu"), tmeta, dataset, "test", white_bg=True,
        chunk=64, alpha_grid=8, savedir=savedir, device="cpu",
        alpha_state=None if state is None else checkpoint.alpha_state_from_numpy(state, "cpu"))
    assert got_preds.shape == want_preds.shape == (3, 12, 14, 3)
    atol = 1e-5 if mask == "given" else 1e-3
    np.testing.assert_allclose(got_preds, want_preds, rtol=0, atol=atol)
    assert np.std(want_preds) > 0.01  # not a blank image
    for k in ("mse", "psnr", "ssim"):  # the metrics of images that agree to atol
        np.testing.assert_allclose(got_err[k], want_err[k], rtol=1e-4 if mask == "given" else 1e-2)
    assert sorted(os.listdir(savedir)) == sorted(
        [f"r_{i:03d}{s}.png" for i in range(3) for s in ("", "_depth")] + ["metrics.txt"])
    # max_views cuts the split
    two, _ = harness.render_split(
        checkpoint.params_from_numpy(tree, "cpu"), tmeta, dataset, "test", white_bg=True,
        chunk=64, update_alpha=False, max_views=2, device="cpu")
    assert two.shape[0] == 2


def test_render_split_refuses_what_is_not_ported():
    """Motion transfer (its own mask build included) and the head's params
    are ported: the split runs and matches JAX's, given the JAX-built
    transfer mask; so is NDC sampling, which runs here under transfer."""
    tree, jmeta, tmeta = scene()
    params = checkpoint.params_from_numpy(tree, "cpu")
    state, _ = jkplane.update_alpha_mask(_jparams(tree), jmeta, MASK_GRID, transfer=True)
    for kwargs in ({"transfer_vel": True}, {"mask_params": {}}):
        want, _ = jharness.render_split(_jparams(tree), jmeta, _dataset(), "test", white_bg=True,
                                        chunk=64, alpha_state=state, **kwargs)
        got, _ = harness.render_split(
            params, tmeta, _dataset(), "test", white_bg=True, chunk=64, device="cpu",
            alpha_state=checkpoint.alpha_state_from_numpy(
                {k: np.asarray(v) for k, v in state.items()}, "cpu"), **kwargs)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    harness.render_split(params, tmeta, _dataset(), "test", white_bg=True, chunk=64,
                         alpha_grid=4, device="cpu", transfer_vel=True, max_views=1)
    # NDC sampling (ROADMAP A3) under transfer runs (its split against JAX's:
    # tests/test_torch_ndc.py)
    got, _ = harness.render_split(params, dataclasses.replace(tmeta, ray_sampling="ndc"),
                                  _dataset(), "test", white_bg=True, chunk=64, alpha_grid=4,
                                  device="cpu", transfer_vel=True, max_views=1)
    assert got.shape[0] == 1 and np.isfinite(got).all()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_alpha_checkpoints_cross_both_ways(writer, tmp_path):
    tree, jmeta, tmeta = scene()
    state = jax_mask()[0]
    path = str(tmp_path / "model_00007")
    if writer == "jax":
        jcheckpoint.save(path, _jparams(tree), jmeta,
                         alpha_state={k: jnp.asarray(v) for k, v in state.items()})
        _, meta, opt_state, alpha_state, _ = checkpoint.load(path, device="cpu")
        assert opt_state is None and meta == tmeta
        assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
                   and v.is_contiguous() for k, v in alpha_state.items()
                   if k not in ("bits", "occupied"))
        # the cell bits of K3 are built on load, never read from the file
        assert torch.equal(alpha_state["bits"], occupancy.occupancy_bits(alpha_state["volume"]))
        alpha_state = checkpoint.alpha_state_to_numpy(alpha_state)
    else:
        checkpoint.save(path, checkpoint.params_from_numpy(tree, "cpu"), tmeta,
                        alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"))
        _, _, _, alpha_state, _ = jcheckpoint.load(path)
    assert sorted(alpha_state) == ["aabb", "dilated", "volume"]
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(alpha_state[k]), v)
    # find_checkpoint reads the directory as the JAX package does
    logdir = str(tmp_path)
    assert checkpoint.find_checkpoint(logdir) == jcheckpoint.find_checkpoint(logdir) == path
    assert checkpoint.find_checkpoint(logdir, step=7) == path
    assert checkpoint.find_checkpoint(logdir, step=3) == path  # missing: the latest
    assert checkpoint.find_checkpoint(str(tmp_path / "none")) is None
    # a checkpoint that carries no optimizer state loads none, with the mask
    # (the optimizer state's own round trip: tests/test_torch_train.py)
    params = checkpoint.params_from_numpy(tree, "cpu")
    checkpoint.save(path, params, tmeta, alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"))
    _, _, opt_state, again, _ = checkpoint.load(path, device="cpu")
    assert opt_state is None and sorted(again) == ["aabb", "bits", "dilated", "occupied",
                                                   "volume"]
    assert torch.equal(again["bits"], occupancy.occupancy_bits(again["volume"]))


@pytest.mark.parametrize("case", ["noisy", "equal", "gray"])
def test_metrics_match_jax(case):
    rng = np.random.RandomState(8)
    gt = rng.rand(2, 24, 20, 3).astype(np.float32)
    pred = {"noisy": np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1).astype(np.float32),
            "equal": gt.copy(), "gray": np.full_like(gt, 0.5)}[case]
    want, got = jmetrics.estim_error(pred, gt), metrics.estim_error(pred, gt)
    assert sorted(got) == ["mse", "psnr", "ssim"] and not metrics.lpips_available()
    for k in got:
        assert got[k] == want[k], k  # the same numpy code
    assert metrics.mse(pred, gt) == jmetrics.mse(pred, gt)
    assert metrics.psnr(pred[0], gt[0]) == jmetrics.psnr(pred[0], gt[0])
    assert metrics.ssim(pred[0, ..., 0], gt[0, ..., 0]) == jmetrics.ssim(pred[0, ..., 0],
                                                                         gt[0, ..., 0])
    for v in (0.0, 0.01):
        assert metrics.mse2psnr(v) == jmetrics.mse2psnr(v)


def test_metrics_save_error_and_depth_colormap_match_jax(tmp_path):
    errors = {"mse": 0.25, "psnr": 6.0}
    for mod, name in ((metrics, "t"), (jmetrics, "j")):
        os.makedirs(tmp_path / name)
        mod.save_error(errors, str(tmp_path / name), ext="_x")
    assert (tmp_path / "t" / "metrics_x.txt").read_text() == \
        (tmp_path / "j" / "metrics_x.txt").read_text()
    depth = np.random.RandomState(9).uniform(0, 7, (6, 5)).astype(np.float32)
    depth[0, 0] = np.nan
    for minmax in (None, (2.0, 6.0)):
        got, got_mm = viz.visualize_depth(depth, minmax)
        want, want_mm = jviz.visualize_depth(depth, minmax)
        np.testing.assert_array_equal(got, want)
        assert got_mm == want_mm

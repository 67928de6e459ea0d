"""The stage transitions of the port held against the JAX package on the CPU:
``ops.resize.resize_bilinear_ac``, ``kplane.upsample`` and ``kplane.shrink``
on carried params (a 'sur' velocity gate included), the L1 regularizer's
gradient at the time planes' start, and ``TrainHP.from_cfg`` for every
shipped config."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.config import load_config as jload_config
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.ops.resize import resize_bilinear_ac as jresize
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import load_config
from nvfi_torch.fields import kplane
from nvfi_torch.ops.resize import resize_bilinear_ac
from nvfi_torch.train import trainer
from nvfi_torch.train.checkpoint import params_from_numpy

from test_torch_occupancy import jax_mask, scene
from test_torch_train import _flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for p in glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
RESIZE_ATOL = 1e-7  # the same separable formula in f32: equal on the CPU so far


def _planes(tree):
    return [np.asarray(p) for p in tree["planes_space"] + tree["planes_time"]]


@pytest.mark.parametrize("shape", [(13, 17), (4, 5), (7, 9), (1, 20), (7, 1), (3, 9), (1, 1)])
def test_resize_bilinear_ac_matches_jax(shape):
    """Up, down, unchanged and size-1 axes, on a plane whose first axis is
    also size 1 (a single keyframe)."""
    rng = np.random.RandomState(sum(shape))
    for x in (rng.randn(7, 9, 5).astype(np.float32), rng.randn(1, 9, 3).astype(np.float32)):
        want = np.asarray(jresize(jnp.asarray(x), shape, (0, 1)))
        got = resize_bilinear_ac(torch.tensor(x), shape, (0, 1)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def _sur_scene():
    """Params of a small grid under chessboard_slow_turbo's nvfi block (the
    'sur' gate, 24 + 48 channels), in both packages."""
    path = os.path.join(REPO, "configs", "synth", "chessboard_slow_turbo.yaml")
    aabb = np.array([[-2.02] * 3, [2.02] * 3])
    metas = [mod.meta_from_cfg(load(path).nvfi, aabb, (11, 9, 8), (0.05, 3.6))
             for mod, load in ((jkplane, jload_config), (kplane, load_config))]
    tree = jax.tree.map(np.array, jkplane.init_params(jax.random.PRNGKey(3), metas[0]))
    rng = np.random.RandomState(4)
    for p in tree["planes_space"] + tree["planes_time"]:
        p += rng.uniform(-0.2, 0.2, p.shape).astype(np.float32)
    return tree, metas[0], metas[1]


@pytest.mark.parametrize("which", ["blob", "sur"])
def test_shrink_matches_jax_exactly(which):
    """The crop, the aabb snapped to the cropped voxels and the grid size
    equal JAX's bit for bit; a 'sur' gate is re-normalized to the new box
    as JAX does.  The new planes are contiguous leaves of their own."""
    if which == "blob":
        tree, jmeta, tmeta = scene()
        new_aabb = jax_mask()[1]
    else:
        tree, jmeta, tmeta = _sur_scene()
        new_aabb = np.array([[-1.31, -0.97, -1.55], [1.12, 1.63, 0.88]], np.float32)
        assert tmeta.vel_gate.mode == "sur"
    want_p, want_m = jkplane.shrink(jax.tree.map(jnp.asarray, tree), jmeta, new_aabb)
    params = params_from_numpy(tree, "cpu")
    got_p, got_m = kplane.shrink(params, tmeta, new_aabb)
    assert dataclasses.asdict(got_m) == dataclasses.asdict(want_m)
    assert got_m.grid_size != tmeta.grid_size and got_m.aabb != tmeta.aabb
    if which == "sur":
        assert got_m.vel_gate.bounds != tmeta.vel_gate.bounds
    for g, w in zip(got_p["planes_space"] + got_p["planes_time"], _planes(want_p)):
        assert g.is_contiguous() and g.is_leaf and g.requires_grad
        np.testing.assert_array_equal(g.detach().numpy(), w)
    assert got_p["shader"] is params["shader"]  # only the planes are new


@pytest.mark.parametrize("which", ["blob", "sur"])
def test_upsample_matches_jax(which):
    tree, jmeta, tmeta = scene() if which == "blob" else _sur_scene()
    res = (17, 12, 14) if which == "blob" else (20, 16, 21)
    kf = 6
    want_p, want_m = jkplane.upsample(jax.tree.map(jnp.asarray, tree), jmeta, res, kf)
    got_p, got_m = kplane.upsample(params_from_numpy(tree, "cpu"), tmeta, res, kf)
    assert dataclasses.asdict(got_m) == dataclasses.asdict(want_m)
    assert got_m.grid_size == res and got_m.num_keyframes == kf
    for g, w in zip(got_p["planes_space"] + got_p["planes_time"], _planes(want_p)):
        assert g.is_contiguous() and g.is_leaf and g.requires_grad and g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-6)


def test_density_l1_takes_jaxs_derivative_at_the_time_planes_start():
    """The time planes start as ones: |1 - p| at its kink, where JAX's
    derivative is +1 and torch.abs's 0.  The port's gradient equals JAX's."""
    tree, jmeta, tmeta = scene()
    tree = jax.tree.map(np.array, tree)
    for p in tree["planes_time"]:
        p[..., : tmeta.density_n_comp] = 1.0
    tree["planes_space"][0][0, 0, 0] = 0.0
    want = jax.grad(lambda p: jkplane.density_l1(p, jmeta))(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, "cpu")
    leaves = params["planes_space"] + params["planes_time"]
    for p in leaves:
        p.requires_grad_(True)
    kplane.density_l1(params, tmeta).backward()
    got = {"planes_space": [p.grad for p in params["planes_space"]],
           "planes_time": [p.grad for p in params["planes_time"]]}
    want = {k: want[k] for k in got}
    for (k, g), w in zip(_flat(got).items(), _flat(want).values()):
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got["planes_time"][0][..., : tmeta.density_n_comp] < 0).all()


def test_the_configs_are_the_shipped_nineteen():
    assert len(CONFIGS) == 19


@pytest.mark.parametrize("config", CONFIGS)
def test_train_hp_from_cfg_matches_jax(config):
    path = os.path.join(REPO, "configs", config)
    got = dataclasses.asdict(trainer.TrainHP.from_cfg(load_config(path)))
    want = dataclasses.asdict(jtrainer.TrainHP.from_cfg(jload_config(path)))
    assert got == want
    hp = trainer.TrainHP.from_cfg(load_config(path))
    assert trainer.exp_schedule(hp.n_voxel_init, hp.n_voxel_final, len(hp.upsamp_list)) == \
        jtrainer.exp_schedule(hp.n_voxel_init, hp.n_voxel_final, len(hp.upsamp_list))

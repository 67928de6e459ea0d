"""The port's multi-scene trainer (``nvfi_torch.parallel.multi_scene``) held
against the JAX package's on the CPU, in one process and split over two
``gloo`` ranks.

Four tiny scenes and the schedule of ``tests/test_multi_scene.py:83`` (64
rays, 24 samples, 16^3 -> 22^3 voxels, an alpha-mask event with the union
shrink after iteration 2, an upsample after 4), run through iteration 4 so
that both events fire.  Both trainers start from JAX's stacked params, each
scene's density planes given a block of density at a place of its own
(``nvfi.density_shift`` -30 keeps the empty space clear of the mask
threshold), so that each scene's mask and box differ and the union crops
the grid.  The port takes JAX's draws (a ``jax.random.split(k, 4)`` a step,
each scene's by the loss's key splits, ``test_torch_trainer._draws_for``)
and picks its frames with the same numpy generator.  Tolerances: the
per-scene losses within rtol 1e-4 and the masks within 2% of their voxels,
as the single-scene Trainer parity tests; the box and the grid equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data import make_synthetic_scene as jmake_synthetic_scene
from nvfi_tpu.data.synthetic import RigidSphere as JRigidSphere
from nvfi_tpu.parallel import multi_scene as jmulti
from nvfi_torch.config import CfgNode
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.data.synthetic import RigidSphere
from nvfi_torch.parallel import launch as launch_mod
from nvfi_torch.parallel import multi_scene, ranks
from nvfi_torch.train import checkpoint, trainer

from test_torch_train import _flat
from test_torch_trainer import _draws_for, _host
from test_train_e2e import small_cfg

N_SCENES = 4
ITERS = 5  # through the upsample after iteration 4
THREADS = 2
CFG = {"renderer.n_rays": 64, "experiment.vel_reg_n_pts": 64, "nvfi.max_n_samples": 24,
       "experiment.print_every": 2, "nvfi.N_voxel_init": 4096, "nvfi.N_voxel_final": 10648,
       "nvfi.upsamp_list": [4], "nvfi.update_AlphaMask_list": [2], "nvfi.density_shift": -30}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _objects(sphere, i):
    return [sphere(center=(0.6, 0, 0.2 * i), radius=0.45, color=(0.9 - 0.2 * i, 0.3, 0.2 + 0.2 * i),
                   omega=(0, 0, 1.0 + i))]


@functools.lru_cache(maxsize=None)
def _scenes():
    kw = dict(n_train=6, n_val=1, n_test=1, H=24, W=24)
    return ([jmake_synthetic_scene(objects=_objects(JRigidSphere, i), seed=i, **kw)
             for i in range(N_SCENES)],
            [make_synthetic_scene(objects=_objects(RigidSphere, i), seed=i, **kw)[:7]
             for i in range(N_SCENES)])


def _with_blocks(params):
    """Scene i's first density channel raised by 3.5 on each space plane
    inside a block of half-width 0.3 around its own centre (normalized
    coords), so that the product there is ~43: occupied."""
    out = jax.tree.map(np.array, params)
    for i, plane in enumerate(out["planes_space"]):
        S, h, w, _ = plane.shape
        v, u = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        for s in range(S):
            c = -0.3 + 0.2 * s
            plane[s, :, :, 0] += 3.5 * ((np.abs(u - c) < 0.3) & (np.abs(v - c / 2) < 0.3))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's MultiSceneTrainer one iteration at a time: the initial state,
    each step's draws by scene (numpy dicts) and per-scene losses, and the
    masks, meta and events after the run."""
    jcfg = small_cfg(**CFG)
    jtr = jmulti.MultiSceneTrainer(jcfg, _scenes()[0])
    jtr.params = jax.tree.map(jnp.asarray, _with_blocks(_host(jtr.params)))
    init = (_host(jtr.params), None)
    tcfg = CfgNode(jcfg.to_dict())
    hp = trainer.TrainHP.from_cfg(tcfg)
    draws, losses, grids = [], [], []
    for it in range(ITERS):
        _, k = jax.random.split(jtr.key)
        draws.append([ranks.draws_to_host(_draws_for(key, jtr.meta, hp, jtr.H, jtr.W))
                      for key in jax.random.split(k, N_SCENES)])
        losses.append(np.asarray(jtr.train(iters=it + 1)["loss"]))
        grids.append(tuple(jtr.meta.grid_size))
    masks = [{k: np.asarray(v) for k, v in jtr.scene_alpha_state(i).items()}
             for i in range(N_SCENES)]
    return {"cfg": tcfg.to_dict(), "init": init, "draws": draws, "losses": np.stack(losses),
            "grids": grids, "masks": masks, "meta": dataclasses.asdict(jtr.meta),
            "n_voxel_list": jtr.n_voxel_list}


@functools.lru_cache(maxsize=None)
def _port_one_process():
    want = _jax_run()
    return ranks.train_multi_scene(None, want["cfg"], _scenes()[1],
                                   {"iters": ITERS, "state": want["init"],
                                    "draws": want["draws"], "device": "cpu"})


def test_multi_scene_trainer_matches_jax_through_its_events():
    want, got = _jax_run(), _port_one_process()
    aabb0 = np.asarray(small_cfg().nvfi.bbox_x)
    # the events fired: a union crop smaller than the box, then the upsample
    assert [(e["it"], e["kind"]) for e in got["events"]] == [(2, "alpha"), (4, "upsample")]
    union = np.asarray(got["events"][0]["union"])
    assert (union[0] > aabb0[0] + 0.2).any() and (union[1] < aabb0[1] - 0.2).any()
    assert got["meta"] == want["meta"]  # the box, the grid, the keyframes
    assert want["grids"][2] != want["grids"][1] != want["grids"][4]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=1e-7)
    for i in range(N_SCENES):
        for k in ("volume", "dilated"):
            differ = got["alpha"][i][k] != want["masks"][i][k]
            assert differ.mean() < 0.02, (i, k, float(differ.mean()))
        np.testing.assert_array_equal(got["alpha"][i]["aabb"], want["masks"][i]["aabb"])
    # scene masks differ from one another: each scene keeps its own
    assert (got["alpha"][0]["volume"] != got["alpha"][3]["volume"]).mean() > 0.01
    assert np.all(got["counters"]["max_dropped_blocks"] == 0)


def test_scenes_split_over_two_ranks_equal_one_process():
    """Two gloo ranks, two scenes each: the same meta, events and masks as
    one process, the losses and params within rounding (no collective inside
    a step; the union box crosses the ranks with min / max; the CPU's
    kernels round a few elements 1 ulp apart in another process)."""
    want = _port_one_process()
    jax_run = _jax_run()
    out = launch_mod.launch(ranks.train_multi_scene, 2,
                            (jax_run["cfg"], _scenes()[1],
                             {"iters": ITERS, "state": jax_run["init"],
                              "draws": jax_run["draws"]}),
                            device="cpu", threads=THREADS, timeout=600)
    res = [o["result"] for o in out]
    assert [r["scenes"] for r in res] == [[0, 1], [2, 3]]
    for r in res:
        assert r["meta"] == want["meta"] and r["events"] == want["events"]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-6)
    for path, w in _flat(want["params"]).items():
        if w is None:
            continue
        got = np.concatenate([_flat(r["params"])[path] for r in res])
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7, err_msg=path)
    for i in range(N_SCENES):
        r = res[i // 2]
        for k, v in want["alpha"][i].items():
            np.testing.assert_array_equal(r["alpha"][i % 2][k], v)


def test_heterogeneous_boxes_translate_every_split():
    """Per-scene world boxes (``tests/test_multi_scene.py:50``): one canonical
    box of the largest extent, each scene's cameras in every split moved by
    its box's centre, as JAX's ``_translate_dataset``; the two scenes, one the
    other shifted by 5 in z, train to nearly the same losses."""
    cfg = CfgNode(small_cfg(**{"renderer.n_rays": 32, "experiment.vel_reg_n_pts": 32,
                               "nvfi.max_n_samples": 16}).to_dict())
    base = make_synthetic_scene(n_train=4, n_val=1, n_test=1, H=16, W=16)[:7]
    shifted_poses = {k: [np.array(p, np.float32) for p in v] for k, v in base[1].items()}
    for split in shifted_poses:
        for p in shifted_poses[split]:
            p[2, 3] += 5.0
    shifted = (base[0], shifted_poses) + tuple(base[2:])
    aabbs = [[[-2, -2, -2], [2, 2, 2]], [[-2, -2, 3], [2, 2, 7]]]
    tr = multi_scene.MultiSceneTrainer(cfg, [base, shifted], aabbs=aabbs, device="cpu")
    np.testing.assert_allclose(tr.scene_offset(0), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(tr.scene_offset(1), [0, 0, 5.0], atol=1e-6)
    assert tuple(np.asarray(tr.meta.aabb)[1]) == (2.0, 2.0, 2.0)
    for split in ("train", "val", "test"):
        want = jmulti.MultiSceneTrainer._translate_dataset(shifted, tr.scene_offset(1))[1][split]
        got = tr._translate_dataset(shifted, tr.scene_offset(1))[1][split]
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        # +5 then -5 in float32: within an ulp of 3
        np.testing.assert_allclose(np.stack(got), np.stack(base[1][split]), rtol=0, atol=5e-7)
    np.testing.assert_allclose(tr.poses_host[1], tr.poses_host[0], rtol=0, atol=5e-7)
    m = tr.train(iters=2)
    assert np.isfinite(m["loss"]).all()
    assert abs(m["loss"][0] - m["loss"][1]) < 0.5 * max(abs(m["loss"][0]), 1e-3)


def test_stacked_state_carries_across_both_ways():
    """JAX's stacked params and Adam state into the port and back bit for
    bit; ``stack_scenes`` / ``unstack_scenes`` mirror JAX's, and a scene's
    views write into the stacked storage (the in-place Adam update)."""
    scenes = [{"planes_space": [np.full((3, 2, 4), i, np.float32)],
               "basis_mat": {"w": np.full((4, 2), -i, np.float32), "b": None}}
              for i in range(3)]
    want = _host(jmulti.stack_scenes(jax.tree.map(jnp.asarray, scenes)))
    got = multi_scene.stack_scenes([checkpoint.params_from_numpy(s, "cpu") for s in scenes])
    for path, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[path], w)
    opt = {"m": jax.tree.map(lambda x: x + 1, want), "v": jax.tree.map(lambda x: x * 2, want),
           "step": np.array([3, 4, 5], np.int32)}
    params, state = checkpoint.multi_scene_state_from_numpy(want, opt, "cpu")
    assert state["step"] == [3, 4, 5]
    back_p, back_s = checkpoint.multi_scene_state_to_numpy(params, state)
    for a, b in ((back_p, want), (back_s["m"], opt["m"]), (back_s["v"], opt["v"])):
        for path, w in _flat(b).items():
            np.testing.assert_array_equal(_flat(a)[path], w)
    np.testing.assert_array_equal(back_s["step"], opt["step"])
    assert back_s["step"].dtype == np.int32
    views = multi_scene.unstack_scenes(params, 3)
    assert views[2]["basis_mat"]["b"] is None
    with torch.no_grad():
        views[1]["planes_space"][0].sub_(7.0)
    np.testing.assert_array_equal(params["planes_space"][0][1].numpy(), np.full((3, 2, 4), -6.0))
    np.testing.assert_array_equal(params["planes_space"][0][2].numpy(), np.full((3, 2, 4), 2.0))

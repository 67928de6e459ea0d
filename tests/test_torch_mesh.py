"""The port's data axis (``nvfi_torch.parallel``: the mesh, the launcher, the
data-parallel steps of ``Trainer(mesh=..., spmd=...)``) held against the JAX
package's meshed ``Trainer`` on the CPU.

The port's ranks are processes started by ``parallel.launch`` (two ``gloo``
ranks, two torch threads each) that run ``parallel.ranks.train_trainer``;
JAX runs on two of the virtual CPU devices of ``tests/conftest.py``.  Both
start from JAX's initial params, and the port takes JAX's draws: for the
automatic step every rank the whole batch's (the trainer's key chain, as
``test_torch_trainer.JaxDraws`` rebuilds it), for the explicit step each
rank those of ``jax.random.fold_in(k, rank)`` at the shard's sizes.  The
tiny scene of ``tests/test_train_e2e.py`` with 64 rays in 8 chunks of 8, so
that each rank renders chunks of its own.  Tolerances are those of the
single-process Trainer parity tests: the losses within rtol 1e-4, the
params on the elements whose gradient stays clear of rounding within 1e-2
of the learning rate.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax

from nvfi_tpu.data import make_synthetic_scene as jmake_synthetic_scene
from nvfi_tpu.parallel import make_mesh as jmake_mesh
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import CfgNode
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.fields import kplane
from nvfi_torch.parallel import launch as launch_mod
from nvfi_torch.parallel import mesh as mesh_mod
from nvfi_torch.parallel import ranks
from nvfi_torch.parallel.multi_scene import MultiSceneTrainer
from nvfi_torch.train import optim, trainer

from test_torch_train import _flat
from test_torch_trainer import _draws_for, _host
from test_train_e2e import small_cfg

RANKS = 2
ITERS = 3
THREADS = 2
CFG = {"renderer.n_rays": 64, "experiment.vel_reg_n_pts": 64, "nvfi.max_n_samples": 24,
       "renderer.batch_size": 256}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scenes():
    kw = dict(n_train=10, n_val=2, n_test=2, H=32, W=32)
    return jmake_synthetic_scene(**kw), make_synthetic_scene(**kw)


def _hp_meta():
    tcfg = CfgNode(small_cfg(**CFG).to_dict())
    tr = trainer.Trainer(tcfg, _scenes()[1], device="cpu")
    return tcfg, tr.hp, tr.meta


def _jax_run(spmd):
    """The JAX Trainer on a 2-device mesh, one iteration at a time: its
    initial params, losses, the params after each step and each step's key."""
    jscene = _scenes()[0]
    jtr = jtrainer.Trainer(small_cfg(**CFG), jscene, mode="static_dynamic",
                           mesh=jmake_mesh(RANKS), spmd=spmd)
    init = _host(jtr.params)
    key, _ = jax.random.split(jax.random.PRNGKey(0))  # small_cfg's seed, the init split
    keys, losses, params = [], [], []
    for it in range(ITERS):
        key, k_step = jax.random.split(key)
        keys.append(k_step)
        losses.append(float(jtr.train(iters=it + 1)["loss"]))
        params.append(_flat(_host(jtr.params)))
    return init, keys, losses, params


def _assert_steady_params_close(got, want, grads, lr_of):
    """The parity tests' limit on the elements whose gradient stays clear of
    rounding at every step (over 1e-3 of the leaf's largest and 10 x Adam's
    eps): within 1e-2 of the leaf's lr."""
    compared = 0
    for path, w in want.items():
        if w is None:
            continue
        steady = np.ones(w.shape, bool)
        for g in grads:
            v = g[path]
            steady &= (np.abs(v) > max(1e-3 * np.abs(v).max(), 10 * optim.EPS)) if v.any() \
                else np.zeros(w.shape, bool)
        compared += int(steady.sum())
        np.testing.assert_allclose(got[path][steady], w[steady], rtol=0, atol=1e-2 * lr_of(path),
                                   err_msg=path)
    assert compared > 1000, compared


def kplane_params(params):
    """A fresh copy of ``params`` whose leaves take gradients."""
    return kplane.map_params(lambda x: x.detach().clone().requires_grad_(True), params)


def grad_tree(params):
    return kplane.map_params(lambda x: x.grad, params)


def _port_run(spec):
    tcfg = _hp_meta()[0]
    return launch_mod.launch(ranks.train_trainer, RANKS, (tcfg.to_dict(), _scenes()[1][:7], spec),
                             device="cpu", threads=THREADS, timeout=600)


@pytest.mark.parametrize("spmd", ["auto", "shard_map"])
def test_data_parallel_step_matches_jax(spmd):
    """Two gloo ranks against JAX's meshed step (``make_train_step`` with a
    mesh, or ``make_train_step_shard_map``) after 2 and 3 iterations: the
    losses, the params, and both ranks' params equal bit for bit."""
    tcfg, hp, meta = _hp_meta()
    H, W = _scenes()[1][6][:2]
    assert trainer.ray_chunking(meta, hp) == (8, 8)
    init, keys, want_losses, want_params = _jax_run(spmd)
    if spmd == "auto":
        draws = [ranks.draws_to_host(_draws_for(k, meta, hp, H, W)) for k in keys]
    else:
        shard_hp = dataclasses.replace(hp, n_rays=hp.n_rays // RANKS,
                                       vel_reg_n_pts=hp.vel_reg_n_pts // RANKS)
        draws = [[ranks.draws_to_host(_draws_for(jax.random.fold_in(k, r), meta, shard_hp, H, W))
                  for r in range(RANKS)] for k in keys]
    out = _port_run({"iters": ITERS, "spmd": spmd, "params": init, "draws": draws,
                     "record": (2,), "all_grads": True})
    res = [o["result"] for o in out]
    assert res[0]["digests"] == res[1]["digests"] and len(set(res[0]["digests"])) == ITERS
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=1e-4, atol=1e-7)
    grads = [_flat(g) for g in res[0]["grads"]]

    def lr_of(path):
        return hp.lr_grid if path.startswith("planes") else (
            hp.lr_vel if path.startswith("vel") else hp.lr_net)

    after = {2: _flat(res[0]["recorded"][2]["before"]), 3: _flat(res[0]["params"])}
    for n_steps, got in after.items():
        _assert_steady_params_close(got, want_params[n_steps - 1], grads[:n_steps], lr_of)


def test_step_splits_the_chunks_and_each_term_once():
    """``chunk_share`` gives every chunk to one rank, in order; a rank's
    share of the loss carries its chunks, rank 0 the L1 / TV terms and the
    last rank the PDE term, and the shares sum to the whole loss."""
    assert [list(trainer.chunk_share(8, r, 3)) for r in range(3)] == [[0, 1, 2], [3, 4, 5],
                                                                       [6, 7]]
    assert [list(trainer.chunk_share(2, r, 3)) for r in range(3)] == [[0], [1], []]
    tcfg, hp, meta = _hp_meta()
    scene = _scenes()[1]
    H, W, focal = scene[6][:3]
    tr = trainer.Trainer(tcfg, scene, device="cpu")
    draws = trainer.draw_train_inputs(torch.Generator().manual_seed(3), meta, hp, H, W)
    args = (draws, 2, 0, 1, tr.poses_buf, tr.images_buf, tr.times_buf, tr.l1_base, 0.0, None)

    def part(share):
        params = kplane_params(tr.params)
        loss_fn = trainer.make_loss_fn(meta, hp, "static_dynamic", H, W, focal, device="cpu",
                                       share=share)
        loss, metrics = loss_fn(params, *args)
        return loss, metrics, params

    whole, whole_m, whole_p = part(None)
    shares = [part((r, RANKS)) for r in range(RANKS)]
    assert shares[0][1]["vel_pde"] == 0 and shares[1][1]["l1"] == 0
    assert float(shares[1][1]["tv_density"]) == 0 and float(shares[0][1]["tv_density"]) > 0
    np.testing.assert_allclose(sum(float(s[0]) for s in shares), float(whole), rtol=1e-6)
    for k, v in whole_m.items():
        np.testing.assert_allclose(sum(float(s[1][k]) for s in shares), float(v), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    for path, g in _flat(grad_tree(whole_p)).items():
        if g is None:
            continue
        parts = [_flat(grad_tree(s[2]))[path] for s in shares]
        total = sum(np.zeros_like(g) if p is None else p for p in parts)
        np.testing.assert_allclose(total, g, rtol=1e-5, atol=1e-6 * np.abs(g).max(),
                                   err_msg=path)


def test_launcher_replicates_and_shards_over_gloo_ranks():
    """``replicate`` gives every rank rank 0's values, ``shard_rays`` each
    rank its rows; a rank that raises fails the launch with its traceback."""
    out = launch_mod.launch(mesh_mod.replicate, RANKS, device="cpu", threads=1,
                            rank_args=[([torch.full((3,), float(r)),
                                         {"a": torch.arange(4) * (r + 1)}],)
                                       for r in range(RANKS)])
    for o in out:
        np.testing.assert_array_equal(o["result"][0], np.zeros(3, np.float32))
        np.testing.assert_array_equal(o["result"][1]["a"], np.arange(4))
        assert set(o["launches"].values()) == {0}
    out = launch_mod.launch(mesh_mod.shard_rays, RANKS, (torch.arange(8).reshape(4, 2),),
                            device="cpu", threads=1)
    np.testing.assert_array_equal(np.concatenate([o["result"] for o in out]),
                                  np.arange(8).reshape(4, 2))
    with pytest.raises(RuntimeError, match="3 rows do not divide over 2 ranks"):
        launch_mod.launch(mesh_mod.shard_rays, RANKS, (torch.arange(3),), device="cpu",
                          threads=1)


def test_launcher_refusals(monkeypatch):
    """More NCCL ranks than visible cards, a CPU run with shared_card, and a
    rank function outside the port are refused before a rank starts; without
    a card a CUDA launch raises."""
    with pytest.raises(RuntimeError, match="is_available"):
        launch_mod.launch(mesh_mod.shard_rays, 2, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 cards, 1 visible"):
        launch_mod.launch(mesh_mod.shard_rays, 2, device="cuda")
    with pytest.raises(ValueError, match="shared_card"):
        launch_mod.launch(mesh_mod.shard_rays, 2, device="cpu", shared_card=True)
    with pytest.raises(ValueError, match="not a function of nvfi_torch"):
        launch_mod.launch(np.sum, 2, device="cpu")


def test_model_axis_is_refused():
    """Since the model axis is ported, only ``spmd='shard_map'`` with it is
    refused (``test_torch_trainer.test_trainer_refuses_a_mesh``, where JAX
    asserts too).  A (D, M) mesh puts rank r at data index r // M and model
    index r % M, as JAX reshapes its devices; ``shard_scene_params`` gives
    model rank m channels [m C / M, (m + 1) C / M) of every plane, keeps the
    other leaves whole, and replicates planes whose C does not divide M;
    ``MultiSceneTrainer`` splits its scenes over the data axis alone."""
    mesh = mesh_mod.Mesh(None, 3, 4, torch.device("cpu"), ("data", "model"), (2, 2),
                         (None, None))
    assert mesh.shape == {"data": 2, "model": 2}
    assert [(mesh_mod.Mesh(None, r, 6, None, ("data", "model"), (3, 2)).index("data"),
             mesh_mod.Mesh(None, r, 6, None, ("data", "model"), (3, 2)).index("model"))
            for r in range(6)] == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    sub = mesh.sub("model")
    assert (sub.rank, sub.size, sub.axis_names) == (1, 2, ("model",))
    assert mesh_mod.channel_slice(mesh, 72) == (36, 72)
    assert mesh_mod.channel_slice(mesh, 9) is None  # 9 channels do not divide 2: whole
    assert mesh_mod.channel_slice(mesh.sub("data"), 72) is None
    planes = torch.arange(2 * 3 * 12, dtype=torch.float32).reshape(2, 3, 12)
    params = {"planes_space": [planes], "planes_time": [planes + 1000],
              "basis_mat": {"w": torch.ones(8, 4)}}
    out = launch_mod.launch(mesh_mod.shard_scene_params, 4, (params,), device="cpu", threads=1,
                            model_axis=2)
    for r, o in enumerate(out):
        lo = 6 * (r % 2)
        np.testing.assert_array_equal(o["result"]["planes_space"][0], planes[..., lo:lo + 6])
        np.testing.assert_array_equal(o["result"]["planes_time"][0],
                                      planes[..., lo:lo + 6] + 1000)
        np.testing.assert_array_equal(o["result"]["basis_mat"]["w"], np.ones((8, 4)))
    with pytest.raises(ValueError, match=r"4 ranks \(model axis 3\)"):
        launch_mod.launch(mesh_mod.shard_scene_params, 4, (params,), device="cpu",
                          model_axis=3)
    tr = MultiSceneTrainer(CfgNode(small_cfg().to_dict()), [_scenes()[1]] * 2,
                           mesh=mesh_mod.Mesh(None, 1, 2, torch.device("cpu"),
                                              ("data", "model"), (1, 2)), device="cpu")
    assert list(tr.scenes) == [0, 1]
    with pytest.raises(AssertionError, match="not divisible by 3 devices"):
        trainer.shard_sizes(trainer.TrainHP(n_rays=64), None, 3)

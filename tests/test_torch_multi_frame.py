"""Multi-frame ray batches (``experiment.multi_frame_batch``) in the port's
train step and stage loop, held against the JAX package on the CPU.

In a multi-frame batch every ray comes from a frame of its own: JAX splits
the batch's key three ways, ``k_f, k_pix, k_render``, draws the frame of each
ray from the batch's pool and its pixel with replacement
(``nvfi_tpu/train/trainer.py:236-252``).  Those draws are rebuilt here from
the same key splits and handed to the port as a ``TrainDraws``; the chunk
jitter comes from ``k_render`` of the three-way split.  The pool holds seven
frames at distinct times from seven poses (the keyframes 0, 0.25, 0.5, 0.75
of K = 4 and three times between them), so a chunk mixes keyframe snaps and
RK2 offsets of both signs.  The scene and its mask are
``test_torch_occupancy``'s; the tolerances are the train slice's
(``test_torch_train``).  Two JAX loss configurations are jitted: the dense
loss, and the pruned loss under a turbo budget small enough to drop blocks.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import CfgNode
from nvfi_torch.fields import kplane
from nvfi_torch.train import checkpoint, optim, trainer

from test_torch_occupancy import jax_mask, scene
from test_torch_train import HP, _assert_trees_close, _flat, _pde_draws, _tp
from test_torch_trainer import _host, _scenes
from test_train_e2e import small_cfg

H = W = 8
FOCAL = 6.0
TIMES = np.array([0.0, 0.1, 0.25, 0.4, 0.5, 0.6, 0.75], np.float32)
POOL_KEY = np.array([0, 2, 4, 6])  # the frames at a keyframe time
MHP = {**HP, "multi_frame": True}
# the turbo arm: blocks of 12 pad 32 samples to 36; under a budget below 0.5
# a chunk holds all 32 rays (96 blocks), of which B = 32 run: the mask leaves
# more active, so blocks are dropped; the top-K shade keeps 16 samples a ray
TURBO = dict(train_occupancy_prune=True, sample_block=12, block_budget=0.3,
             shade_fraction=0.25)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _dataset():
    """Seven frames: cameras above the box looking down -z, each at its own
    position and turned about z by its own angle."""
    rng = np.random.RandomState(61)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(TIMES), 1, 1))
    for f, a in enumerate(np.linspace(-0.6, 0.6, len(TIMES))):
        c, s = np.cos(a), np.sin(a)
        poses[f, :2, :2] = [[c, -s], [s, c]]
        poses[f, :3, 3] = [0.3 + 0.1 * np.sin(3 * f), 0.4 + 0.1 * np.cos(2 * f), 4.0 + 0.05 * f]
    images = rng.uniform(0, 1, (len(TIMES), H, W, 3)).astype(np.float32)
    return poses, images, TIMES


def _metas(turbo):
    _, jmeta, tmeta = scene()
    if turbo:
        return dataclasses.replace(jmeta, **TURBO), dataclasses.replace(tmeta, **TURBO)
    return jmeta, tmeta


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(turbo):
    jmeta, _ = _metas(turbo)
    loss_fn = jtrainer.make_loss_fn(jmeta, jtrainer.TrainHP(**MHP), "static_dynamic", H, W,
                                    FOCAL, use_alpha=turbo)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def multi_frame_draws(key, tmeta, hp, pool_all, pool_key, H, W):
    """The draws of JAX's multi-frame loss for ``key``, by its key splits."""
    ray_chunk, n_chunks = trainer.ray_chunking(tmeta, hp)
    keys = jax.random.split(key, 4)

    def batch(k, pool):
        k_f, k_pix, k_render = jax.random.split(k, 3)
        pool = np.asarray(pool)
        frames = pool[np.asarray(jax.random.randint(k_f, (hp.n_rays,), 0, len(pool)))]
        pix = np.asarray(jax.random.randint(k_pix, (hp.n_rays,), 0, H * W))
        chunk_keys = [k_render] if n_chunks == 1 else jax.random.split(k_render, n_chunks)
        jitter, coins = [], []
        for ck in chunk_keys:
            k_strat, k_bg = jax.random.split(ck)
            jitter.append(np.asarray(jax.random.uniform(k_strat, (ray_chunk, 1), jnp.float32)))
            coins.append(bool(jax.random.uniform(k_bg, ()) < 0.5))
        return (torch.tensor(frames, dtype=torch.int64), torch.tensor(pix, dtype=torch.int64),
                torch.tensor(np.stack(jitter)), coins)

    frames_t, pix_t, jitter_t, coin_t = batch(keys[0], pool_all)
    frames_0, pix_0, jitter_0, coin_0 = batch(keys[1], pool_key)
    points, times_u, noise = _pde_draws(keys[2], hp.vel_reg_n_pts)
    kv1, kv2 = jax.random.split(keys[3])
    probe_x = np.asarray(jax.random.uniform(kv1, (2048, 3), minval=-1.0, maxval=1.0))
    probe_t = np.asarray(jax.random.uniform(kv2, (2048, 1)))
    return trainer.TrainDraws(pix_t, pix_0, jitter_t, jitter_0, coin_t, coin_0, points, times_u,
                              noise, torch.tensor(probe_x), torch.tensor(probe_t),
                              frames_t=frames_t, frames_0=frames_0)


@pytest.mark.parametrize("turbo", [False, True], ids=["dense", "turbo"])
def test_multi_frame_loss_matches_jax(turbo, monkeypatch):
    tree, _, _ = scene()
    jmeta, tmeta = _metas(turbo)
    hp = trainer.TrainHP(**MHP)
    poses, images, times = _dataset()
    key, step = jax.random.PRNGKey(71), 5
    pool_all = np.arange(len(times))
    state = jax_mask()[0] if turbo else None
    (want_loss, want_metrics), want_grads = _jax_grad_fn(turbo)(
        jax.tree.map(jnp.asarray, tree), key, jnp.int32(1), jnp.int32(0), jnp.int32(step),
        jnp.asarray(poses), jnp.asarray(images), jnp.asarray(times), jnp.asarray(pool_all),
        jnp.asarray(POOL_KEY), jnp.float32(HP["L1_weight_initial"]), jnp.float32(0.0),
        None if state is None else {k: jnp.asarray(v) for k, v in state.items()})

    draws = multi_frame_draws(key, tmeta, hp, pool_all, POOL_KEY, H, W)
    chunk, n_chunks = trainer.ray_chunking(tmeta, hp)
    assert (chunk, n_chunks) == ((32, 1) if turbo else (16, 2))
    # a chunk of the random-time batch mixes frames, times and repeated pixels
    first = draws.frames_t[:chunk].numpy()
    assert len(np.unique(times[first])) >= 4 and np.isin(draws.frames_0, POOL_KEY).all()

    # every sample's keyframe snap sees its own ray's time
    snapped, snap = [], kplane.snap_to_keyframe
    monkeypatch.setattr(kplane, "snap_to_keyframe",
                        lambda meta, t: snapped.append(t.detach().clone()) or snap(meta, t))
    loss_fn = trainer.make_loss_fn(tmeta, hp, "static_dynamic", H, W, FOCAL, use_alpha=turbo,
                                   device="cpu")
    params = _tp(tree, grad=True)
    loss, metrics = loss_fn(params, draws, 1, 0, step, torch.tensor(poses),
                            torch.tensor(images), torch.tensor(times), HP["L1_weight_initial"],
                            0.0, None if state is None else
                            checkpoint.alpha_state_from_numpy(state, "cpu"))
    rays_t = [s for s in snapped if s.dim() == 3][:n_chunks]  # the random-time batch's
    want_t = torch.tensor(times)[draws.frames_t].reshape(n_chunks, chunk)
    assert len(rays_t) == n_chunks
    for c, t in enumerate(rays_t):
        assert torch.equal(t[..., 0], want_t[c][:, None].expand(chunk, t.shape[1])), c

    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k, w in want_metrics.items():
        # rtol 1e-4: the PDE's Jacobian sums (test_torch_train)
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4, atol=1e-7, err_msg=k)
    grads = kplane.map_params(lambda p: p.grad, params)
    assert _assert_trees_close(grads, want_grads) == 6 + 1 + 6 + 24
    if turbo:
        # the runtime certificate: JAX's count of the active blocks the budget
        # dropped, equal, and not zero at this budget
        assert float(metrics["dropped_blocks"]) == float(want_metrics["dropped_blocks"]) > 0
        assert float(metrics["dropped_shade"]) == float(want_metrics["dropped_shade"])
    else:
        assert float(metrics["dropped_blocks"]) == 0.0


def test_multi_frame_draws_on_the_device_follow_the_pools():
    """``draw_train_inputs`` draws each batch's frames from its pool and its
    pixels with replacement; a single-frame batch draws as before (distinct
    pixels, no frames)."""
    _, tmeta = _metas(False)
    hp = trainer.TrainHP(**{**MHP, "n_rays": 64})
    gen = torch.Generator().manual_seed(3)
    draws = trainer.draw_train_inputs(gen, tmeta, hp, H, W, pool_all=torch.arange(7),
                                      pool_key=POOL_KEY)
    assert set(draws.frames_t.tolist()) <= set(range(7)) and len(set(draws.frames_t.tolist())) > 3
    assert set(draws.frames_0.tolist()) <= set(POOL_KEY.tolist())
    assert len(set(draws.pix_t.tolist())) < 64 <= H * W  # 64 of 64 with replacement repeat
    with pytest.raises(ValueError, match="pool"):
        trainer.draw_train_inputs(gen, tmeta, hp, H, W)
    single = trainer.draw_train_inputs(gen, tmeta, trainer.TrainHP(**HP), H, W)
    assert single.frames_t is None and len(set(single.pix_t.tolist())) == HP["n_rays"]


ITERS = 4
TRAINER_CFG = {"experiment.multi_frame_batch": True, "experiment.train_iters": ITERS,
               "nvfi.N_voxel_init": 4096, "nvfi.N_voxel_final": 4096, "renderer.n_rays": 128}


class JaxMultiDraws:
    """``Trainer(draws=...)``: each step's multi-frame draws from the JAX
    trainer's key chain, with the port trainer's pools."""

    def __init__(self, seed, H, W):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))  # the init split
        self.H, self.W, self.trainer = H, W, None

    def __call__(self, step, meta, hp):
        self.key, k_step = jax.random.split(self.key)
        tr = self.trainer
        return multi_frame_draws(k_step, meta, hp, np.arange(tr.counts[tr.split]),
                                 tr._keyframe_frames(), self.H, self.W)


def test_trainer_with_multi_frame_batches_matches_jax():
    """Both Trainers, from JAX's initial params, four iterations with
    ``experiment.multi_frame_batch true``; the params after them within
    ``test_torch_trainer``'s limit (1e-2 lr) on the elements whose gradient
    stays clear of rounding noise at every step."""
    jscene, tscene = _scenes()
    jcfg = small_cfg(**TRAINER_CFG)
    tcfg = CfgNode(jcfg.to_dict())
    jtr = jtrainer.Trainer(jcfg, jscene, mode="static_dynamic")
    assert jtr.hp.multi_frame
    H_, W_ = jscene[6][:2]
    draws = JaxMultiDraws(0, H_, W_)
    ttr = trainer.Trainer(tcfg, tscene, mode="static_dynamic", device="cpu", draws=draws)
    draws.trainer = ttr
    ttr.params = checkpoint.params_from_numpy(_host(jtr.params), "cpu")
    grads, apply_updates = [], optim.apply_updates

    def recording(params, g, *args, **kwargs):
        grads.append(_flat(g))
        return apply_updates(params, g, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optim, "apply_updates", recording)
        jtr.train(iters=ITERS)
        ttr.train(iters=ITERS)
    assert ttr.global_step == jtr.global_step == ITERS and len(grads) == ITERS
    steady = None
    for g in grads:
        clear = {k: np.zeros(v.shape, bool) if not v.any()
                 else np.abs(v) > max(1e-3 * np.abs(v).max(), 10 * optim.EPS)
                 for k, v in g.items() if v is not None}
        steady = clear if steady is None else {k: steady[k] & clear[k] for k in clear}
    got, want = _flat(ttr.params), _flat(_host(jtr.params))
    compared = 0
    for path, keep in steady.items():
        if not keep.any():
            continue
        compared += int(keep.sum())
        lr = ttr.hp.lr_grid if path.startswith("planes") else ttr.hp.lr_net
        np.testing.assert_allclose(got[path][keep], want[path][keep], rtol=0, atol=1e-2 * lr,
                                   err_msg=path)
    assert compared > 2000

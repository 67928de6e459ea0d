"""The port's model axis (``('data', 'model')`` meshes: channel-sharded
planes, ``kplane.ChannelShard``) held against the JAX package on the CPU.

Without a process group, each channel slice's partials (``field_partials``,
``density_partial`` and the regularizers inside ``kplane.channel_shard``
with no reduction), summed over the slices through the plain versions, are
held to JAX's ``field_features``, ``density_feature``, ``density_l1`` and
``tv_loss_*`` and to their ``jax.vjp``, at M = 2, 3 and 4 slices of 12
channels (4 density + 8 app): M = 3 gives a slice without app channels, and
every M slices without density channels.  Then four ``gloo`` ranks on a
(2, 2) mesh (one launch, one torch thread a rank) train
``tests/test_train_e2e.py``'s tiny scene for 3 ``auto`` steps through an
alpha event, its shrink and an upsample, as JAX's
``Trainer(mesh=make_mesh(4, model_axis=2))`` trains it
(``tests/test_round4.py:189``), from JAX's params and draws, within
``tests/test_torch_mesh.py``'s tolerances; rank 0's checkpoint loads in JAX
and in one process; and ``MultiSceneTrainer`` on the same mesh equals one
process.  The Trainer run passes a ``val_fn``, which rank 0 runs on the
gathered whole planes.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data import make_synthetic_scene as jmake_synthetic_scene
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.parallel import make_mesh as jmake_mesh
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import CfgNode
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.fields import kplane
from nvfi_torch.parallel import launch as launch_mod
from nvfi_torch.parallel import mesh as mesh_mod
from nvfi_torch.parallel import ranks
from nvfi_torch.render import rays as rays_mod
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint, optim, trainer

from test_torch_occupancy import META
from test_torch_trainer import _carry_mask, _draws_for, _host
from test_torch_train import _flat
from test_train_e2e import small_cfg

BF16 = torch.bfloat16
CD, CA = 4, 8  # 12 channels: slices of 6, 4 and 3
LOOKUP_META = dict(META, density_n_comp=CD, app_n_comp=CA)
RANKS, MODEL_AXIS, ITERS = 4, 2, 3
# the tiny scene of tests/test_round4.py:189 with an alpha event (and its
# shrink) and the upsample to the final grid after iteration 1
CFG = {"renderer.n_rays": 64, "experiment.vel_reg_n_pts": 64, "nvfi.max_n_samples": 16,
       "renderer.batch_size": 128, "nvfi.N_voxel_init": 4096, "nvfi.N_voxel_final": 16384,
       "nvfi.upsamp_list": [1], "nvfi.update_AlphaMask_list": [1],
       "experiment.train_iters": ITERS}


def _slices(m):
    width = (CD + CA) // m
    return [(i * width, (i + 1) * width) for i in range(m)]


@functools.lru_cache(maxsize=None)
def _lookup_scene(mode):
    """JAX params (numpy) at 12 channels with a density blob and non-trivial
    time planes, the two metas, and coords."""
    jmeta = jkplane.KPlaneMeta(**LOOKUP_META, density_mode=mode)
    tree = jax.tree.map(np.array, jkplane.init_params(jax.random.PRNGKey(3), jmeta))
    rng = np.random.RandomState(3)
    for p in tree["planes_space"] + tree["planes_time"]:
        p += (0.2 * rng.randn(*p.shape)).astype(np.float32)
    xyzt = rng.uniform(-1.1, 1.1, (500, 4)).astype(np.float32)
    return tree, jmeta, kplane.KPlaneMeta(**LOOKUP_META, density_mode=mode), xyzt


def _slice_params(tree, lo, hi, dtype_meta):
    """The port's params of one slice: planes ``[lo, hi)``, leaves that take
    gradients, the non-plane leaves cast as the render casts them."""
    params = checkpoint.params_from_numpy(tree, "cpu")
    params = mesh_mod.slice_planes(params, lo, hi)
    params = kplane.map_params(lambda x: x.detach().clone().requires_grad_(True), params)
    return params, kplane.cast_compute(params, dtype_meta)


@functools.lru_cache(maxsize=None)
def _jax_lookups(mode, dtype):
    """JAX's field_features and density_feature, and the VJP of the first
    for seeded cotangents (jitted: in bf16 XLA's fusions decide where it
    rounds).  Returns the cotangents too."""
    tree, jmeta, _, xyzt = _lookup_scene(mode)
    jmeta = dataclasses.replace(jmeta, compute_dtype=dtype)
    rng = np.random.RandomState(5)
    g_density = rng.randn(len(xyzt), 1 if mode == "Density" else 2).astype(np.float32)
    g_app = rng.randn(len(xyzt), jmeta.app_dim).astype(np.float32)

    def ff(p, x):
        d, a = jkplane.field_features(jkplane.cast_compute(p, jmeta), jmeta, x)
        return d, a.astype(jnp.float32)

    jp = jax.tree.map(jnp.asarray, tree)
    # the values of the render's own jit (the app feature in the compute dtype)
    d, a = jax.jit(lambda p, x: jkplane.field_features(jkplane.cast_compute(p, jmeta), jmeta,
                                                       x))(jp, jnp.asarray(xyzt))
    a = np.asarray(a, np.float32)
    _, vjp = jax.vjp(jax.jit(ff), jp, jnp.asarray(xyzt))
    gp, gx = vjp((jnp.asarray(g_density), jnp.asarray(g_app)))
    raw = jax.jit(lambda p, x: jkplane.density_feature(p, jmeta, x))(jp, jnp.asarray(xyzt))
    return (g_density, g_app, np.asarray(d), np.asarray(a), np.asarray(raw),
            _flat(jax.tree.map(np.asarray, gp)), np.asarray(gx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["Density", "DensityLinear"])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_slice_partials_sum_to_jax_lookups_and_grads(m, mode, dtype):
    """``field_partials`` and ``density_partial`` of the M slices, summed (the
    app sum rounded to the compute dtype once), against JAX's
    ``field_features`` / ``density_feature``; their gradients through the
    sum against JAX's VJP: the planes (each slice's rows of them), the
    bases (each slice's rows) and the coords (the slices' shares summed)."""
    tree, _, tmeta, xyzt = _lookup_scene(mode)
    tmeta = dataclasses.replace(tmeta, compute_dtype=dtype)
    dd = 1 if mode == "Density" else 2
    g_density, g_app, want_d, want_a, want_raw, want_gp, want_gx = _jax_lookups(mode, dtype)
    x = torch.tensor(xyzt, requires_grad=True)
    dens, app, raw, leaves = 0.0, 0.0, 0.0, []
    shards = [kplane.ChannelShard(lo, hi, CD + CA) for lo, hi in _slices(m)]
    assert any(s.density_channels(tmeta) == 0 for s in shards)
    assert m != 3 or shards[0].app_rows(tmeta) == slice(0, 0)
    for shard in shards:
        params, cast = _slice_params(tree, shard.lo, shard.hi, tmeta)
        d, a = kplane.field_partials(cast, tmeta, x, shard)
        assert d.dtype == a.dtype == torch.float32 and d.shape[-1] == dd
        dens, app = dens + d, app + a
        with torch.no_grad():
            raw = raw + kplane.density_partial(params, tmeta, x.detach(), shard)
        leaves.append((shard, params))
    app = app.to(kplane._compute_dtype(tmeta))
    torch.autograd.backward([dens, app.float()], [torch.tensor(g_density),
                                                  torch.tensor(g_app).to(app.dtype).float()])
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(dens.detach().numpy(), want_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(raw.numpy(), want_raw, rtol=1e-5, atol=1e-6)
    if bf16:  # one rounding of the f32 sum against XLA's bf16 dot: within 1 bf16 ulp
        np.testing.assert_allclose(app.detach().float().numpy(), want_a, rtol=2 ** -7, atol=1e-6)
        assert (app.detach().float().numpy() == want_a).mean() > 0.99
    else:
        np.testing.assert_allclose(app.detach().numpy(), want_a, rtol=1e-5, atol=1e-6)
    # the grads: bf16 within the bf16 limits of PERF.md section 2 (the slices'
    # running bf16 channel sums end at other channels), f32 within rounding
    rtol, atol_rel = (2e-2, 2e-2) if bf16 else (1e-4, 1e-5)

    def close(got, want, what):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max(),
                                   err_msg=what)

    close(x.grad.numpy()[:, :3], want_gx[:, :3], "xyz")
    for key in ("planes_space", "planes_time"):
        for i in range(3):
            got = np.concatenate([p[key][i].grad.numpy() for _, p in leaves], -1)
            close(got, want_gp[f"{key}/{i}"], f"{key}/{i}")
    for key, rows in (("basis_mat", "app_rows"), ("basis_mat_density", "density_rows")):
        if mode == "Density" and key == "basis_mat_density":
            continue
        got = sum(p[key]["w"].grad.numpy() for _, p in leaves)
        for shard, p in leaves:  # a slice's grad lies in its rows alone
            outside = np.ones(len(got), bool)
            outside[getattr(shard, rows)(tmeta)] = False
            assert not p[key]["w"].grad.numpy()[outside].any()
        close(got, want_gp[f"{key}/w"], key)


@functools.lru_cache(maxsize=None)
def _jax_regularizer(name):
    tree, jmeta, _, _ = _lookup_scene("Density")
    value, grads = jax.jit(jax.value_and_grad(lambda p: getattr(jkplane, name)(p, jmeta)))(
        jax.tree.map(jnp.asarray, tree))
    return float(value), _flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("m", [2, 3, 4])
def test_sliced_regularizers_sum_to_jax(m):
    """``density_l1``, ``tv_loss_density`` and ``tv_loss_app`` inside
    ``channel_shard`` (no reduction: the slice's partial over the whole
    counts), summed over the slices, against JAX's values and gradients."""
    tree, _, tmeta, _ = _lookup_scene("Density")
    for name in ("density_l1", "tv_loss_density", "tv_loss_app"):
        want, want_g = _jax_regularizer(name)
        total, grads = 0.0, []
        for lo, hi in _slices(m):
            params, _ = _slice_params(tree, lo, hi, tmeta)
            with kplane.channel_shard(kplane.ChannelShard(lo, hi, CD + CA, lambda t: None)):
                value = getattr(kplane, name)(params, tmeta)
            value.backward()
            total = total + float(value)
            grads.append(params)
        np.testing.assert_allclose(total, want, rtol=1e-5, err_msg=name)
        for key in ("planes_space", "planes_time"):
            for i in range(3):
                got = np.concatenate([np.zeros(p[key][i].shape, np.float32)
                                      if p[key][i].grad is None else p[key][i].grad.numpy()
                                      for p in grads], -1)
                np.testing.assert_allclose(got, want_g[f"{key}/{i}"], rtol=1e-5,
                                           atol=1e-6 * np.abs(want_g[f"{key}/{i}"]).max(),
                                           err_msg=f"{name} {key}/{i}")


def test_sliced_planes_refuse_a_whole_lookup():
    """A plane slice read outside its shard would read as a narrower field."""
    tree, _, tmeta, xyzt = _lookup_scene("Density")
    params, _ = _slice_params(tree, 0, 6, tmeta)
    with pytest.raises(ValueError, match="outside|inside kplane.channel_shard"):
        kplane.field_features(params, tmeta, torch.tensor(xyzt))
    with pytest.raises(ValueError, match="channel_shard"):
        kplane.density_feature(params, tmeta, torch.tensor(xyzt))


# ---------------------------------------------------------------------------
# Four gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scenes():
    kw = dict(n_train=4, n_val=1, n_test=1, H=16, W=16)
    return jmake_synthetic_scene(**kw), make_synthetic_scene(**kw)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's model-axis Trainer one iteration at a time: its initial params,
    each step's draws (from its key chain, at the meta of that step), the
    losses and params after each step, the meta after each."""
    jtr = jtrainer.Trainer(small_cfg(**CFG), _scenes()[0], mode="static_dynamic",
                           mesh=jmake_mesh(RANKS, model_axis=MODEL_AXIS))
    assert "model" in str(jtr.params["planes_space"][0].sharding.spec)
    init = _host(jtr.params)
    hp = trainer.TrainHP.from_cfg(CfgNode(small_cfg(**CFG).to_dict()))
    key, _ = jax.random.split(jax.random.PRNGKey(0))  # small_cfg's seed, the init split
    draws, losses, params, metas = [], [], [], []
    for it in range(ITERS):
        key, k_step = jax.random.split(key)
        draws.append(ranks.draws_to_host(_draws_for(k_step, jtr.meta, hp, jtr.H, jtr.W)))
        losses.append(float(jtr.train(iters=it + 1)["loss"]))
        params.append(_flat(_host(jtr.params)))
        metas.append(dataclasses.asdict(jtr.meta))
    return {"init": init, "draws": draws, "losses": losses, "params": params, "metas": metas,
            "hp": hp}


VALIDATE_EVERY = 2  # the last step's: its params are the run's final params


def _val_view():
    """The tiny scene's val view: its rays (H, W, 3) and time."""
    imgs, poses, times, _, _, _, (H, W, focal) = _scenes()[1][:7]
    o, d = rays_mod.ray_bundle(poses["val"][0], int(H), int(W), float(focal))
    return {"rays_o": o, "rays_d": d, "t": float(times["val"][0]), "white_bg": True}


MULTI_SCENES, MULTI_ITERS = 4, 2
MULTI_CFG = {"renderer.n_rays": 32, "experiment.vel_reg_n_pts": 32, "nvfi.max_n_samples": 16}


def _multi_scenes():
    return [make_synthetic_scene(n_train=4, n_val=1, n_test=1, H=16, W=16, seed=s)[:7]
            for s in range(MULTI_SCENES)]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One launch of four ranks on the (2, 2) mesh: the Trainer run with its
    save, then MultiSceneTrainer."""
    want = _jax_run()
    path = str(tmp_path_factory.mktemp("tp") / "model_tp")
    cfg = CfgNode(small_cfg(**CFG).to_dict()).to_dict()
    val_cfg = CfgNode(small_cfg(**CFG, **{"experiment.validate_every": VALIDATE_EVERY})
                      .to_dict()).to_dict()
    mcfg = CfgNode(small_cfg(**MULTI_CFG).to_dict()).to_dict()
    jobs = [("tp", "trainer", (val_cfg, _scenes()[1][:7],
                               {"iters": ITERS, "params": want["init"], "draws": want["draws"],
                                "all_grads": True, "save": path, "val": _val_view()})),
            ("multi", "multi_scene", (mcfg, _multi_scenes(), {"iters": MULTI_ITERS})),
            ("data_axis", "trainer", (cfg, _scenes()[1][:7],
                                      {"iters": 1, "params": want["init"],
                                       "draws": want["draws"][:1]}), "data")]
    out = launch_mod.launch(ranks.run_jobs, RANKS, (jobs,), device="cpu", threads=1,
                            timeout=600, model_axis=MODEL_AXIS)
    return {name: [o["result"][name]["result"] for o in out] for name, *_ in jobs}, path


def test_model_axis_steps_and_events_match_jax(mesh_run):
    """Three steps on the (2, 2) mesh against JAX's model-axis Trainer: the
    events and metas, the losses (rtol 1e-4), the params on the elements
    whose gradient stays clear of rounding (1e-2 lr), and the ranks' own
    params equal bit for bit over each data column (the slices) and the
    whole params equal on every rank."""
    want, res = _jax_run(), mesh_run[0]["tp"]
    assert [r["shard"] for r in res] == [(0, 8), (8, 16)] * 2
    assert [(e["it"], e["kind"]) for e in res[0]["events"]] == [(1, "alpha"), (1, "upsample")]
    assert res[0]["meta"] == want["metas"][-1]
    for r in res:
        assert r["losses"] == res[0]["losses"]
    for r in range(RANKS):  # the slices equal over the data axis, differing over the model axis
        assert res[r]["digests"] == res[r % MODEL_AXIS]["digests"]
    assert res[0]["digests"][-1] != res[1]["digests"][-1]
    np.testing.assert_allclose(res[0]["losses"], want["losses"], rtol=1e-4, atol=1e-7)
    hp = want["hp"]

    def lr_of(path):
        return hp.lr_grid if path.startswith("planes") else (
            hp.lr_vel if path.startswith("vel") else hp.lr_net)

    # the steady elements, carried through the events between steps 1 and 2
    metas = [dataclasses.asdict(kplane.KPlaneMeta(**{**m, "vel_gate": kplane.VelGate(
        *m["vel_gate"])})) for m in want["metas"]]
    steady = None
    for it, g in enumerate(_flat(g) for g in res[0]["grads"]):
        clear = {k: np.abs(v) > max(1e-3 * np.abs(v).max(), 10 * optim.EPS) if v.any()
                 else np.zeros(v.shape, bool) for k, v in g.items() if v is not None}
        if steady is not None and any(steady[k].shape != clear[k].shape for k in clear):
            steady = _carry_mask(steady, metas[it - 2], metas[it - 1])
        steady = clear if steady is None else {k: steady[k] & clear[k] for k in clear}
    got, ref = _flat(res[0]["params"]), want["params"][-1]
    compared = 0
    for path, w in ref.items():
        if w is None or not steady[path].any():
            continue
        keep = steady[path]
        compared += int(keep.sum())
        np.testing.assert_allclose(got[path][keep], w[keep], rtol=0, atol=1e-2 * lr_of(path),
                                   err_msg=path)
    assert compared > 1000, compared


def test_model_axis_checkpoint_loads_in_jax_and_one_process(mesh_run):
    """Rank 0's save holds the whole planes and Adam moments in JAX's layout:
    JAX's ``checkpoint.load`` and a one-process ``Trainer.restore`` read the
    ranks' gathered params bit for bit."""
    res, path = mesh_run[0]["tp"], mesh_run[1]
    got = _flat(res[0]["params"])
    jparams, jmeta, jopt, jalpha, extra = jcheckpoint.load(path)
    assert extra["global_step"] == ITERS and jalpha is not None
    for k, v in _flat(jax.tree.map(np.asarray, jparams)).items():
        if v is not None:
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    for k, v in _flat(jax.tree.map(np.asarray, jopt["m"])).items():
        if v is not None:
            assert v.shape == got[k].shape, k
    tr = trainer.Trainer(CfgNode(small_cfg(**CFG).to_dict()), _scenes()[1], device="cpu")
    tr.restore(path)
    assert dataclasses.asdict(tr.meta) == res[0]["meta"]
    for k, v in _flat(tr.params).items():
        if v is not None:
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert tr.params["planes_space"][0].shape[-1] == 16


def test_model_axis_val_fn_runs_on_rank_0_with_whole_planes(mesh_run):
    """``train(val_fn=...)`` on the (2, 2) mesh: rank 0 alone renders, on the
    gathered whole planes outside the channel shard (a lookup on the slice
    would wait for a model-axis sum its partner never joins), and its image
    is the one-process render of the run's final params."""
    res = mesh_run[0]["tp"]
    assert [len(r["val"]) for r in res] == [1, 0, 0, 0]
    it, rgb = res[0]["val"][0]
    assert it == ITERS - 1 == VALIDATE_EVERY
    v = _val_view()
    meta = kplane.KPlaneMeta(**{**res[0]["meta"], "vel_gate": kplane.VelGate(
        *res[0]["meta"]["vel_gate"])})
    want = render_image(checkpoint.params_from_numpy(res[0]["params"], "cpu"), meta, v["t"],
                        v["rays_o"], v["rays_d"], white_bg=v["white_bg"],
                        chunk=v["rays_o"].shape[0] * v["rays_o"].shape[1], device="cpu")
    assert rgb.shape == want["rgb"].shape and np.isfinite(rgb).all()
    np.testing.assert_allclose(rgb, want["rgb"], rtol=1e-6, atol=1e-7)


def test_a_data_axis_run_in_the_same_launch(mesh_run):
    """A run marked "data" takes the two ranks of model index 0 as a
    ``('data',)`` mesh of whole planes (``mesh.sub("data")``); the others
    skip it.  Its first step is the model-axis run's."""
    res, tp = mesh_run[0]["data_axis"], mesh_run[0]["tp"]
    assert [r is None for r in res] == [False, True, False, True]
    assert res[0]["shard"] is None and res[0]["losses"] == res[2]["losses"]
    np.testing.assert_allclose(res[0]["losses"][0], tp[0]["losses"][0], rtol=1e-6)
    assert res[0]["params"]["planes_space"][0].shape[-1] == 16


def test_multi_scene_trainer_on_the_model_axis_equals_one_process(mesh_run):
    """Scenes split over the data axis, each data row's scenes whole on both
    of its model ranks (JAX's ``P('data')``), against one process."""
    res = mesh_run[0]["multi"]
    assert [r["scenes"] for r in res] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    want = ranks.train_multi_scene(None, CfgNode(small_cfg(**MULTI_CFG).to_dict()).to_dict(),
                                   _multi_scenes(), {"iters": MULTI_ITERS, "device": "cpu"})
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-6)
    for path, w in _flat(want["params"]).items():
        if w is None:
            continue
        for pair in ((0, 2), (1, 3)):
            got = np.concatenate([_flat(res[r]["params"])[path] for r in pair])
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7, err_msg=path)
        np.testing.assert_array_equal(_flat(res[0]["params"])[path],
                                      _flat(res[1]["params"])[path])

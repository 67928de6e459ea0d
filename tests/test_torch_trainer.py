"""The port's stage loop (``nvfi_torch.train.trainer.Trainer``) and its CLI
(``nvfi_torch.train_nvfi``) held against the JAX package on the CPU.

Both trainers run the tiny synthetic scene of ``tests/test_train_e2e.py`` on
``small_cfg`` with a schedule that has every stage event in six iterations:
upsamples after iterations 2 and 4 (16^3 -> 20^3 -> 25^3 voxels) and an
alpha-mask build with its shrink after iteration 3.  The port starts from
JAX's initial params and takes JAX's draws, rebuilt from the trainer's key
splits (``PRNGKey(seed)`` -> the init split -> one split a step -> the
loss's own splits, as ``test_torch_train._draws_from_key`` rebuilds them);
both pick their frames with the same numpy generator.  The JAX run compiles
four steps, one a stage; every other test of the file reuses it.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data import make_synthetic_scene as jmake_synthetic_scene
from nvfi_tpu.render import rays as jrays
from nvfi_tpu.render.renderer import render_image as jrender_image
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch import train_nvfi
from nvfi_torch.config import CfgNode, load_config
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint, optim, trainer

from test_torch_occupancy import jax_mask
from test_torch_render import TOL
from test_torch_train import _flat, _pde_draws
from test_train_e2e import small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_CFG = {"nvfi.N_voxel_init": 4096, "nvfi.N_voxel_final": 16384,
             "nvfi.upsamp_list": [2, 4], "nvfi.update_AlphaMask_list": [3],
             "experiment.train_iters": 6}
ITERS = 6
SEED = 0  # small_cfg's randomseed


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's CPU steps are many small ops: beside the other test workers,
    torch's default of a thread a core spends them waiting on one another (in
    a whole tier-1 run, 120 steps took 408 s so, 52 s on two threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scenes():
    """The tiny scene from each package (equal arrays, test_torch_data)."""
    kw = dict(n_train=10, n_val=2, n_test=2, H=32, W=32)
    return jmake_synthetic_scene(**kw), make_synthetic_scene(**kw)


def _cfgs(**overrides):
    jcfg = small_cfg(**{**STAGE_CFG, **overrides})
    return jcfg, CfgNode(jcfg.to_dict())


def _draws_for(key, tmeta, hp, H, W):
    """The draws of JAX's loss for ``key``, by its key splits, at H x W."""
    ray_chunk, n_chunks = trainer.ray_chunking(tmeta, hp)
    keys = jax.random.split(key, 4)

    def batch(k):
        k_pix, k_render = jax.random.split(k)
        pix = np.asarray(jax.random.choice(k_pix, H * W, (hp.n_rays,), replace=False))
        chunk_keys = [k_render] if n_chunks == 1 else jax.random.split(k_render, n_chunks)
        jitter, coins = [], []
        for ck in chunk_keys:
            k_strat, k_bg = jax.random.split(ck)
            jitter.append(np.asarray(jax.random.uniform(k_strat, (ray_chunk, 1), jnp.float32)))
            coins.append(bool(jax.random.uniform(k_bg, ()) < 0.5))
        return torch.tensor(pix, dtype=torch.int64), torch.tensor(np.stack(jitter)), coins

    pix_t, jitter_t, coin_t = batch(keys[0])
    pix_0, jitter_0, coin_0 = batch(keys[1])
    points, times_u, noise = _pde_draws(keys[2], hp.vel_reg_n_pts)
    kv1, kv2 = jax.random.split(keys[3])
    probe_x = np.asarray(jax.random.uniform(kv1, (2048, 3), minval=-1.0, maxval=1.0))
    probe_t = np.asarray(jax.random.uniform(kv2, (2048, 1)))
    return trainer.TrainDraws(pix_t, pix_0, jitter_t, jitter_0, coin_t, coin_0, points, times_u,
                              noise, torch.tensor(probe_x), torch.tensor(probe_t))


class JaxDraws:
    """``Trainer(draws=...)``: each step's draws from the JAX trainer's key chain."""

    def __init__(self, seed, H, W):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))  # the init split
        self.H, self.W = H, W

    def __call__(self, step, meta, hp):
        self.key, k_step = jax.random.split(self.key)
        return _draws_for(k_step, meta, hp, self.H, self.W)


def _host(tree):
    """Copies on the host of a JAX tree (a zero-copy view of a donated
    buffer would change under the next step)."""
    return jax.tree.map(np.array, tree)


def _state(tr, jax_side):
    """What the stage events change, comparable across the packages."""
    alpha = None
    if tr.alpha_state is not None:
        alpha = {k: np.array(v) for k, v in
                 (tr.alpha_state.items() if jax_side
                  else checkpoint.alpha_state_to_numpy(tr.alpha_state).items())}
    opt = tr.opt_state
    return {"meta": dataclasses.asdict(tr.meta), "n_voxel_list": list(tr.n_voxel_list),
            "keyframe_list": list(tr.keyframe_list), "reso_mask": tuple(tr.reso_mask),
            "l1_base": float(tr.l1_base), "l1_step0": int(tr.l1_step0), "alpha": alpha,
            "opt_step": None if opt is None else int(opt["step"]),
            "global_step": tr.global_step}


@pytest.fixture(scope="module")
def parity_run():
    """Both trainers, one iteration at a time, with the state after each
    iteration and the port's gradients of every step."""
    (jscene, tscene), (jcfg, tcfg) = _scenes(), _cfgs()
    jtr = jtrainer.Trainer(jcfg, jscene, mode="static_dynamic")
    H, W = jscene[6][:2]
    ttr = trainer.Trainer(tcfg, tscene, mode="static_dynamic", device="cpu",
                          draws=JaxDraws(SEED, H, W))
    ttr.params = checkpoint.params_from_numpy(_host(jtr.params), "cpu")
    grads = []
    apply_updates = optim.apply_updates

    def recording(params, g, *args, **kwargs):
        grads.append(_flat(g))
        return apply_updates(params, g, *args, **kwargs)

    states = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optim, "apply_updates", recording)
        for it in range(ITERS):
            jtr.train(iters=it + 1)
            ttr.train(iters=it + 1)
            # copies: both packages update their params in place (JAX by donation)
            states.append((_state(jtr, True), _state(ttr, False), _flat(_host(jtr.params)),
                           {k: v.copy() for k, v in _flat(ttr.params).items()}))
    return {"jax": jtr, "port": ttr, "states": states, "grads": grads}


def test_stage_events_match_jax_after_every_iteration(parity_run):
    states = parity_run["states"]
    kinds = [[e["kind"] for e in parity_run["port"].events if e["it"] == it]
             for it in range(ITERS)]
    assert kinds == [[], [], ["upsample"], ["alpha"], ["upsample"], []]
    grids = [s[1]["meta"]["grid_size"] for s in states]
    assert grids[1] == (16, 16, 16) and grids[2] == (20, 20, 20)
    for it, (want, got, _, _) in enumerate(states):
        for key in ("meta", "n_voxel_list", "keyframe_list", "reso_mask", "l1_base",
                    "l1_step0", "global_step", "opt_step"):
            assert got[key] == want[key], (it, key, got[key], want[key])
        assert (got["alpha"] is None) == (want["alpha"] is None) == (it < 3), it
        if want["alpha"] is not None:
            assert sorted(got["alpha"]) == sorted(want["alpha"])
            np.testing.assert_array_equal(got["alpha"]["aabb"], want["alpha"]["aabb"])
            # the binary volumes may differ only where the dense alpha lies
            # within rounding of the threshold (test_update_alpha_mask_matches_jax)
            for k in ("volume", "dilated"):
                differ = got["alpha"][k] != want["alpha"][k]
                assert differ.mean() < 0.02, (k, float(differ.mean()))
    # Adam restarts at every event; the L1 weight switches at the alpha event
    assert [s[1]["opt_step"] for s in states] == [1, 2, 0, 0, 0, 1]
    assert states[-1][1]["l1_step0"] == 4 and states[-1][1]["l1_base"] == pytest.approx(4e-4)
    # the planes after the events are contiguous leaves of their own
    for p in parity_run["port"].params["planes_space"] + parity_run["port"].params["planes_time"]:
        assert p.is_contiguous() and p.is_leaf and p.grad is None


def _carry_mask(steady, meta_before, meta_after):
    """The steady mask through the events between two steps: an element of
    the new planes is steady where every element it was made from was."""
    from nvfi_torch.fields import kplane

    meta = kplane.KPlaneMeta(**meta_before)
    planes = {head: [torch.tensor(steady[f"{head}/{i}"], dtype=torch.float32) for i in range(3)]
              for head in ("planes_space", "planes_time")}
    if meta.aabb != meta_after["aabb"]:
        planes, meta = kplane.shrink(planes, meta, np.asarray(meta_after["aabb"]))
    if meta.grid_size != meta_after["grid_size"] or \
            meta.num_keyframes != meta_after["num_keyframes"]:
        planes, meta = kplane.upsample(planes, meta, meta_after["grid_size"],
                                       meta_after["num_keyframes"])
    out = dict(steady)
    for head, ps in planes.items():
        for i, p in enumerate(ps):
            out[f"{head}/{i}"] = p.detach().numpy() > 1 - 1e-6
    return out


def test_final_params_match_jax_on_steady_elements(parity_run):
    """Within the five-step trajectory's limit, 1e-2 lr, on the elements
    whose gradient stays clear of rounding noise at every step: over 1e-3 of
    the leaf's largest, and over 10 x Adam's eps (the first step after each
    event's reset moves an element by lr g / (|g| + eps), which follows the
    rounding of a gradient near eps).  An element made by an upsample or a
    crop is steady where every element it was made from was."""
    states, grads = parity_run["states"], parity_run["grads"]
    metas = [None] + [s[1]["meta"] for s in states]  # metas[k]: the meta of step k
    steady = None
    for it, g in enumerate(grads):
        clear = {k: np.zeros(states[it][3][k].shape, bool) if v is None or not v.any()
                 else np.abs(v) > max(1e-3 * np.abs(v).max(), 10 * optim.EPS)
                 for k, v in g.items()}
        if steady is not None and any(steady[k].shape != clear[k].shape for k in clear):
            # the events of iteration it - 1 came between steps it - 1 and it
            steady = _carry_mask(steady, metas[it - 1], metas[it])
        steady = clear if steady is None else {k: steady[k] & clear[k] for k in clear}
    hp = parity_run["port"].hp
    got, want = states[-1][3], states[-1][2]
    compared = 0
    for path, w in want.items():
        keep = steady[path]
        if not keep.any():
            continue
        compared += int(keep.sum())
        lr = hp.lr_grid if path.startswith("planes") else hp.lr_net
        np.testing.assert_allclose(got[path][keep], w[keep], rtol=0, atol=1e-2 * lr,
                                   err_msg=path)
    assert compared > 2000


def test_reprobe_turbo_budgets_match_jax():
    """``_reprobe_turbo`` on one alpha state (the off-centre blob's mask of
    test_torch_occupancy) gives JAX's block budget and shade fraction, under
    the shade cap and following the probe."""
    (jscene, tscene) = _scenes()
    mask = {k: np.asarray(v) for k, v in jax_mask()[0].items()}
    for follow in (False, True):
        jcfg, tcfg = _cfgs(**{"nvfi.turbo": True, "nvfi.shade_fraction": 0.25,
                              "nvfi.sample_block": 4, "nvfi.shade_follow_probe": follow})
        jtr = jtrainer.Trainer(jcfg, jscene, mode="static_dynamic")
        ttr = trainer.Trainer(tcfg, tscene, mode="static_dynamic", device="cpu")
        jtr.alpha_state = {k: jnp.asarray(v) for k, v in mask.items()}
        ttr.alpha_state = checkpoint.alpha_state_from_numpy(mask, "cpu")
        jtr.meta = dataclasses.replace(jtr.meta, train_occupancy_prune=True)
        ttr.meta = dataclasses.replace(ttr.meta, train_occupancy_prune=True)
        jtr._reprobe_turbo("test")
        assert ttr._reprobe_turbo("test") is not None
        assert (ttr.meta.block_budget, ttr.meta.shade_fraction) == \
            (jtr.meta.block_budget, jtr.meta.shade_fraction)
        assert 0.0 < ttr.meta.block_budget < 1.0
        assert (ttr.meta.shade_fraction == 0.25) != follow


def _render(params, meta, scene, port):
    """The first val view of ``scene``, at the second val time.  Without the
    trainer's mask: six iterations leave the density flat (its alpha is
    5.3e-6 to 5.8e-6 everywhere, under the 1e-4 threshold), so the mask is
    empty, the shrink keeps the box and a masked render is blank."""
    H, W, focal = scene[6][:3]
    cam = (rays if port else jrays).Camera(scene[1]["val"][0], H, W, focal,
                                         near=meta.near_far[0], far=meta.near_far[1])
    o, d = cam.rays_o.reshape(H, W, 3), cam.rays_d.reshape(H, W, 3)
    t = float(scene[2]["val"][1])
    if port:
        return render_image(params, meta, t, o, d, white_bg=True, chunk=H * W, device="cpu")
    return jrender_image(params, meta, t, o, d, white_bg=True, chunk=H * W)


def _assert_renders_close(got, want):
    for k in ("rgb", "acc", "depth"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_both_ways_with_equal_renders(parity_run, writer, tmp_path):
    """A checkpoint after the upsamples and the shrink, written by one
    package's Trainer.save, restores in the other's Trainer.restore to the
    same state, which renders the same image (test_torch_render.TOL)."""
    (jscene, tscene), (jcfg, tcfg) = _scenes(), _cfgs()
    path = str(tmp_path / "model_00005")
    src = parity_run[writer if writer == "jax" else "port"]
    src.save(path, src.opt_state)
    if writer == "jax":
        dst = trainer.Trainer(tcfg, tscene, mode="static_dynamic", device="cpu")
    else:
        dst = jtrainer.Trainer(jcfg, jscene, mode="static_dynamic")
    dst.restore(path)
    want, got = _state(src, writer == "jax"), _state(dst, writer != "jax")
    assert got == {**want, "alpha": got["alpha"]} and got["global_step"] == ITERS
    for k, v in want["alpha"].items():
        np.testing.assert_array_equal(got["alpha"][k], v)
    src_p = _flat(_host(src.params)) if writer == "jax" else _flat(src.params)
    dst_p = _flat(dst.params) if writer == "jax" else _flat(_host(dst.params))
    for k, v in src_p.items():
        np.testing.assert_array_equal(dst_p[k], v)
    jtr, ttr = (src, dst) if writer == "jax" else (dst, src)
    want_img = _render(jtr.params, jtr.meta, jscene, port=False)
    got_img = _render(ttr.params, ttr.meta, tscene, port=True)
    assert float(np.asarray(want_img["acc"]).max()) > 1e-3
    _assert_renders_close(got_img, want_img)


def test_port_trainer_learns():
    """tests/test_train_e2e.py's bar: more than 4 dB in 120 iterations."""
    _, tscene = _scenes()
    tr = trainer.Trainer(CfgNode(small_cfg().to_dict()), tscene, mode="static_dynamic",
                         device="cpu")
    logs = []
    tr.train(iters=120, log_fn=logs.append)
    assert logs[-1]["psnr_0"] > logs[0]["psnr_0"] + 4, (logs[0]["psnr_0"], logs[-1]["psnr_0"])
    assert np.isfinite(logs[-1]["loss"]) and logs[-1]["it"] == 119


TINY_RUN = ["--synthetic", "--synth_res", "16", "--synth_frames", "6", "--device", "cpu",
            "nvfi.N_voxel_init", "4096", "nvfi.N_voxel_final", "8192",
            "nvfi.upsamp_list", "[1]", "nvfi.update_AlphaMask_list", "[2]",
            "nvfi.density_n_comp", "[4,4,4]", "nvfi.appearance_n_comp", "[4,4,4]",
            "nvfi.app_dim", "8", "nvfi.featureC", "16", "nvfi.vel_hidden", "16",
            "renderer.n_rays", "64", "nvfi.max_n_samples", "24",
            "experiment.vel_reg_n_pts", "64", "experiment.train_iters", "3",
            "experiment.save_every", "2", "experiment.print_every", "1"]


def test_cli_trains_saves_and_evaluates(tmp_path):
    """``python -m nvfi_torch.train_nvfi`` on a tiny synthetic scene with
    --eval_test: config.yaml, metrics.jsonl, the checkpoints, the GIF and the
    eval PNGs; --resume restores the last checkpoint and trains on."""
    config = os.path.join(REPO, "configs", "synth", "bat.yaml")
    logdir = str(tmp_path / "run")
    out = train_nvfi.main(["--config", config, "--static_dynamic", "--eval_test",
                           "--logdir", logdir, *TINY_RUN])
    names = set(os.listdir(logdir))
    assert {"config.yaml", "metrics.jsonl", "model_00002.npz", "model_00002.json",
            "model_00002.npz", "time_sweep.gif", "test_img"} <= names
    assert load_config(os.path.join(logdir, "config.yaml")).experiment.train_iters == 3
    logged = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [m["it"] for m in logged] == [0, 1, 2] and all(np.isfinite(m["loss"]) for m in logged)
    pngs = sorted(os.listdir(os.path.join(logdir, "test_img")))
    assert len([p for p in pngs if p.endswith(".png")]) == 16 and "metrics.txt" in pngs
    assert np.isfinite(out["eval"]["psnr"]) and out["trainer"].global_step == 3
    assert [e["kind"] for e in out["trainer"].events] == ["upsample", "alpha"]
    again = train_nvfi.main(["--config", config, "--static_dynamic", "--resume", "--logdir",
                             logdir, *TINY_RUN, "experiment.train_iters", "4"])
    assert again["trainer"].global_step == 4 and "model_00003.npz" in os.listdir(logdir)
    assert again["trainer"].meta.grid_size == out["trainer"].meta.grid_size


@pytest.mark.parametrize("flags,item", [(["--devices", "2"], "A10")])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path):
    config = os.path.join(REPO, "configs", "synth", "bat.yaml")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        train_nvfi.main(["--config", config, "--logdir", str(tmp_path), "--device", "cpu",
                         *flags])


@pytest.mark.parametrize("model,decomposition", [("TensorVMSplit", "VM"), ("TensorCP", "CP")])
def test_cli_trains_the_static_models(model, decomposition, tmp_path, capsys):
    """A model_name without Keyframe takes the CLI's static branch, as the
    JAX CLI's: a StaticTrainer, its [static] lines, no checkpoint; with
    --not_train it only builds the trainer."""
    from nvfi_torch.train.static import StaticTrainer

    config = os.path.join(REPO, "configs", "synth", "bat.yaml")
    head = ["--config", config, "--logdir", str(tmp_path)]
    tail = [*TINY_RUN, "nvfi.model_name", model, "nvfi.update_AlphaMask_list", "[1]"]
    out = train_nvfi.main(head + tail)
    tr = out["trainer"]
    assert isinstance(tr, StaticTrainer) and tr.meta.decomposition == decomposition
    assert tr.global_step == 3 and out["eval"] is None
    assert [(e["it"], e["kind"]) for e in tr.events] == [(1, "alpha"), (1, "upsample")]
    assert tr.meta.grid_size == tuple(trainer.n_to_reso(8192, tr.meta.aabb_np))
    logged = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("[static]")]
    assert [line.split()[1] for line in logged] == ["it=0", "it=1", "it=2"]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("model_")]
    idle = train_nvfi.main(head + ["--not_train"] + tail)["trainer"]
    assert isinstance(idle, StaticTrainer) and idle.global_step == 0


def test_trainer_refuses_a_mesh():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        trainer.Trainer(tcfg, _scenes()[1], mesh=object(), device="cpu")

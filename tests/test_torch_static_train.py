"""Static TensoRF training of nvfi_torch (``train.static``) held against the
JAX package on the CPU: one ``make_static_step`` (loss, gradients, Adam), an
8-iteration ``StaticTrainer`` run with an alpha-mask + shrink event after
iteration 4 and an upsample after iteration 6, and the port's trainer
learning the tiny scene of ``tests/test_static.py``.

The port takes JAX's draws, rebuilt from the trainer's key splits
(``PRNGKey(seed)`` -> the init split -> one split a step -> ``k_pix,
k_render`` -> ``k_strat, k_bg``), and starts from JAX's initial params; both
pick their frames with the same numpy generator.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.data import make_synthetic_scene as jmake_synthetic_scene
from nvfi_tpu.fields import tensorf_vm as jtensorf_vm
from nvfi_tpu.train import optim as joptim
from nvfi_tpu.train import static as jstatic
from nvfi_tpu.train.trainer import TrainHP as JTrainHP
from nvfi_torch.config import CfgNode
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.fields import tensorf_vm
from nvfi_torch.train import checkpoint, optim, static

from test_static import static_cfg

SEED = 0  # static_cfg's randomseed
# the trainer run's schedule; its density shift -12 keeps the empty space's
# weights an order of magnitude under rayMarch_weight_thres (at -10,
# softplus(-10) x 25 x the step is ~1e-4, on the threshold, and float32
# rounding flips the app mask of whole runs of samples between the packages,
# which moves the gradients by up to a tenth of their largest)
EVENTS = {"nvfi.update_AlphaMask_list": [4], "nvfi.upsamp_list": [6],
          "nvfi.N_voxel_final": 32768, "nvfi.density_shift": -12}
ITERS = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scenes():
    kw = dict(n_train=6, n_val=1, n_test=1, H=32, W=32)
    return jmake_synthetic_scene(**kw), make_synthetic_scene(**kw)


def _cfgs(model="TensorVMSplit", **overrides):
    jcfg = static_cfg(model)
    for k, v in overrides.items():
        node = jcfg
        *path, last = k.split(".")
        for p in path:
            node = node[p]
        node[last] = v
    return jcfg, CfgNode(jcfg.to_dict())


def _draws_for(key, n_rays, H, W):
    """The draws of JAX's static loss for a step key."""
    k_pix, k_render = jax.random.split(key)
    pix = np.asarray(jax.random.choice(k_pix, H * W, (n_rays,), replace=False))
    k_strat, k_bg = jax.random.split(k_render)
    jitter = np.asarray(jax.random.uniform(k_strat, (n_rays, 1), jnp.float32))
    return static.StaticDraws(pix=torch.tensor(pix, dtype=torch.int64),
                              jitter=torch.tensor(jitter),
                              coin=bool(jax.random.uniform(k_bg, ()) < 0.5))


class JaxStaticDraws:
    """``StaticTrainer(draws=...)``: each step's draws from JAX's key chain."""

    def __init__(self, seed, H, W):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))  # the init split
        self.H, self.W = H, W

    def __call__(self, step, meta, hp):
        self.key, k = jax.random.split(self.key)
        return _draws_for(k, hp.n_rays, self.H, self.W)


def _flat(tree, prefix=""):
    """{path: numpy array} of a param tree of either package."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().numpy().copy()}
    return {prefix[:-1]: np.array(tree)}


@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP"])
def test_one_static_step_matches_jax(model):
    """The loss within 1e-5, every leaf's gradient within 1e-4 + 1e-4 x its
    largest |grad|, and the port's Adam on JAX's gradients lands on JAX's
    params within 1e-5 of the learning rate and 1e-6 of their value (the
    recovered gradient m / 0.1 and the update's order of operations move the
    last bits: a few ulps of the params)."""
    tv = {"experiment.TV_weight_density": 1.0, "experiment.TV_weight_app": 1.0}
    (jscene, tscene), (jcfg, tcfg) = _scenes(), _cfgs(model, **tv)
    jhp, thp = JTrainHP.from_cfg(jcfg), static.TrainHP.from_cfg(tcfg)
    H, W, focal = jscene[6]
    jtr = jstatic.StaticTrainer(jcfg, jscene)
    tree = jax.tree.map(np.array, jtr.params)
    if model == "TensorCP":
        # unit-scale lines: from JAX's 0.2-scale init the app gradients are
        # ~1e-11, and float32 summation order alone moves them by ~1e-4 of
        # their largest, in either package
        for k in ("density_line", "app_line"):
            tree[k] = [5.0 * p for p in tree[k]]
    poses, images = jtr.poses_buf, jtr.images_buf
    key = jax.random.PRNGKey(11)
    frame, it = 0, 5  # the scene's one "init" frame, which the static trainer trains on
    jstep = jstatic.make_static_step(jtr.meta, jhp, H, W, focal)
    jparams = jax.tree.map(jnp.asarray, tree)
    jp, jopt, jm = jstep(jparams, joptim.init_state(jparams), key, jnp.int32(frame),
                         jnp.int32(it), poses, images)
    jp, jopt = jax.tree.map(np.array, jp), jax.tree.map(np.array, jopt)

    tmeta = tensorf_vm.StaticMeta(**dataclasses.asdict(jtr.meta))
    params = checkpoint.static_params_from_numpy(tree, "cpu")
    step = static.make_static_step(tmeta, thp, H, W, focal, device="cpu")
    grads = []
    apply = optim.apply_updates

    def recording(p, g, *args, **kwargs):
        grads.append(_flat(g))
        return apply(p, g, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optim, "apply_updates", recording)
        params, opt, tm = step(params, optim.init_state(params),
                               _draws_for(key, thp.n_rays, H, W),
                               frame, it, torch.tensor(np.asarray(poses)),
                               torch.tensor(np.asarray(images)))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["rgb_loss_0"]) == pytest.approx(float(jm["rgb_loss_0"]), rel=1e-5)
    jgrads = {k: v / np.float32(1 - optim.B1) for k, v in _flat(jopt["m"]).items()}
    assert sorted(grads[0]) == sorted(jgrads)
    for k, g in grads[0].items():
        w = jgrads[k]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
    # Adam alone: the port's update on JAX's gradients
    p0 = checkpoint.static_params_from_numpy(tree, "cpu")
    g0 = checkpoint.static_params_from_numpy(jax.tree.map(
        lambda m: np.asarray(m) / np.float32(1 - optim.B1), jopt["m"]), "cpu")
    p1, _ = optim.apply_updates(p0, g0, optim.init_state(p0),
                                optim.make_lr_tree(p0, thp.lr_grid, thp.lr_net), 1.0)
    got, want = _flat(p1), _flat(jp)
    for k, w in want.items():
        lr = thp.lr_grid if k.split("/")[0] in optim.GRID_KEYS else thp.lr_net
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-5 * lr, err_msg=k)


def _record_events(mp, module, sink):
    """Wrap ``module.shrink`` and ``module.upsample`` to keep the metas they
    return."""
    for name in ("shrink", "upsample"):
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            sink.append((_name, dataclasses.asdict(out[1])))
            return out

        mp.setattr(module, name, wrapped)


def _synced_steps(make_step, record):
    """``make_static_step`` of the port, whose steps first take JAX's state
    before the same step (params and Adam moments, in place) and record
    what they compute from it."""
    def build(meta, hp, H, W, focal, device="cuda"):
        step = make_step(meta, hp, H, W, focal, device)

        def run(params, opt_state, draws, frame_idx, global_step, poses, images):
            want = record["jax_steps"][len(record["port_steps"])]
            with torch.no_grad():
                for name, dst in (("params", params), ("m", opt_state["m"]),
                                  ("v", opt_state["v"])):
                    src = want[name]
                    for path, t in _flat_tensors(dst).items():
                        t.copy_(torch.from_numpy(src[path]))
            opt_state["step"] = want["step"]
            params, opt_state, metrics = step(params, opt_state, draws, frame_idx, global_step,
                                              poses, images)
            record["port_steps"].append({"params": _flat(params), "frame": frame_idx,
                                         "loss": float(metrics["loss"])})
            return params, opt_state, metrics

        return run

    return build


def _jax_recorded_steps(make_step, record):
    """JAX's ``make_static_step``, whose jitted steps keep host copies of
    their inputs and outputs (the step donates its inputs) and their
    gradient: the first moment of the same step from a fresh Adam state is
    exactly (1 - B1) g."""
    def build(meta, hp, H, W, focal):
        step = make_step(meta, hp, H, W, focal)

        def run(params, opt_state, key, frame_idx, global_step, poses, images):
            before = {"params": _flat(params), "m": _flat(opt_state["m"]),
                      "v": _flat(opt_state["v"]), "step": int(opt_state["step"])}
            copy = jax.tree.map(jnp.array, params)
            fresh = step(copy, joptim.init_state(copy), key, frame_idx, global_step, poses,
                         images)[1]
            before["grad"] = {k: v / np.float32(1 - optim.B1)
                              for k, v in _flat(fresh["m"]).items()}
            params, opt_state, metrics = step(params, opt_state, key, frame_idx, global_step,
                                              poses, images)
            record["jax_steps"].append({**before, "after": _flat(params),
                                        "loss": float(metrics["loss"]), "frame": int(frame_idx)})
            return params, opt_state, metrics

        return run

    return build


def _flat_tensors(tree, prefix=""):
    """{path: tensor} of a port tree (the leaves themselves, not copies)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_tensors(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_tensors(v, f"{prefix}{i}/").items()}
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def parity_run():
    """Both trainers for ITERS iterations (JAX's first, recording every
    step), the port from JAX's initial params with JAX's draws, each of its
    steps started from JAX's state before that step; the metas the events
    returned, and the port's gradients."""
    (jscene, tscene), (jcfg, tcfg) = _scenes(), _cfgs(**EVENTS)
    jtr = jstatic.StaticTrainer(jcfg, jscene)
    H, W = jscene[6][:2]
    ttr = static.StaticTrainer(tcfg, tscene, device="cpu", draws=JaxStaticDraws(SEED, H, W))
    ttr.params = checkpoint.static_params_from_numpy(jax.tree.map(np.array, jtr.params), "cpu")
    jevents, tevents, grads = [], [], []
    record = {"jax_steps": [], "port_steps": []}
    apply = optim.apply_updates

    def recording(p, g, *args, **kwargs):
        grads.append(_flat(g))
        return apply(p, g, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        _record_events(mp, jtensorf_vm, jevents)
        _record_events(mp, tensorf_vm, tevents)
        mp.setattr(jstatic, "make_static_step",
                   _jax_recorded_steps(jstatic.make_static_step, record))
        mp.setattr(static, "make_static_step", _synced_steps(static.make_static_step, record))
        mp.setattr(optim, "apply_updates", recording)
        jtr.train(iters=ITERS)
        ttr.train(iters=ITERS)
    return {"jax": jtr, "port": ttr, "jevents": jevents, "tevents": tevents, "grads": grads,
            **record}


def test_trainer_events_and_metas_match_jax(parity_run):
    jtr, ttr = parity_run["jax"], parity_run["port"]
    assert [e[0] for e in parity_run["tevents"]] == ["shrink", "upsample"]
    assert parity_run["tevents"] == parity_run["jevents"]
    assert [(e["it"], e["kind"]) for e in ttr.events] == [(4, "alpha"), (6, "upsample")]
    assert dataclasses.asdict(ttr.meta) == dataclasses.asdict(jtr.meta)
    assert ttr.meta.grid_size == (31, 31, 31) and ttr.global_step == jtr.global_step == ITERS
    np.testing.assert_array_equal(ttr.alpha_state["volume"].numpy(),
                                  np.asarray(jtr.alpha_state["volume"]))
    np.testing.assert_array_equal(ttr.alpha_state["aabb"].numpy(),
                                  np.asarray(jtr.alpha_state["aabb"]))
    # Adam restarts at each event: one step since the upsample; JAX's state
    # before each step, which the port takes, has the same restarts
    assert ttr.opt_state["step"] == int(jtr.opt_state["step"]) == 1
    assert [r["step"] for r in parity_run["jax_steps"]] == [0, 1, 2, 3, 4, 0, 1, 0]
    assert [r["frame"] for r in parity_run["port_steps"]] == \
        [r["frame"] for r in parity_run["jax_steps"]]
    for name in ("density_plane", "density_line", "app_plane", "app_line"):
        assert all(p.is_leaf and p.is_contiguous() and p.grad is None
                   for p in ttr.params[name])


def test_trainer_steps_match_jax_from_its_state(parity_run):
    """Every step, from JAX's state before it: the loss within 1e-5, each
    leaf's gradient within 1e-4 + 1e-4 x its largest |grad| (as one
    make_static_step; the Adam moments follow from it), and the params
    after the step within 1e-2 of the learning rate where the gradient is
    clear of rounding noise (over 1e-3 of the leaf's largest and 10 x Adam's
    eps: where it is not, Adam's first steps move an element by lr g / (|g|
    + eps), which follows the rounding of the gradient's sign)."""
    hp = parity_run["port"].hp
    steps = parity_run["port_steps"], parity_run["jax_steps"], parity_run["grads"]
    assert [len(x) for x in steps] == [ITERS] * 3
    for it, (t, j, g) in enumerate(zip(*steps)):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5), it
        for k, w in j["after"].items():
            jg = j["grad"][k]
            scale = np.abs(jg).max()
            np.testing.assert_allclose(g[k], jg, rtol=1e-4, atol=1e-4 * scale + 1e-12,
                                       err_msg=f"it={it} grad {k}")
            clear = np.abs(jg) > max(1e-3 * scale, 10 * optim.EPS)
            lr = hp.lr_grid if k.split("/")[0] in optim.GRID_KEYS else hp.lr_net
            np.testing.assert_allclose(t["params"][k][clear], w[clear], rtol=0,
                                       atol=1e-2 * lr, err_msg=f"it={it} params {k}")


def test_port_static_trainer_learns():
    """tests/test_static.py's bar for JAX: more than 4 dB in 120 iterations."""
    _, tscene = _scenes()
    tr = static.StaticTrainer(_cfgs()[1], tscene, device="cpu")
    logs = []
    tr.train(iters=120, log_fn=logs.append)
    assert logs[-1]["psnr_0"] > logs[0]["psnr_0"] + 4, (logs[0]["psnr_0"], logs[-1]["psnr_0"])
    assert np.isfinite(logs[-1]["loss"]) and logs[-1]["it"] == 119

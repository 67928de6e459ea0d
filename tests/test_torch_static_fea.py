"""The static TensoRF field of nvfi_torch with the other shaders (ROADMAP A3)
held against the JAX package on the CPU: an eval render in every shading mode
the static path can run, and TensoRF's own VM-192 shader setting (MLP_Fea,
``view_pe`` = ``fea_pe`` = 2, ``app_dim`` 27; TensoRF ``configs/lego.txt``)
through one ``make_static_step`` and four ``StaticTrainer`` iterations
stepped beside JAX's (each port step from JAX's state before it).  RGBtLinear
reads per-sample times that the static field never passes; it fails in both
packages (``test_torch_shaders``).  Widths are cut to the tiny scene.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import tensorf_vm as jtensorf_vm
from nvfi_tpu.train import optim as joptim
from nvfi_tpu.train import static as jstatic
from nvfi_tpu.train.trainer import TrainHP as JTrainHP
from nvfi_torch.fields import tensorf_vm
from nvfi_torch.train import checkpoint, optim, static

import test_torch_static_render as srender
from test_torch_static_train import (JaxStaticDraws, _cfgs, _draws_for, _flat,
                                     _jax_recorded_steps, _scenes, _synced_steps)

APP_DIM = {"SH": 27, "RGB": 3, "RGBIdentity": 3}
# TensoRF's VM-192 shader (configs/lego.txt): MLP_Fea, view_pe = fea_pe = 2,
# app_dim 27; featureC cut from 128 to 32 for the tiny scene
VM192 = {"nvfi.shadingMode": "MLP_Fea", "nvfi.view_pe": 2, "nvfi.fea_pe": 2,
         "nvfi.app_dim": 27, "nvfi.density_shift": -12}
SEED = 0
ITERS = 4


def _occupied(tree):
    """The trainer's fresh field (empty at density shift -12, so the shader
    would get no gradient) with its first density channel raised to a
    uniform medium: the feature 3 x 2 x 2 = 12, sigma softplus(0); each
    ray's weights fall off through the box, past rayMarch_weight_thres once."""
    tree = dict(tree)
    for name in ("density_plane", "density_line"):
        tree[name] = [p.copy() for p in tree[name]]
        for p in tree[name]:
            p[..., 0] = 2.0
    return tree


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("mode", ["MLP_Fea", "MLP", "SH", "RGB", "RGBIdentity"])
def test_static_eval_render_matches_jax_in_every_shader(mode):
    """``test_torch_static_render``'s blob field, its app basis and shader
    drawn anew for the mode (analytic shaders have no params)."""
    base, jmeta, _ = srender.scene("VM")
    fields = dict(srender.META, decomposition="VM", shading_mode=mode,
                  app_dim=APP_DIM.get(mode, 8), view_pe=2, fea_pe=2)
    jmeta = jtensorf_vm.StaticMeta(**fields)
    fresh = jax.tree.map(np.array, jtensorf_vm.init_params(jax.random.PRNGKey(1), jmeta))
    tree = dict(base, basis_mat=fresh["basis_mat"], shader=fresh["shader"])
    assert (tree["shader"] is None) == (mode in APP_DIM)
    o, d = srender._rays()
    want = jax.jit(functools.partial(jtensorf_vm.render_rays, meta=jmeta, key=None,
                                     training=False, white_bg=True))(
        jax.tree.map(jnp.asarray, tree), rays_o=jnp.asarray(o), rays_d=jnp.asarray(d))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tensorf_vm.render_rays(checkpoint.static_params_from_numpy(tree, "cpu"),
                                 tensorf_vm.StaticMeta(**fields), o, d, white_bg=True,
                                 device="cpu")
    srender._assert_close(got, want)
    assert want["acc"].mean() > 0.1


def test_one_vm192_step_matches_jax():
    """One static step in TensoRF's VM-192 shader setting: the loss within
    1e-5, every leaf's gradient within 1e-4 + 1e-4 x its largest |grad| (the
    tolerances of ``test_torch_static_train``'s step)."""
    (jscene, _), (jcfg, tcfg) = _scenes(), _cfgs(**VM192)
    jhp, thp = JTrainHP.from_cfg(jcfg), static.TrainHP.from_cfg(tcfg)
    H, W, focal = jscene[6]
    jtr = jstatic.StaticTrainer(jcfg, jscene)
    assert jtr.meta.shading_mode == "MLP_Fea" and jtr.meta.app_dim == 27
    tree = _occupied(jax.tree.map(np.array, jtr.params))
    assert tree["shader"][0]["w"].shape == (150, 32)  # 2*2*3 + 2*2*27 + 3 + 27
    poses, images = jtr.poses_buf, jtr.images_buf
    key, frame, it = jax.random.PRNGKey(11), 0, 5
    jstep = jstatic.make_static_step(jtr.meta, jhp, H, W, focal)
    jparams = jax.tree.map(jnp.asarray, tree)
    _, jopt, jm = jstep(jparams, joptim.init_state(jparams), key, jnp.int32(frame),
                        jnp.int32(it), poses, images)
    jopt = jax.tree.map(np.array, jopt)

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
        _, _, tm = step(params, optim.init_state(params), _draws_for(key, thp.n_rays, H, W),
                        frame, it, torch.tensor(np.asarray(poses)),
                        torch.tensor(np.asarray(images)))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    jgrads = {k: v / np.float32(1 - optim.B1) for k, v in _flat(jopt["m"]).items()}
    assert sorted(grads[0]) == sorted(jgrads)
    for k, g in grads[0].items():
        w = jgrads[k]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert all(np.abs(jgrads[f"shader/{i}/w"]).max() > 0 for i in range(3))


def test_vm192_trainer_steps_match_jax():
    """Four StaticTrainer iterations in the VM-192 shader setting, JAX's
    draws and initial params, each port step from JAX's state before it:
    the loss within 1e-5 and each leaf's gradient within 1e-4 + 1e-4 x its
    largest |grad|, as ``test_torch_static_train``'s trainer run."""
    (jscene, tscene), (jcfg, tcfg) = _scenes(), _cfgs(**VM192)
    jtr = jstatic.StaticTrainer(jcfg, jscene)
    H, W = jscene[6][:2]
    ttr = static.StaticTrainer(tcfg, tscene, device="cpu", draws=JaxStaticDraws(SEED, H, W))
    tree = _occupied(jax.tree.map(np.array, jtr.params))
    jtr.params = jax.tree.map(jnp.asarray, tree)
    ttr.params = checkpoint.static_params_from_numpy(tree, "cpu")
    grads, record = [], {"jax_steps": [], "port_steps": []}
    apply = optim.apply_updates

    def recording(p, g, *args, **kwargs):
        grads.append(_flat(g))
        return apply(p, g, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstatic, "make_static_step",
                   _jax_recorded_steps(jstatic.make_static_step, record))
        mp.setattr(static, "make_static_step", _synced_steps(static.make_static_step, record))
        mp.setattr(optim, "apply_updates", recording)
        jtr.train(iters=ITERS)
        ttr.train(iters=ITERS)
    assert ttr.meta.shading_mode == "MLP_Fea" and ttr.global_step == ITERS
    assert [len(record["port_steps"]), len(record["jax_steps"]), len(grads)] == [ITERS] * 3
    for it, (t, j, g) in enumerate(zip(record["port_steps"], record["jax_steps"], grads)):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5), it
        for k, jg in j["grad"].items():
            np.testing.assert_allclose(g[k], jg, rtol=1e-4,
                                       atol=1e-4 * np.abs(jg).max() + 1e-12,
                                       err_msg=f"it={it} grad {k}")
        assert np.abs(j["grad"]["shader/0/w"]).max() > 0, it

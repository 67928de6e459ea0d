"""The nvfi_torch render slice held against the JAX package on the CPU:
``render_rays(training=False)``, ``render_image``, checkpoints both ways, the
bat config's meta, the port's import isolation and its device default.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.config import load_config as jload_config
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.render.renderer import render_image as jrender_image
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_tpu.train.trainer import n_to_reso as jn_to_reso
from nvfi_torch import train_nvfi
from nvfi_torch.config import load_config
from nvfi_torch.data import make_synthetic_scene
from nvfi_torch.fields import kplane
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint
from nvfi_torch.train.trainer import Trainer, n_to_reso

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = dict(
    grid_size=(12, 10, 9), num_keyframes=4, tmax=0.75,
    aabb=((-2.0,) * 3, (2.0,) * 3), near_far=(2.0, 6.0),
    density_n_comp=4, app_n_comp=6, app_dim=8, feature_c=16, vel_hidden=16,
    # density raised (cf. tests/test_fields.py:112) so that acc is not ~0
    density_shift=-4.0, distance_scale=25.0,
    alpha_mask_thres=1e-4, raymarch_weight_thres=1e-4, max_n_samples=64,
)
# tolerances: MLP sums and the cumprod associate differently in XLA and torch
TOL = {"rgb": (1e-5, 1e-5), "acc": (1e-5, 1e-5), "depth": (1e-5, 1e-5), "weight": (1e-4, 1e-5),
       "mask": (0.0, 0.0)}  # no segmentation head on either side: zeros


def _scene():
    """JAX params (velocity output scaled so advection moves samples by a few
    cells) as a numpy tree, and the two metas."""
    jmeta = jkplane.KPlaneMeta(**META)
    tree = jax.tree.map(np.asarray, jkplane.init_params(jax.random.PRNGKey(0), jmeta))
    last = tree["vel"]["weight_net"][-1]
    last["w"], last["b"] = last["w"] * 20.0, last["b"] * 20.0
    return tree, jmeta, kplane.KPlaneMeta(**META)


def _rays(n=48, dist=4.0):
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[0.3, -0.2, dist]], np.float32), (n, 1))
    d = np.concatenate([rng.randn(n, 2).astype(np.float32) * 0.25,
                        -np.ones((n, 1), np.float32)], -1)
    return o, d


@functools.lru_cache(maxsize=None)
def _jax_render_fn(meta, steps):
    return jax.jit(functools.partial(jkplane.render_rays, meta=meta, key=None,
                                     training=False, white_bg=True, adv_steps=steps))


# a keyframe, between keyframes, a tie between keyframes (rounds half to even)
# and past tmax (several RK2 steps)
@pytest.mark.parametrize("t", [0.5, 0.6, 0.375, 0.95])
def test_render_rays_matches_jax(t):
    tree, jmeta, tmeta = _scene()
    o, d = _rays()
    steps = jkplane.render_steps_for_time(jmeta, t)
    want = _jax_render_fn(jmeta, steps)(jax.tree.map(jnp.asarray, tree), t=jnp.float32(t),
                                        rays_o=jnp.asarray(o), rays_d=jnp.asarray(d))
    got = kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"), tmeta, t, o, d,
                             white_bg=True, adv_steps=steps, device="cpu")
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    assert got["mask"].shape == (len(o), 3) and got["mask"].dtype == got["rgb"].dtype
    assert np.asarray(want["mask"]).dtype == got["mask"].numpy().dtype
    acc = np.asarray(want["acc"])
    assert acc.mean() > 0.2, acc.mean()
    assert (np.asarray(want["weight"]) > META["raymarch_weight_thres"]).mean() > 0.05


def test_render_image_pads_the_last_chunk_like_jax():
    """35 rays in chunks of 16: the last chunk is padded with zero origins,
    which lie inside the box, so that chunk starts every ray at `near`
    instead of its box entry (JAX renderer.py:83 + kplane.py:672-677).  The
    port pads identically and so renders the same image."""
    tree, jmeta, tmeta = _scene()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.1, 6.0]  # box entry at ~4 > near = 2
    o, d = rays.ray_bundle(pose, 5, 7, 9.0)
    t = 0.6
    want = jrender_image(jax.tree.map(jnp.asarray, tree), jmeta, t, o, d, white_bg=True, chunk=16)
    params = checkpoint.params_from_numpy(tree, "cpu")
    got = render_image(params, tmeta, t, o, d, white_bg=True, chunk=16, device="cpu")
    for k in ("rgb", "acc", "depth", "mask"):
        rtol, atol = TOL[k]
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
    assert got["mask"].shape == (5, 7, 3)
    # the quirk: the last 3 rays rendered unpadded start at their box entry
    alone = kplane.render_rays(params, tmeta, t, o.reshape(-1, 3)[32:], d.reshape(-1, 3)[32:],
                               white_bg=True, adv_steps=1, device="cpu")
    assert np.abs(alone["depth"].numpy() - got["depth"].reshape(-1)[32:]).max() > 1e-3
    head = kplane.render_rays(params, tmeta, t, o.reshape(-1, 3)[:16], d.reshape(-1, 3)[:16],
                              white_bg=True, adv_steps=1, device="cpu")
    np.testing.assert_allclose(head["depth"].numpy(), got["depth"].reshape(-1)[:16],
                               rtol=1e-6, atol=1e-6)


def test_checkpoints_cross_both_ways(tmp_path):
    tree, jmeta, tmeta = _scene()
    o, d = _rays(n=24)
    jpath = str(tmp_path / "jax_model")
    jcheckpoint.save(jpath, jax.tree.map(jnp.asarray, tree), jmeta, extra={"global_step": 7})
    params, meta, opt_state, alpha_state, extra = checkpoint.load(jpath, device="cpu")
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    assert (opt_state, alpha_state, extra) == (None, None, {"global_step": 7})
    want = _jax_render_fn(jmeta, 1)(jax.tree.map(jnp.asarray, tree), t=jnp.float32(0.6),
                                    rays_o=jnp.asarray(o), rays_d=jnp.asarray(d))
    got = kplane.render_rays(params, meta, 0.6, o, d, white_bg=True, adv_steps=1, device="cpu")
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)

    tpath = str(tmp_path / "torch_model")
    checkpoint.save(tpath, params, tmeta, extra={"global_step": 8})
    jparams, jmeta2, _, _, jextra = jcheckpoint.load(tpath)
    assert jmeta2 == jmeta and jextra == {"global_step": 8}
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bat_meta_matches_jax_field_by_field():
    path = os.path.join(REPO, "configs", "synth", "bat.yaml")
    metas = []
    for load, reso, mod in ((jload_config, jn_to_reso, jkplane), (load_config, n_to_reso, kplane)):
        cfg = load(path)
        aabb = np.stack([np.asarray(cfg.nvfi.bbox_x), np.asarray(cfg.nvfi.bbox_y),
                         np.asarray(cfg.nvfi.bbox_z)], axis=-1)
        grid = reso(int(cfg.nvfi.N_voxel_final), aabb)
        assert grid == [199, 199, 199]
        meta = mod.meta_from_cfg(cfg.nvfi, aabb, grid, (cfg.dataset.near, cfg.dataset.far))
        metas.append(mod.eval_exact_meta(meta))
    jmeta, tmeta = metas
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    assert (tmeta.n_samples, tmeta.render_adv_steps, tmeta.shade_fraction) == (686, 11, 1.0)
    assert kplane.render_steps_for_time(tmeta, 0.9) == jkplane.render_steps_for_time(jmeta, 0.9)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, nvfi_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(nvfi_torch.__path__, 'nvfi_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nvfi_tpu')]\n"
        "assert not bad, bad\n"
        "for name in ('eval.harness', 'eval.metrics', 'utils.viz', 'ops.occupancy',\n"
        "             'ops.gather', 'ops.resize', 'physics.pde', 'train.optim',\n"
        "             'train.trainer', 'data.synthetic', 'data.blender', 'utils.png',\n"
        "             'train_nvfi', 'fields.mask_field', 'ops.knn', 'utils.seg_loss',\n"
        "             'train.segm', 'eval.segm_metrics', 'utils.point_viz', 'utils.gif',\n"
        "             'train_segm', 'test_segm_render', 'test_transfer_vel',\n"
        "             'ops.plane_line', 'fields.tensorf_vm', 'train.static'):\n"
        "    assert 'nvfi_torch.' + name in sys.modules, name\n"
        "print(len([m for m in sys.modules if m.startswith('nvfi_torch.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 26


def test_default_device_is_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    tree, jmeta, tmeta = _scene()
    params = checkpoint.params_from_numpy(tree, "cpu")
    o, d = _rays(n=4)
    path = str(tmp_path / "m")
    checkpoint.save(path, params, tmeta)
    cfg = load_config(os.path.join(REPO, "configs", "synth", "bat.yaml"))
    scene = make_synthetic_scene(n_train=2, n_val=1, n_test=1, H=4, W=4)
    calls = [
        lambda: kplane.init_params(torch.Generator().manual_seed(0), tmeta),
        lambda: kplane.render_rays(params, tmeta, 0.5, o, d, white_bg=True),
        lambda: render_image(params, tmeta, 0.5, o[None], d[None], white_bg=True),
        lambda: checkpoint.load(path),
        lambda: Trainer(cfg, scene),
        lambda: train_nvfi.main(["--config", os.path.join(REPO, "configs", "synth", "bat.yaml"),
                                 "--synthetic", "--logdir", str(tmp_path / "run")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


# the segmentation head, motion transfer (they run, and the options still
# refused under them raise) and the samplings, shaders and density decoder of
# ROADMAP A3 are ported; the rest is refused
PORTED = ({"mask_params": {}}, {"transfer_vel": True}, {"ray_sampling": "ndc"},
          {"ray_sampling": "contracted"}, {"shading_mode": "SH"},
          {"density_mode": "DensityLinear"}, {"shading_mode": "MLP_Fea"},
          {"transfer_vel": True, "ray_sampling": "ndc"})


@pytest.mark.parametrize("change", [
    {"ray_sampling": "ndc"}, {"ray_sampling": "contracted"},
    {"shade_reuse": False, "shade_fraction": 0.25},
    {"shade_reuse": False, "compute_dtype": "bfloat16"},
    {"compute_dtype": "float16"}, {"shading_mode": "SH"},
    {"density_mode": "DensityLinear"}, {"shading_mode": "MLP_Fea"}, {"mask_params": {}},
    {"training": True, "jitter": np.zeros((4, 1), np.float32), "compute_dtype": "float16"},
    {"transfer_vel": True},
    {"transfer_vel": True, "ray_sampling": "ndc"},
    {"transfer_vel": True, "mask_params": {}, "mask_dim": 2, "compute_dtype": "float16"},
])
def test_unported_options_raise(change):
    tree, _, tmeta = _scene()
    meta_fields = {k: v for k, v in change.items() if hasattr(tmeta, k)}
    kwargs = {k: v for k, v in change.items() if k not in meta_fields}
    o, d = _rays(n=4)

    meta = dataclasses.replace(tmeta, **meta_fields)
    if "shading_mode" in change or "density_mode" in change:
        # params of the mode's shape (SH reads 27 app channels)
        meta = dataclasses.replace(meta, app_dim=27 if change.get("shading_mode") == "SH"
                                   else meta.app_dim)
        tree = jax.tree.map(np.asarray, jkplane.init_params(
            jax.random.PRNGKey(0), jkplane.KPlaneMeta(**dataclasses.asdict(meta))))

    def render():
        return kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"), meta, 0.5, o, d,
                                  white_bg=True, device="cpu", **kwargs)

    if change in PORTED:
        out = render()
        assert np.isfinite(out["rgb"].numpy()).all() and out["mask"].shape == (4, 3)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render()

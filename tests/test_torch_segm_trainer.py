"""The segmentation trainer of nvfi_torch held against the JAX package's on
the CPU: the t = 0 opacity (K1d's plain version), the forward flow, seg steps
from identical inputs with the smooth arm off and on, a 4-iteration
``train()`` from JAX's init and seed, mask checkpoints both ways, and the
three drivers (``train_segm``, ``test_segm_render``, ``test_transfer_vel``)
on ``--device cpu``.

The scene is ``test_torch_occupancy``'s with a wider density blob (about a
tenth of the box above the trainer's opacity threshold) and a 'sur'
velocity gate, so that the trainer balances foreground and background.
Tolerances: the opacity and the flow are float32 chains (rtol 1e-5 / 1e-4);
the grads of a step 5e-3 of a leaf's largest grad in float32 and 1e-9 in
float64: the rigid-fit residual is small beside the fitted positions, so its
direction, and the grad through it, carries float32 rounding of JAX's fit
~1e-3 of the leaf's scale (the port fits in float64, which leaves a tenth of
that; the two packages agree to 2e-12 in float64); after
Adam steps a parameter may differ by 1e-2 lr a step on elements whose
gradient is small against the leaf's (Adam divides by its root mean square,
so there a rounding difference becomes a visible step), the rest rtol 1e-3.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.config import CfgNode as JCfgNode
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import mask_field as jmask_field
from nvfi_tpu.fields.velocity import VelGate as JVelGate
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_tpu.train import segm as jsegm
from nvfi_tpu.utils import seg_loss as jseg_loss
from nvfi_torch import test_segm_render, test_transfer_vel, train_nvfi, train_segm
from nvfi_torch.config import CfgNode
from nvfi_torch.fields import kplane
from nvfi_torch.fields.velocity import VelGate
from nvfi_torch.train import checkpoint, optim, segm
from nvfi_torch.utils import point_viz

from test_torch_occupancy import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = {"n_object": 4, "n_iters": 4, "smooth_iter": 3, "lrate": 5e-3, "lrate_decay": 0.5,
       "lrate_decay_step": 4, "save_freq": 2, "loss_smooth_w": 0.1, "alpha_scale": 10.0,
       "n_sample_res": 14, "min_t": 0.5}
BUDGET = 512
GRAD_GAP = 5e-3  # float32 grads of a step, of the leaf's largest (see above)
FIT64_GAIN = 3.0  # the float64 fit's float32 grads, this much closer to float64's than JAX's
SUR = ((-0.45, -0.5, -0.4), (0.5, 0.4, 0.45))  # normalized surround box


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Many small eager ops: two threads beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _scene():
    tree, jmeta, tmeta = scene()
    tree = jax.tree.map(np.copy, tree)
    cd = jmeta.density_n_comp
    amp = (12.0 / cd) ** (1.0 / 3.0)
    for i, (m0, m1) in enumerate(jkplane.MAT_SPACE):
        h, w = jmeta.grid_size[m1], jmeta.grid_size[m0]
        v, u = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        blob = np.exp(-((u - 0.1) ** 2 + (v + 0.15) ** 2) / (2.0 * 0.5**2))[..., None] * amp
        tree["planes_space"][i][..., :cd] = blob.astype(np.float32)
    jmeta = dataclasses.replace(jmeta, vel_gate=JVelGate("sur", bounds=SUR))
    tmeta = dataclasses.replace(tmeta, vel_gate=VelGate("sur", bounds=SUR))
    return tree, jmeta, tmeta


def _trainers(seed=0, fit_dtype=torch.float64):
    """(JAX's SegmTrainer, the port's from JAX's MaskField init; the port's
    rigid fit in ``fit_dtype``, None for JAX's float32)."""
    tree, jmeta, tmeta = _scene()
    jt = jsegm.SegmTrainer(JCfgNode({"segmentation": dict(SEG)}), _jp(tree), jmeta, seed=seed,
                           point_budget=BUDGET)
    mp = checkpoint.params_from_numpy(jax.tree.map(np.asarray, jt.mask_params), "cpu")
    tt = segm.SegmTrainer(CfgNode({"segmentation": dict(SEG)}), checkpoint.params_from_numpy(
        tree, "cpu"), tmeta, seed=seed, point_budget=BUDGET, mask_params=mp, device="cpu",
        fit_dtype=fit_dtype)
    return jt, tt


def _points(n=BUDGET, seed=3):
    return np.random.RandomState(seed).uniform(-0.6, 0.6, (n, 3)).astype(np.float32)


def test_alpha_at_t0_matches_jax():
    jt, tt = _trainers()
    x = _points(2000)
    want = np.asarray(jt._alpha_at_t0(jnp.asarray(x)))
    got = tt.alpha_at_t0(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    thres = tt.meta.alpha_mask_thres * tt.alpha_scale
    assert 0.05 < (want > thres).mean() < 0.95
    np.testing.assert_array_equal(tt.object_bounds, jt.object_bounds)


@pytest.mark.parametrize("t", [0.5, 0.7])
def test_flow_to_matches_jax(t):
    jt, tt = _trainers()
    x = _points()
    want = np.asarray(jt._flow_to(jnp.asarray(x), jnp.float32(t)))
    got = tt.flow_to(torch.tensor(x), t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.abs(want).max() > 1e-2  # the points move
    assert tt.meta.max_adv_steps == jt.meta.max_adv_steps == 6


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """The port's leaves in JAX's leaf order (dict keys sorted)."""
    def walk(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        if isinstance(node, list):
            return [x for v in node for x in walk(v)]
        return [node.detach().numpy()]

    return walk(tree)


def _step_grads(jmp, tt, x, flow, use_smooth, dtype=np.float32):
    """The mask-param grads of one step's loss: jax.grad of JAX's loss terms
    and the port's SegmTrainer.losses, in ``dtype``; JAX's leaf order."""
    x, flow = x.astype(dtype), flow.astype(dtype)
    mp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), jmp)

    want = _leaves(jax.grad(lambda p: _jax_step_loss(p, x, flow, use_smooth))(mp))
    leaves = [p.detach().to(torch.from_numpy(x).dtype).requires_grad_(True)
              for p in optim.tree_leaves(tt.mask_params)]
    loss, _ = tt.losses(_relink(tt.mask_params, leaves), torch.tensor(x), torch.tensor(flow),
                        use_smooth)
    return want, _port_leaves(_relink(tt.mask_params, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("use_smooth", [False, True])
def test_step_grads_match_jax_in_float64(use_smooth):
    """The same loss terms in float64 on both sides: the formulas agree to
    the last places (what float32 leaves of them is rounding)."""
    jt, tt = _trainers()
    x = _points()
    flow = np.asarray(jt._flow_to(jnp.asarray(x), jnp.float32(0.6)))
    with jax.enable_x64(True):
        want_g, got_g = _step_grads(jt.mask_params, tt, x, flow, use_smooth, np.float64)
    for g, w in zip(got_g, want_g):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("t", [0.6, 0.9])
def test_float64_fit_brings_float32_grads_closer(t):
    """The port fits the rigid motions in float64 (JAX in float32): a step's
    float32 grads then lie at least FIT64_GAIN times closer to the float64
    grads than JAX's float32 grads do, on every leaf (8-20x here), and with
    the fit in float32 the port's lie as far as JAX's (within 3x)."""
    jt, tt = _trainers()
    _, t32 = _trainers(fit_dtype=None)
    x = _points()
    flow = np.asarray(jt._flow_to(jnp.asarray(x), jnp.float32(t)))
    with jax.enable_x64(True):
        exact, _ = _step_grads(jt.mask_params, tt, x, flow, True, np.float64)
    jax32, fit64 = _step_grads(jt.mask_params, tt, x, flow, True)
    _, fit32 = _step_grads(jt.mask_params, t32, x, flow, True)

    def err(g):
        return np.array([np.abs(a - b).max() / np.abs(b).max() for a, b in zip(g, exact)])

    assert (err(fit64) * FIT64_GAIN <= err(jax32)).all(), (err(fit64), err(jax32))
    assert (err(fit32) <= 3 * err(jax32)).all() and (err(jax32) <= 3 * err(fit32)).all()


def _sync(tt, mp, opt_m, opt_v, step):
    """Put JAX's MaskField and Adam state into the port's trainer."""
    tt.mask_params = checkpoint.params_from_numpy(jax.tree.map(np.asarray, mp), "cpu")
    tt.opt_m = optim.tree_leaves(checkpoint.params_from_numpy(jax.tree.map(np.asarray, opt_m),
                                                              "cpu"))
    tt.opt_v = optim.tree_leaves(checkpoint.params_from_numpy(jax.tree.map(np.asarray, opt_v),
                                                              "cpu"))
    tt.step = int(step)


@pytest.mark.parametrize("use_smooth", [False, True])
def test_three_seg_steps_match_jax(use_smooth):
    """Three steps, each from identical state (JAX's MaskField and Adam
    state put into the port's trainer) and identical xyz, flow and lr, the
    smooth arm's KNN off, then on: the loss terms; the mask-param grads
    against jax.grad; the updated params.  Adam divides by the gradient's
    root mean square, so the grads' gap (``GRAD_GAP`` of the leaf's largest)
    moves an element's update by up to lr (1 - b1) gap / ((1 - b1^t)
    sqrt(v_hat)): each element is held to twice that, and no step exceeds
    lr."""
    jt, tt = _trainers()
    x = _points()
    flow = np.asarray(jt._flow_to(jnp.asarray(x), jnp.float32(0.6)))
    mp = jt.mask_params
    opt_m = jax.tree.map(jnp.zeros_like, mp)
    opt_v = jax.tree.map(jnp.zeros_like, mp)
    step = jnp.zeros((), jnp.int32)
    for lr in (5e-3, 4e-3, 3e-3):
        _sync(tt, mp, opt_m, opt_v, step)
        before = _leaves(mp)
        want_g, got_g = _step_grads(mp, tt, x, flow, use_smooth)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_GAP * np.abs(w).max())
        gm = tt.seg_step(torch.tensor(x), torch.tensor(flow), lr, use_smooth)
        mp, opt_m, opt_v, step, wm = jt._seg_step(mp, opt_m, opt_v, step, jnp.asarray(x),
                                                  jnp.asarray(flow), jnp.float32(lr),
                                                  use_smooth=use_smooth)
        for k in ("dynamic", "smooth", "entropy", "loss"):
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, err_msg=k)
        assert tt.step == int(step)
        t = int(step)
        for g, w, b, gr, v in zip(_port_leaves(tt.mask_params), _leaves(mp), before, want_g,
                                  _leaves(opt_v)):
            v_hat = v / (1 - 0.999**t)
            tol = lr * 0.1 * GRAD_GAP * np.abs(gr).max() / ((1 - 0.9**t) * (np.sqrt(v_hat) + 1e-8))
            assert (np.abs(g - w) <= 2 * tol + 1e-7).all(), np.abs(g - w).max()
            assert np.abs(g - b).max() <= lr * (1 + 1e-4)  # an Adam step is at most lr
            assert np.median(np.abs(g - w)) < 1e-2 * lr
    assert float(wm["smooth"]) > 0 and float(wm["dynamic"]) > 0


def _jax_step_loss(p, x, flow, use_smooth):
    m = jmask_field.apply(p, jnp.asarray(x))
    l_dyn, _ = jseg_loss.dynamic_loss(jnp.asarray(x)[None], m[None], jnp.asarray(flow)[None])
    l_smooth = jseg_loss.smooth_loss(jnp.asarray(x)[None], m[None], k=4, radius=0.01)
    return l_dyn + (SEG["loss_smooth_w"] * l_smooth if use_smooth else 0.0)


def _relink(tree, leaves):
    it = iter(leaves)
    return kplane.map_params(lambda _: next(it), tree)


def test_train_four_iterations_from_jax_init_and_seed(tmp_path):
    """train() of both packages from one seed: the same host draws (no
    opacity within the packages' rounding gap of the threshold, so the same
    points pass), three steps without the smooth arm and one with it, the
    same loss and, after the four Adam steps, the same MaskField up to the
    elements whose grads lie within rounding of 0, which Adam steps by up
    to lr either way (held step by step in test_three_seg_steps_match_jax):
    the median element within 1e-2 of the summed lr; the save at iteration 2
    and 4 (save_freq 2).  The port fits in float32 here, as JAX does: the
    Adam steps of those elements follow the fit's rounding."""
    jt, tt = _trainers(seed=5, fit_dtype=None)
    seen = []
    alpha_at_t0 = tt.alpha_at_t0

    def recorded(xyz_norm):
        out = alpha_at_t0(xyz_norm)
        seen.append((xyz_norm.numpy().copy(), out.numpy().copy()))
        return out

    tt.alpha_at_t0 = recorded
    before = _leaves(jt.mask_params)
    want = jt.train(iters=4)
    got = tt.train(logdir=str(tmp_path), iters=4)
    assert len(seen) == 4
    thres = tt.meta.alpha_mask_thres * tt.alpha_scale
    for i, (xyz, alpha) in enumerate(seen):
        want_alpha = np.asarray(jt._alpha_at_t0(jnp.asarray(xyz)))
        gap = np.abs(alpha - want_alpha).max()
        margin = np.abs(alpha - thres).min()
        assert margin > gap, (f"iteration {i + 1}: an opacity lies {margin:.2e} from the "
                              f"threshold, within the packages' gap {gap:.2e}: the draws may "
                              "differ there without a fault")
        assert 0.02 < (alpha > thres).mean() < 0.98
    # the smooth term (~3e-5 here) sums the small mask differences of close
    # neighbours, which the elements stepped by rounding move most
    for k, rtol in (("dynamic", 1e-4), ("smooth", 1e-2), ("entropy", 1e-4), ("loss", 1e-4)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, err_msg=k)
    assert jt.rng.rand() == tt.rng.rand()  # the same draws consumed
    lr_total = sum(tt.learning_rate(it) for it in range(1, 5))
    moved = 0.0
    for g, w, b in zip(_port_leaves(tt.mask_params), _leaves(jt.mask_params), before):
        d = np.abs(g - w)
        assert d.max() <= 2 * lr_total and np.median(d) < 1e-2 * lr_total
        moved = max(moved, np.abs(w - b).max())
    assert moved > 0.5 * tt.learning_rate(1)  # Adam moved the params by ~lr a step
    assert sorted(os.listdir(tmp_path)) == ["mask_000002.json", "mask_000002.npz",
                                            "mask_000004.json", "mask_000004.npz"]


def test_mask_checkpoints_cross_both_ways(tmp_path):
    """A MaskField saved by JAX's SegmTrainer loads in the port to equal
    arrays with its n_object, and the port's in JAX's loader."""
    jt, tt = _trainers()
    jt.save(str(tmp_path / "jax"))
    params, meta, _, _, extra = checkpoint.load(str(tmp_path / "jax"), device="cpu")
    assert extra == {"n_object": SEG["n_object"]} and meta == tt.meta
    for g, w in zip(_port_leaves(params), _leaves(jt.mask_params)):
        np.testing.assert_array_equal(g, w)
    tt.seg_step(torch.tensor(_points()), torch.zeros(BUDGET, 3), 1e-3, False)  # params move
    tt.save(str(tmp_path / "port"))
    jparams, _, _, _, jextra = jcheckpoint.load(str(tmp_path / "port"))
    assert jextra == {"n_object": SEG["n_object"]}
    for g, w in zip(_leaves(jparams), _port_leaves(tt.mask_params)):
        np.testing.assert_array_equal(g, w)
    tt2 = segm.SegmTrainer(CfgNode({"segmentation": dict(SEG)}), tt.scene_params, tt.meta,
                           device="cpu")
    assert tt2.restore(str(tmp_path / "jax")) == {"n_object": SEG["n_object"]}
    for g, w in zip(_port_leaves(tt2.mask_params), _leaves(jt.mask_params)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the three drivers on the CPU, on tiny scenes trained by the port's CLI
# ---------------------------------------------------------------------------

CONFIG = os.path.join(REPO, "configs", "synth", "chessboard_slow_turbo.yaml")
TINY = ["experiment.train_iters", "4", "nvfi.upsamp_list", "[1,2]",
        "nvfi.update_AlphaMask_list", "[2]", "nvfi.N_voxel_init", "4096",
        "nvfi.N_voxel_final", "8192", "renderer.n_rays", "64", "nvfi.max_n_samples", "24",
        "experiment.vel_reg_n_pts", "64", "nvfi.vel_hidden", "16", "nvfi.featureC", "16"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two tiny chessboard_slow_turbo scenes (seeds 233 and 234)."""
    dirs = []
    for seed in (233, 234):
        logdir = str(tmp_path_factory.mktemp(f"scene{seed}"))
        train_nvfi.main(["--config", CONFIG, "--synthetic", "--device", "cpu", "--synth_res",
                         "16", "--synth_frames", "6", "--logdir", logdir, *TINY,
                         "experiment.randomseed", str(seed)])
        dirs.append(logdir)
    return dirs


@pytest.fixture(scope="module")
def segm_run(scenes, tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("segm"))
    tr = train_segm.main(["--scene_dir", scenes[0], "--iters", "2", "--point_budget", "256",
                          "--logdir", logdir, "--device", "cpu", "segmentation.n_sample_res",
                          "12"])
    return tr, logdir


def test_train_segm_driver_runs(segm_run):
    tr, logdir = segm_run
    assert os.path.exists(os.path.join(logdir, "mask_final.npz"))
    assert tr.n_object == 8 and tr.n_sample_res == 12 and tr.step == 2
    assert tr.mask_params["head"]["w"].shape == (128, 8)
    assert tr.object_bounds is not None  # the chessboard configs' 'sur' gate


def test_test_segm_render_driver_runs(scenes, segm_run, tmp_path):
    out = test_segm_render.main([
        "--synthetic", "--scene_dir", scenes[0], "--ckpt_segm",
        os.path.join(segm_run[1], "mask_final"), "--n_views", "2", "--alpha_grid", "16",
        "--export_points", "6", "--outdir", str(tmp_path), "--device", "cpu"])
    assert out["pred_masks"].shape == (2, 64, 64, 8)
    assert all(np.isfinite(v) for v in out["results"].values())
    # the head's slots sum to the weight kept, at most the acc
    gap = out["acc"] - out["pred_masks"].sum(-1)
    meta = out["meta"]
    assert gap.min() > -1e-5 and gap.max() <= meta.n_samples * meta.raymarch_weight_thres + 1e-5
    assert (tmp_path / "segm_metrics.txt").exists() and (tmp_path / "r_001_segm.npy").exists()
    # four iterations leave the tiny scene nearly empty: the files may hold
    # no point, and still read back
    for name in ("points_segm.ply", "flow_arrows.ply", "aabb.ply"):
        mesh = point_viz.load_ply_mesh(str(tmp_path / name))
        assert np.isfinite(mesh["vertices"]).all() and mesh["vertices"].shape[1] == 3
    assert len(point_viz.load_ply_mesh(str(tmp_path / "aabb.ply"))["edges"]) == 12


def test_test_transfer_vel_driver_runs(scenes, capsys):
    out = test_transfer_vel.main(["--synthetic", "--scene_dir", scenes[0], "--scene_dir2",
                                  scenes[1], "--n_views", "2", "--alpha_grid", "16",
                                  "--device", "cpu"])
    assert out["preds"].shape == (2, 64, 64, 3) and np.isfinite(out["psnr"]).all()
    assert "t=0 host-geometry check" in capsys.readouterr().out
    assert os.path.getsize(out["gif"]) > 0
    # the donor's velocity is grafted
    donor, _, _, _, _ = checkpoint.load(checkpoint.find_checkpoint(scenes[1]), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(out["params"]["vel"]),
                                                  optim.tree_leaves(donor["vel"])))
    # the view at t = 0 is the host's own frame at t = 0, bit for bit
    from nvfi_torch.render import rays
    from nvfi_torch.render.renderer import render_image

    H, W, focal = out["dataset"][6]
    assert out["dataset"][2]["test"][0] == 0.0
    cam = rays.Camera(out["dataset"][1]["test"][0], H, W, focal)
    host, meta, _, _, _ = checkpoint.load(checkpoint.find_checkpoint(scenes[0]), device="cpu")
    plain = render_image(host, kplane.eval_exact_meta(meta), 0.0, cam.rays_o, cam.rays_d,
                         white_bg=False, alpha_state=out["alpha_state"], device="cpu")
    np.testing.assert_array_equal(out["preds"][0], plain["rgb"])

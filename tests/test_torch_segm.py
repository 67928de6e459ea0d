"""The segmentation ops of nvfi_torch held against the JAX package on the CPU:
the MaskField, KNN, the Kabsch fit and the segmentation losses (values and
gradients), ``raw2alpha_seg`` / ``alpha2weights``, the host sampling of the
segmentation trainer (bit for bit), the segmentation metrics (exactly) and
the visualization copies.

Inputs are made with numpy from fixed seeds.  Tolerances: float32 MLP and
loss sums associate differently in XLA and torch (rtol 1e-5 unless stated);
KNN's indices are compared modulo ties (``torch.topk`` does not promise
``lax.top_k``'s lower-index-first order among equal distances), through the
coordinates of the neighbours.
"""


import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.eval import segm_metrics as jsm
from nvfi_tpu.fields import mask_field as jmask_field
from nvfi_tpu.ops import compositing as jcompositing
from nvfi_tpu.ops.knn import knn as jknn
from nvfi_tpu.train import segm as jsegm
from nvfi_tpu.utils import point_viz as jpv
from nvfi_tpu.utils import seg_loss as jseg_loss
from nvfi_tpu.utils import viz as jviz
from nvfi_torch.eval import segm_metrics as sm
from nvfi_torch.fields import mask_field
from nvfi_torch.fields.kplane import map_params
from nvfi_torch.ops import compositing
from nvfi_torch.ops.knn import knn
from nvfi_torch.train import checkpoint, segm
from nvfi_torch.utils import point_viz as pv
from nvfi_torch.utils import seg_loss
from nvfi_torch.utils import viz


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Many small eager ops: two threads beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# MaskField
# ---------------------------------------------------------------------------

def test_mask_field_init_has_jax_layout_and_law():
    """The port's init: JAX's tree and shapes, torch.nn.Linear's bounds."""
    want = jmask_field.init(jax.random.PRNGKey(0), n_layer=4, n_dim=128, mask_dim=8,
                            skips=(1,), point_embed_freqs=4)
    got = mask_field.init(torch.Generator().manual_seed(0), n_layer=4, n_dim=128, mask_dim=8,
                          skips=(1,), point_embed_freqs=4, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), want)
    assert map_params(lambda x: tuple(x.shape), got) == shapes
    for layer in got["layers"] + [got["head"]]:
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert float(layer["w"].abs().max()) <= bound and float(layer["b"].abs().max()) <= bound
        assert float(layer["w"].std()) > 0.4 * bound


@pytest.mark.parametrize("act,skips,freqs", [("softmax", (), 0), ("sigmoid", (1,), 4),
                                             ("raw", (0, 2), 2)])
def test_mask_field_apply_matches_jax(act, skips, freqs):
    """JAX's init carried across unchanged; the three activations, skips and
    the Fourier embedding."""
    tree = jax.tree.map(np.asarray, jmask_field.init(
        jax.random.PRNGKey(1), n_layer=4, n_dim=32, mask_dim=5, skips=skips,
        point_embed_freqs=freqs))
    x = np.random.RandomState(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = jmask_field.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), skips=skips,
                             embed_freqs=freqs, mask_act=act)
    got = mask_field.apply(checkpoint.params_from_numpy(tree, "cpu"), _t(x), skips=skips,
                           embed_freqs=freqs, mask_act=act)
    _close(got, want, rtol=1e-5, atol=1e-6)
    if act == "softmax":
        _close(got.sum(-1), np.ones(300), atol=1e-6)


# ---------------------------------------------------------------------------
# KNN
# ---------------------------------------------------------------------------

def _cloud(n, seed, dup=0.3):
    """Points in a 0.2 box with a share of exact duplicates (the trainer
    resamples with replacement)."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    take = rng.rand(n) < dup
    base[take] = base[rng.randint(0, n, take.sum())]
    return base


def _neighbour_coords(points, idx):
    """(n, k, 3) neighbour coordinates, each row's sorted lexicographically:
    duplicates tie at equal coordinates, so this compares sets modulo ties."""
    c = points[np.asarray(idx)]
    order = np.lexsort((c[..., 2], c[..., 1], c[..., 0]), axis=-1)
    return np.take_along_axis(c, order[..., None], axis=1)


# one block (n <= chunk); chunks of 96 with a padded last block
@pytest.mark.parametrize("n,chunk", [(500, 2048), (500, 96)])
def test_knn_matches_jax(n, chunk):
    pts = _cloud(n, seed=n + chunk)
    wd, wi = jknn(jnp.asarray(pts), 6, chunk=chunk)
    gd, gi = knn(_t(pts), 6, chunk=chunk)
    assert gd.shape == gi.shape == (n, 6)
    _close(gd, wd, rtol=0, atol=2e-8)  # squared distances of O(1e-2), f32
    assert np.all(np.diff(gd.numpy(), axis=1) >= 0)
    np.testing.assert_array_equal(_neighbour_coords(pts, gi.numpy()),
                                  _neighbour_coords(pts, np.asarray(wi)))
    # each point's own coordinates are among its nearest (self or a duplicate)
    assert np.all((pts[gi[:, 0].numpy()] == pts).all(-1))


# ---------------------------------------------------------------------------
# the Kabsch fit and the losses
# ---------------------------------------------------------------------------

def _rotation(rng):
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _kabsch_case(case):
    rng = np.random.RandomState(11)
    R = _rotation(rng)
    pc1 = rng.randn(3, 64, 3).astype(np.float32)
    pc2 = (pc1 @ R.T + rng.randn(3)).astype(np.float32)
    mask = rng.uniform(0.2, 1.0, (3, 64)).astype(np.float32)
    if case == "reflection":  # the best orthogonal map is a reflection: det fixed to +1
        pc2[1] = pc1[1] * np.array([1.0, 1.0, -1.0], np.float32)
    elif case == "nan":  # one slot's covariance is NaN: the identity motion
        mask[2, 5] = np.nan
    elif case == "outliers":  # corrupted points carry no weight
        pc2[0, :10] += 5.0
        mask[0, :10] = 0.0
    return pc1, pc2, mask, R


@pytest.mark.parametrize("case", ["reflection", "nan", "outliers"])
def test_fit_motion_svd_batch_matches_jax(case):
    pc1, pc2, mask, R_true = _kabsch_case(case)
    wR, wt = jseg_loss.fit_motion_svd_batch(jnp.asarray(pc1), jnp.asarray(pc2),
                                            jnp.asarray(mask))
    gR, gt = seg_loss.fit_motion_svd_batch(_t(pc1), _t(pc2), _t(mask))
    _close(gR, wR, rtol=0, atol=2e-5, msg="R")
    _close(gt, wt, rtol=0, atol=2e-5, msg="t")
    np.testing.assert_allclose(np.linalg.det(gR.numpy()), 1.0, atol=1e-5)
    if case == "nan":
        np.testing.assert_array_equal(gR[2].numpy(), np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(gt[2].numpy(), np.zeros(3, np.float32))
    if case == "outliers":
        np.testing.assert_allclose(gR[0].numpy(), R_true, atol=1e-4)
    unweighted = seg_loss.fit_motion_svd_batch(_t(pc1), _t(pc2))
    want = jseg_loss.fit_motion_svd_batch(jnp.asarray(pc1), jnp.asarray(pc2))
    _close(unweighted[0], want[0], rtol=0, atol=2e-5)


def _seg_case(n=256, k=4, seed=5):
    """Two rigid movers and a static background, duplicates included, a soft
    mask that is a function of the point (so duplicates share it) and one
    slot whose weights nearly vanish (an ill-posed fit there)."""
    rng = np.random.RandomState(seed)
    pc = _cloud(n, seed, dup=0.25)
    pc[: n // 3] += 0.5
    flow = np.zeros_like(pc)
    R = _rotation(rng)
    flow[: n // 3] = pc[: n // 3] @ R.T * 0.1 - pc[: n // 3] * 0.1 + 0.05
    flow[n // 3: 2 * n // 3] = np.array([0.0, -0.03, 0.02], np.float32)
    W = rng.randn(3, k).astype(np.float32) * 8.0
    logits = pc @ W
    logits[:, -1] = -30.0  # the near-empty slot
    return pc[None], flow.astype(np.float32)[None], logits[None].astype(np.float32)


def _value_and_grad(fn_j, fn_t, pc, other, logits):
    """The loss of softmax(logits) and its gradient with respect to the
    logits, in each package, the gradient summed over each group of equal
    points: the logits are a function of the point, as a MaskField's are,
    and KNN may pick another of two equal points than JAX does (a tie), so
    only the sum over the group is the same."""
    def jloss(lg):
        return fn_j(jnp.asarray(pc), jax.nn.softmax(lg, -1), other)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = _t(logits).requires_grad_(True)
    got = fn_t(_t(pc), torch.softmax(lg, -1), other)
    (got_g,) = torch.autograd.grad(got, lg)
    _, group = np.unique(pc.reshape(-1, 3), axis=0, return_inverse=True)
    group = group.reshape(-1)

    def by_group(g):
        g = np.asarray(g).reshape(-1, logits.shape[-1])
        out = np.zeros((group.max() + 1, g.shape[1]), np.float64)
        np.add.at(out, group, g)
        return out

    return got, by_group(got_g), want, by_group(want_g)


def test_dynamic_loss_value_and_grad_match_jax():
    pc, flow, logits = _seg_case()
    got, got_g, want, want_g = _value_and_grad(
        lambda p, m, f: jseg_loss.dynamic_loss(p, m, jnp.asarray(f))[0],
        lambda p, m, f: seg_loss.dynamic_loss(p, m, _t(f))[0], pc, flow, logits)
    _close(got, want, rtol=1e-5)
    _close(got_g, want_g, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want_g)).max()))
    assert float(want) > 1e-3 and np.abs(np.asarray(want_g)).max() > 0
    mixed = seg_loss.dynamic_loss(_t(pc), torch.softmax(_t(logits), -1), _t(flow))[1]
    want_mixed = jseg_loss.dynamic_loss(jnp.asarray(pc), jax.nn.softmax(jnp.asarray(logits)),
                                        jnp.asarray(flow))[1]
    _close(mixed, want_mixed, rtol=0, atol=2e-5)


@pytest.mark.parametrize("radius,loss_norm", [(1e-3, 1), (3e-4, 1), (1e-3, 2)])
def test_smooth_loss_value_and_grad_match_jax(radius, loss_norm):
    """Duplicates (diff exactly 0: |x|'s derivative there is JAX's +1) and
    out-of-radius neighbours (replaced by self) in both norms; the radius is
    compared with squared distances."""
    pc, _, logits = _seg_case(seed=9)
    got, got_g, want, want_g = _value_and_grad(
        lambda p, m, _: jseg_loss.smooth_loss(p, m, k=4, radius=radius, loss_norm=loss_norm),
        lambda p, m, _: seg_loss.smooth_loss(p, m, k=4, radius=radius, loss_norm=loss_norm),
        pc, None, logits)
    _close(got, want, rtol=1e-5, atol=1e-7)
    _close(got_g, want_g, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want_g)).max()))
    dist = knn(_t(pc[0]), 4)[0].numpy()
    out = (dist > radius).mean()
    assert 0.02 < out < 0.98, out  # both kinds of neighbour present
    assert (dist[:, 1] == dist[:, 0]).mean() > 0.1  # duplicates


def test_entropy_and_rank_losses_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 200, 6).astype(np.float32) * 3
    logits[0, :20] = [40, 0, 0, 0, 0, 0]  # saturated rows hit the clip at 1e-5
    for jfn, tfn in ((jseg_loss.entropy_loss, seg_loss.entropy_loss),
                     (jseg_loss.rank_loss, seg_loss.rank_loss)):
        want, want_g = jax.value_and_grad(lambda lg: jfn(jax.nn.softmax(lg, -1)))(
            jnp.asarray(logits))
        lg = _t(logits).requires_grad_(True)
        got = tfn(torch.softmax(lg, -1))
        (got_g,) = torch.autograd.grad(got, lg)
        _close(got, want, rtol=1e-5)
        _close(got_g, want_g, rtol=1e-3, atol=1e-4 * float(np.abs(np.asarray(want_g)).max()))


def test_raw2alpha_seg_and_alpha2weights_match_jax():
    rng = np.random.RandomState(2)
    sigma = rng.exponential(2.0, (3, 16, 24)).astype(np.float32)
    dist = rng.uniform(0.0, 0.2, (16, 24)).astype(np.float32)
    want = jcompositing.raw2alpha_seg(jnp.asarray(sigma), jnp.asarray(dist))
    got = compositing.raw2alpha_seg(_t(sigma), _t(dist))
    for g, w, name in zip(got, want, ("alpha", "weights", "bg_T")):
        assert g.shape == w.shape, name
        _close(g, w, rtol=1e-5, atol=1e-7, msg=name)
    alpha = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    _close(compositing.alpha2weights(_t(alpha)), jcompositing.alpha2weights(jnp.asarray(alpha)),
           rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the trainer's host sampling (bit for bit) and the metrics (exactly)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perturb", [True, False])
def test_sample_volume_points_is_jax_bit_for_bit(perturb):
    bounds = np.array([[-2.02, 2.02], [-1.5, 2.5], [-2.5, 1.5]], np.float32)
    want = jsegm.sample_volume_points(np.random.RandomState(3), bounds, 17, perturb)
    got = segm.sample_volume_points(np.random.RandomState(3), bounds, 17, perturb)
    assert got.dtype == np.float32 and got.shape == (17, 17, 17, 3)
    np.testing.assert_array_equal(got, want)


def test_balanced_sample_is_jax_bit_for_bit():
    rng = np.random.RandomState(8)
    xyz = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    box = np.array([[-1.0, 1.0]] * 3, np.float32)
    a, b = np.random.RandomState(1), np.random.RandomState(1)
    want, got = jsegm.balanced_sample(a, xyz, box), segm.balanced_sample(b, xyz, box)
    np.testing.assert_array_equal(got, want)
    assert a.rand() == b.rand()  # the same draws consumed
    fg = np.all((xyz > box[:, 0]) & (xyz < box[:, 1]), -1).sum()
    assert len(got) == 2 * fg


def _segm_case(seed, views=3, n=400, k=5):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 4, (views, n)) * 3  # non-consecutive ids
    logits = rng.randn(views, n, k) + 2.5 * np.eye(k)[np.minimum(gt // 3, k - 1)]
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return gt, mask.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_segm_metrics_equal_jax_exactly(seed):
    gt, mask = _segm_case(seed)
    want, got = [], []
    for mod, out in ((jsm, want), (sm, got)):
        for v in range(len(gt)):
            i, m, c, n = mod.eval_segm(gt[v], mask[v], ignore_npoint_thresh=60)
            out += [i, m, c, n, mod.clustering_miou(mask[v], mod.compress_label(gt[v])),
                    mod.rand_index(mask[v], gt[v]),
                    mod.align_insts(mod.compress_label(gt[v]), mask[v].argmax(-1))]
        ious, matched, conf, n_inst = mod.accumulate_eval_results(gt, mask)
        out += [ious, matched, conf, n_inst, mod.calculate_AP(matched, conf, n_inst),
                mod.calculate_PQ_F1(ious, matched, n_inst)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert 0.0 < want[-2] <= 1.0  # AP


def test_viz_and_point_viz_equal_jax(tmp_path):
    """The segmentation colorizer, the PLY point cloud and the PLY meshes
    (spheres, arrows, the bbox line set) write the JAX package's bytes."""
    rng = np.random.RandomState(3)
    segm_ids = rng.randint(0, 12, (5, 7))
    for bg in (False, True):
        np.testing.assert_array_equal(viz.build_segm_vis(segm_ids, bg),
                                      jviz.build_segm_vis(segm_ids, bg))
    pc = rng.randn(20, 3).astype(np.float32)
    flow = rng.randn(20, 3) * 0.1
    flow[:4] = 0.0  # still points become balls
    labels = rng.randint(0, 25, 20)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    colors = rng.rand(20, 3)
    for mod, root in ((viz, a), (jviz, b)):
        mod.save_ply(str(root / "pc.ply"), pc, colors)
    for pmod, root in ((pv, a), (jpv, b)):
        pmod.save_ply_mesh(str(root / "balls.ply"), pmod.pc_segm_to_sphere(pc, labels, 0.01))
        pmod.save_ply_mesh(str(root / "arrows.ply"), pmod.pc_flow_to_arrows(pc, flow, 0.004))
        (box,) = pmod.build_bbox3d(pmod.bound_to_box([np.array([[-1, 1], [-2, 2], [0, 1.5]])]))
        pmod.save_ply_mesh(str(root / "box.ply"), {"vertices": box["points"],
                                                   "edges": box["edges"],
                                                   "colors": np.tile([[0, 1.0, 0]], (8, 1))})
    for name in ("pc.ply", "balls.ply", "arrows.ply", "box.ply"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    mesh = pv.load_ply_mesh(str(a / "balls.ply"))
    assert len(mesh["faces"]) == 20 * len(pv._unit_sphere()[1])

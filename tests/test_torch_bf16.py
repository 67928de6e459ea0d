"""The bf16 compute mode of nvfi_torch (``compute_dtype = "bfloat16"``) held
against the JAX package's on the CPU: the plain bf16 versions of K1, K1d and
K1b, the bf16 linear / MLP / activations, the render (eval and training), the
mask build, and the per-leaf gradients of one train loss.

Where JAX rounds.  The product chain rounds to bf16 after every op (the port
equals it bit for bit).  The VJP of a tent product's bf16 cast is a channel
reduction that XLA takes as a running bf16 sum (``grid_sample._Bf16Corners``
mirrors it).  Where a bf16 result is widened to float32 at once, XLA keeps
the float32 value (its excess precision): the velocity net's last bias add
and the shader's final division (``mlp.linear(widen=True)``,
``mlp.sigmoid(widen=True)``), and the last product of ``density_feature``
(not mirrored: the port's K1d equals K1 bit for bit, see the test).  A bias
cotangent is reduced by XLA in windows of 32 rows, rounding after every add
(not mirrored: torch sums in float32 and rounds once).  Each tolerance
below states the gap measured on this scene.

Scenes, draws and the JAX loss configuration come from
``test_torch_occupancy``, ``test_torch_render`` and ``test_torch_train``;
each JAX function of the bf16 meta is jitted once.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import mlp as jmlp
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.fields import kplane, mlp
from nvfi_torch.ops import grid_sample
from nvfi_torch.train import checkpoint, optim, trainer

import test_torch_render
import test_torch_train
from test_torch_occupancy import scene
from test_torch_train import FOCAL, HP, H, W, _draws_from_key, _flat, _jp, _tp, _torch_inputs

BF16 = torch.bfloat16


def _bf16(*metas):
    return [dataclasses.replace(m, compute_dtype="bfloat16") for m in metas]


def _share(got, want):
    """Largest |got - want| as a share of want's largest value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# K1, K1d, K1b: the plain bf16 versions
# ---------------------------------------------------------------------------

def _planes(tree):
    return ([torch.tensor(p) for p in tree["planes_space"]],
            [torch.tensor(p) for p in tree["planes_time"]])


def _coords(P, seed):
    return np.random.RandomState(seed).uniform(-1.15, 1.15, (P, 4)).astype(np.float32)


def test_bf16_plane_product_equals_jax_bit_for_bit():
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = _bf16(jmeta, tmeta)
    cd = tmeta.density_n_comp
    xyzt = _coords(4000, 90)
    jp = _jp(tree)
    fused = jax.jit(lambda a, b, x: jkplane._plane_product(a, b, x, "bfloat16"))(
        jp["planes_space"], jp["planes_time"], jnp.asarray(xyzt))
    ps, pt = _planes(tree)
    x = torch.tensor(xyzt)
    density, app = grid_sample.plane_product_reference(ps, pt, x, cd, compute_dtype=BF16)
    assert app.dtype == BF16 and density.dtype == torch.float32
    np.testing.assert_array_equal(app.float().numpy(), np.asarray(fused[:, cd:], np.float32))
    # the density: the bf16 channels summed in f32 (JAX _decode_density), in
    # another order: within f32 rounding (measured 0 on this scene)
    want_density = np.asarray(jnp.sum(fused[:, :cd], -1, dtype=jnp.float32))
    np.testing.assert_allclose(density.numpy(), want_density, rtol=1e-6, atol=1e-7)
    # field_features (the render's path, app basis in bf16) likewise
    jd, ja = jax.jit(lambda p, x: jkplane.field_features(jkplane.cast_compute(p, jmeta), jmeta,
                                                         x))(jp, jnp.asarray(xyzt))
    td, ta = kplane.field_features(kplane.cast_compute(_tp(tree), tmeta), tmeta, x)
    assert ta.dtype == BF16
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    assert (ta.float().numpy() == np.asarray(ja, np.float32)).mean() > 0.9999  # one bf16 GEMM
    # the chain is not f32 rounded once: that would differ in most elements
    f32 = grid_sample.plane_product_reference(ps, pt, x, cd)[1]
    assert (f32.to(BF16) != app).float().mean() > 0.3
    # the CPU wrappers are the plain versions and launch nothing
    n = (grid_sample.plane_product.launches_bf16, grid_sample.plane_product_density.launches_bf16)
    assert all(torch.equal(g, w) for g, w in zip(
        grid_sample.plane_product(ps, pt, x, cd, BF16), (density, app)))
    assert torch.equal(grid_sample.plane_product_density(ps, pt, x, cd, BF16), density)
    assert n == (grid_sample.plane_product.launches_bf16,
                 grid_sample.plane_product_density.launches_bf16)


def test_bf16_density_only_equals_k1s_density_and_why_jax_differs():
    """The density-only plain version (K1d's) equals the full one's density bit
    for bit, as K1d equals K1 on the card.  JAX's ``density_feature`` differs
    from its own ``field_features`` density by up to 1.5e-3 of the largest
    value on this scene: XLA keeps the chain's last product, s-chain x
    t-chain, in f32, since its only consumer is the f32 sum.  Pinned here:
    the port's chains with that product in f32 give JAX's values exactly."""
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = _bf16(jmeta, tmeta)
    cd = tmeta.density_n_comp
    xyzt = _coords(4000, 91)
    ps, pt = _planes(tree)
    x = torch.tensor(xyzt)
    dens_only = grid_sample.plane_product_reference(ps, pt, x, cd, density_only=True,
                                                    compute_dtype=BF16)
    full = grid_sample.plane_product_reference(ps, pt, x, cd, compute_dtype=BF16)[0]
    assert torch.equal(dens_only, full)
    assert torch.equal(kplane.density_feature(_tp(tree), tmeta, x)[:, 0], dens_only)
    want = np.asarray(jax.jit(lambda p, x: jkplane.density_feature(p, jmeta, x))(
        _jp(tree), jnp.asarray(xyzt)))[:, 0]
    gap = _share(dens_only.numpy(), want)
    assert 1e-4 < gap < 3e-3, gap  # measured 1.5e-3
    chains = []
    for planes, pairs in ((ps, grid_sample.MAT_SPACE), (pt, grid_sample.MAT_TIME)):
        c = None
        for p, (m0, m1) in zip(planes, pairs):
            s = grid_sample.grid_sample_2d_block(p[..., :cd], torch.stack([x[:, m0], x[:, m1]], -1),
                                                 BF16)
            c = s if c is None else c * s
        chains.append(c)
    np.testing.assert_array_equal((chains[0].float() * chains[1].float()).sum(-1).numpy(), want)


def test_bf16_plane_product_backward_matches_jax_grad():
    """The plain bf16 backward against jax.vjp of the bf16 chain: the plane
    grads and d/dxyz within 1e-6 of their largest value (measured 2.0e-7 and
    8.6e-8: f32 scatter-add order).  Without the running bf16 channel sum of
    ``_Bf16Corners`` the coordinate grad would miss by ~4e-3."""
    tree, jmeta, _ = scene()
    cd, ca = jmeta.density_n_comp, jmeta.app_n_comp
    rng = np.random.RandomState(92)
    P = 2000
    xyzt = _coords(P, 93)
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, ca).astype(np.float32)
    ga[: P // 4] = 0.0
    gd[: P // 8] = 0.0
    ga_bf16 = torch.tensor(ga).to(BF16)

    def fn(a, b, x):
        fused = jkplane._plane_product(a, b, x, "bfloat16")
        return jnp.sum(fused[..., :cd], -1, dtype=jnp.float32), fused[..., cd:]

    jp = _jp(tree)
    _, vjp = jax.vjp(jax.jit(fn), jp["planes_space"], jp["planes_time"], jnp.asarray(xyzt))
    want = vjp((jnp.asarray(gd), jnp.asarray(ga_bf16.float().numpy()).astype(jnp.bfloat16)))
    want = [np.asarray(w) for w in list(want[0]) + list(want[1])] + [np.asarray(want[2])]
    ps, pt = _planes(tree)
    x = torch.tensor(xyzt)
    plane_grads, g_xyzt = grid_sample.plane_product_backward_reference(
        ps, pt, x, cd, torch.tensor(gd), ga_bf16, BF16)
    for i, (g, w) in enumerate(zip(plane_grads, want[:6])):
        assert g.dtype == torch.float32 and np.abs(w).max() > 0
        assert _share(g.numpy(), w) <= 1e-6, f"plane {i}: {_share(g.numpy(), w):.2e}"
    assert _share(g_xyzt[:, :3].numpy(), want[6][:, :3]) <= 1e-6
    assert not g_xyzt[:, 3].any()
    # the CPU wrapper and autograd through the CPU forward are the same
    # function (the CPU's scatter-add runs in threads: its order varies)
    got = grid_sample.plane_product_backward(ps, pt, x, cd, torch.tensor(gd), ga_bf16,
                                             compute_dtype=BF16)
    leaves = [p.clone().requires_grad_(True) for p in ps + pt]
    xg = x.clone().requires_grad_(True)
    density, app = grid_sample.plane_product(leaves[:3], leaves[3:], xg, cd, BF16)
    auto = torch.autograd.grad([density, app], leaves + [xg], [torch.tensor(gd), ga_bf16])
    for other in (got[0] + [got[1]], list(auto[:6]) + [auto[6]]):
        for a, b in zip(other, plane_grads + [g_xyzt]):
            assert _share(a[..., :3].numpy() if a.shape == xg.shape else a.numpy(),
                          b[..., :3].numpy() if b.shape == xg.shape else b.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# linear, the MLPs, the activations
# ---------------------------------------------------------------------------

def _mlp_case(seed=94, n=3000, dims=(28, 32, 32, 6)):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dims[0]).astype(np.float32)
    layers = [{"w": ((rng.rand(a, b) - 0.5) * 2 / np.sqrt(a)).astype(np.float32),
               "b": ((rng.rand(b) - 0.5) * 2 / np.sqrt(a)).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    return x, layers


def _cast(layers, jax_side):
    if jax_side:
        return [{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()} for p in layers]
    return [{k: torch.tensor(v).to(BF16) for k, v in p.items()} for p in layers]


def test_bf16_linear_mlp_and_activations_equal_jax():
    x, layers = _mlp_case()
    jl, tl = _cast(layers, True), _cast(layers, False)
    y = mlp.linear(tl[0], torch.tensor(x))
    want = jax.jit(jmlp.linear)(jl[0], jnp.asarray(x))
    assert y.dtype == BF16
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(want, np.float32))
    for act, jact in ((mlp.silu, jax.nn.silu), (torch.relu, jax.nn.relu)):
        got = mlp.mlp_apply(tl, torch.tensor(x), act)
        want = jax.jit(lambda p, x: jmlp.mlp_apply(p, x, jact))(jl, jnp.asarray(x))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        # widened: the last bias add in f32, as XLA leaves it when the result
        # is widened at once
        got = mlp.mlp_apply(tl, torch.tensor(x), act, widen=True)
        want = jax.jit(lambda p, x: jmlp.mlp_apply(p, x, jact).astype(jnp.float32))(
            jl, jnp.asarray(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = torch.tensor(np.random.RandomState(95).randn(20000).astype(np.float32) * 4).to(BF16)
    jz = jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)
    for got, jfn in ((mlp.sigmoid(z), jax.nn.sigmoid), (mlp.silu(z), jax.nn.silu),
                     (mlp.sigmoid(z, widen=True),
                      lambda v: jax.nn.sigmoid(v).astype(jnp.float32))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jax.jit(jfn)(jz), np.float32))
    # f32 stays torch's own
    z32 = z.float()
    assert torch.equal(mlp.sigmoid(z32), torch.sigmoid(z32))
    assert torch.equal(mlp.silu(z32), torch.nn.functional.silu(z32))


def _xla_windowed_sum(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU reduction of a bf16 array over its rows: windows of 32 rows,
    the array padded half before and half after, each window added in order
    with a bf16 rounding after every add, repeated until 32 rows are left,
    which are added the same way."""
    while v.shape[0] > 32:
        n = v.shape[0]
        m = -(-n // 32) * 32
        lo = (m - n) // 2
        zeros = functools.partial(torch.zeros, dtype=v.dtype)
        v = torch.cat([zeros(lo, *v.shape[1:]), v, zeros(m - n - lo, *v.shape[1:])])
        w = v.reshape(m // 32, 32, *v.shape[1:])
        acc = zeros(m // 32, *v.shape[1:])
        for i in range(32):
            acc = acc + w[:, i]
        v = acc
    acc = torch.zeros(v.shape[1:], dtype=v.dtype)
    for i in range(v.shape[0]):
        acc = acc + v[i]
    return acc


def test_bf16_mlp_grads_match_jax_but_for_xlas_bias_reduction():
    """The per-leaf grads of a bf16 SiLU MLP: the weights within 2e-3 of
    their largest (measured 0 to 1.8e-3: the bf16 GEMMs' transposes), the
    biases within 3e-2 (measured 2.2e-2).  The cause of the biases' gap,
    pinned on one linear: XLA reduces a bias's bf16 cotangent over the rows
    in windows of 32 with a bf16 rounding after every add, torch sums it in
    f32 and rounds once."""
    x, layers = _mlp_case()
    G = np.random.RandomState(96).randn(x.shape[0], 6).astype(np.float32)

    def jloss(p):
        p = [{k: v.astype(jnp.bfloat16) for k, v in q.items()} for q in p]
        return jnp.sum(jmlp.mlp_apply(p, jnp.asarray(x), jax.nn.silu).astype(jnp.float32) * G)

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
    want = jax.jit(jax.grad(jloss))(jp)
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in layers]
    y = mlp.mlp_apply([{k: v.to(BF16) for k, v in p.items()} for p in tp], torch.tensor(x),
                      mlp.silu)
    (y.float() * torch.tensor(G)).sum().backward()
    for i, (p, w) in enumerate(zip(tp, want)):
        assert p["w"].grad.dtype == torch.float32  # the grads land f32 on the masters
        assert _share(p["w"].grad.numpy(), w["w"]) <= 2e-3, i
        assert _share(p["b"].grad.numpy(), w["b"]) <= 3e-2, i

    Gx = G[:, :4]  # one linear 32 -> 4 whose output's cotangent is Gx
    xs = np.random.RandomState(97).randn(x.shape[0], 32).astype(np.float32)

    def jlinear(b, g):
        p = {"w": jnp.asarray(layers[-1]["w"][:, :4]).astype(jnp.bfloat16),
             "b": b.astype(jnp.bfloat16)}
        return jnp.sum(jmlp.linear(p, jnp.asarray(xs)).astype(jnp.float32) * g)

    want_b = np.asarray(jax.jit(jax.grad(jlinear))(jnp.zeros(4), jnp.asarray(Gx)))
    g = torch.tensor(Gx).to(BF16)
    np.testing.assert_array_equal(_xla_windowed_sum(g).float().numpy(), want_b)
    assert not np.array_equal(g.sum(0).float().numpy(), want_b)


# ---------------------------------------------------------------------------
# the render: eval and training
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_bf16_render_fn(meta, steps):
    return jax.jit(functools.partial(jkplane.render_rays, meta=meta, key=None, training=False,
                                     white_bg=True, adv_steps=steps))


# a keyframe, between keyframes, past tmax (11 RK2 steps); measured gaps
# (max abs): rgb 1.8e-7 / 1.8e-7 / 6.6e-7, acc 1.8e-7 / 1.8e-7 / 1.1e-6,
# depth 1.2e-6 / 9.5e-7 / 3.6e-6, weight 6e-8 / 6e-8 / 2.3e-6: f32 rounding
# of the velocity's einsum and the compositing, which bf16 roundings then
# pass on or not
@pytest.mark.parametrize("t", [0.5, 0.6, 0.95])
def test_bf16_render_rays_matches_jax(t):
    tree, jmeta, tmeta = test_torch_render._scene()
    jmeta, tmeta = _bf16(jmeta, tmeta)
    o, d = test_torch_render._rays()
    steps = jkplane.render_steps_for_time(jmeta, t)
    want = _jax_bf16_render_fn(jmeta, steps)(_jp(tree), t=jnp.float32(t), rays_o=jnp.asarray(o),
                                             rays_d=jnp.asarray(d))
    params = checkpoint.params_from_numpy(tree, "cpu")
    got = kplane.render_rays(params, tmeta, t, o, d, white_bg=True, adv_steps=steps,
                             device="cpu")
    for k, atol in (("rgb", 5e-6), ("acc", 5e-6), ("depth", 2e-5), ("weight", 1e-5)):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)
    assert all(p.dtype == torch.float32 for p in optim.tree_leaves(params) if p is not None)
    f32 = kplane.render_rays(params, dataclasses.replace(tmeta, compute_dtype="float32"), t, o,
                             d, white_bg=True, adv_steps=steps, device="cpu")
    assert np.abs(f32["rgb"].numpy() - got["rgb"].numpy()).max() > 1e-4  # bf16 is not f32


def _grad_shares(grads, want_grads):
    got, want = _flat(grads), _flat(want_grads)
    assert sorted(got) == sorted(want)
    out = {}
    for k, w in want.items():
        g = got[k]
        if g is None:
            assert not w.any(), k
            continue
        assert g.dtype == np.float32, k
        out[k] = _share(g, w) if w.any() else float(np.abs(g).max())
    return out


# per-leaf grad tolerances, as shares of JAX's largest grad of the leaf; the
# measured gaps are in each test.  Biases: XLA's windowed bf16 reduction.
# The velocity net: its cotangent reaches it through the f32 advection, where
# a last-place difference changes a bf16 rounding now and then.
def _grad_tol(path):
    if path.endswith("/b"):
        return 0.3
    if path.startswith("vel/"):
        return 1e-2
    return 1e-3


def _assert_grads(shares):
    bad = {k: v for k, v in shares.items() if v > _grad_tol(k)}
    assert not bad, bad


def test_bf16_training_render_grads_match_jax():
    """One training render at t = 0.6 (advected): rgb within 1e-6 of JAX's
    (measured 1.8e-7), the loss to rtol 1e-5 (measured 0), per-leaf grads
    within ``_grad_tol`` (measured: planes 1.1e-5, shader and basis_mat
    weights 0, velocity weights 2.9e-3, biases 1.5e-1).  Then the same
    grads from one shared dL/drgb, JAX's: the same gaps to the last digit,
    so none enters through the forward's rgb (ROADMAP.md §C)."""
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = _bf16(jmeta, tmeta)
    o, d, target = test_torch_train._rays(24)
    key, t = jax.random.PRNGKey(31), 0.6

    def jrender(params):
        return jkplane.render_rays(params, jmeta, jnp.float32(t), jnp.asarray(o), jnp.asarray(d),
                                   key=key, training=True, white_bg=True)

    @jax.jit
    def fwd_bwd(params):  # dL/drgb of sum((rgb - target)^2), and its VJP
        rgb, vjp = jax.vjp(lambda p: jrender(p)["rgb"], params)
        g_rgb = 2.0 * (rgb - target)
        return rgb, g_rgb, vjp(g_rgb)[0]

    want_rgb, g_rgb, want_grads = fwd_bwd(_jp(tree))
    g_rgb = np.asarray(g_rgb)
    jitter = np.array(jax.random.uniform(jax.random.split(key)[0], (24, 1), jnp.float32))

    shares = {}
    for name in ("loss", "one_dl_drgb"):
        params = _tp(tree, grad=True)
        out = kplane.render_rays(params, tmeta, t, o, d, white_bg=True, training=True,
                                 jitter=jitter, device="cpu")
        if name == "loss":
            np.testing.assert_allclose(out["rgb"].detach().numpy(), np.asarray(want_rgb),
                                       rtol=0, atol=1e-6)
            loss = torch.sum((out["rgb"] - torch.tensor(target)) ** 2)
            np.testing.assert_allclose(float(loss.detach()),
                                       float(np.sum((np.asarray(want_rgb) - target) ** 2)),
                                       rtol=1e-5)
            loss.backward()
        else:
            out["rgb"].backward(torch.tensor(g_rgb))
        shares[name] = _grad_shares(kplane.map_params(lambda p: p.grad, params), want_grads)
        _assert_grads(shares[name])
    assert len(shares["loss"]) >= 19 and max(shares["loss"].values()) > 0
    assert shares["loss"]["planes_space/0"] <= 1e-4


# ---------------------------------------------------------------------------
# the mask build
# ---------------------------------------------------------------------------

def test_bf16_compute_dense_alpha_matches_jax():
    """The bf16 mask build (velocity f32, density through K1d's bf16 arm) on
    the occupancy scene's grid at 6 times: alpha within 5e-4 of JAX's
    (measured 7.6e-5: JAX's density_feature keeps its last product in f32,
    see above), and at most 3 of its 693 voxels on the other side of
    alphaMask_thres (measured 1)."""
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = _bf16(jmeta, tmeta)
    grid, n_times = (11, 9, 7), 6
    want, _ = jkplane.compute_dense_alpha(_jp(tree), jmeta, grid, n_times=n_times)
    got, _ = kplane.compute_dense_alpha(checkpoint.params_from_numpy(tree, "cpu"), tmeta, grid,
                                        n_times=n_times, device="cpu")
    want = np.asarray(want)
    assert got.dtype == torch.float32 and 0.05 < (want > tmeta.alpha_mask_thres).mean() < 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    flips = int(((got.numpy() >= tmeta.alpha_mask_thres)
                 != (want >= tmeta.alpha_mask_thres)).sum())
    assert flips <= 3, flips


# ---------------------------------------------------------------------------
# the train loss and the optimizer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_bf16_grad_fn():
    jmeta = _bf16(test_torch_train._metas(False)[0])[0]
    loss_fn = jtrainer.make_loss_fn(jmeta, jtrainer.TrainHP(**HP), "static_dynamic", H, W, FOCAL)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_bf16_train_loss_grads_match_jax_and_masters_stay_f32():
    """The per-iteration loss of ``static_dynamic`` in bf16 (both renders,
    L1, TV, the PDE loss with its bf16 filter): metrics to rtol 1e-4
    (measured 2.5e-7, the renders' and the PDE loss's 0), per-leaf grads
    within ``_grad_tol`` (measured: planes 1.1e-7, basis_mat 0, shader
    weights 1.2e-4, velocity weights 5.2e-5, biases 3.3e-2); then one Adam
    step keeps every master leaf and moment float32."""
    tree, _, _ = scene()
    _, tmeta = test_torch_train._metas(False)
    (tmeta,) = _bf16(tmeta)
    hp = trainer.TrainHP(**HP)
    key, step = jax.random.PRNGKey(51), 7
    poses, images, times, _ = _torch_inputs(False)
    (want_loss, want_metrics), want_grads = _jax_bf16_grad_fn()(
        _jp(tree), key, jnp.int32(2), jnp.int32(1), jnp.int32(step), jnp.asarray(poses.numpy()),
        jnp.asarray(images.numpy()), jnp.asarray(times.numpy()), jnp.arange(3), jnp.arange(2),
        jnp.float32(HP["L1_weight_initial"]), jnp.float32(0.0), None)
    loss_fn = trainer.make_loss_fn(tmeta, hp, "static_dynamic", H, W, FOCAL, device="cpu")
    params = _tp(tree, grad=True)
    loss, metrics = loss_fn(params, _draws_from_key(key, tmeta, hp), 2, 1, step, poses, images,
                            times, HP["L1_weight_initial"], 0.0, None)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    grads = kplane.map_params(lambda p: p.grad, params)
    shares = _grad_shares(grads, want_grads)
    _assert_grads(shares)
    assert len(shares) == 6 + 1 + 6 + 24 and shares["planes_space/0"] <= 1e-4

    state = optim.init_state(params)
    params, state = trainer._optimizer_update(params, grads, state, hp, "static_dynamic", step)
    for tree_ in (params, state["m"], state["v"]):
        assert all(p.dtype == torch.float32 for p in optim.tree_leaves(tree_) if p is not None)
    start = _flat(tree)
    assert np.abs(_flat(params)["shader/0/w"] - start["shader/0/w"]).max() > 0.5 * hp.lr_net

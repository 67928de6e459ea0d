"""The train slice of nvfi_torch held against the JAX package on the CPU: the
plain backwards of the two kernels with a gradient (``composite``,
``plane_product``) against ``jax.grad``, ``vel_accel`` and the PDE loss, the
plane regularizers, the training render, the per-iteration loss with its
per-leaf gradients, the Adam update, a short trajectory, and the optimizer
state through a checkpoint.

Inputs are made with numpy from fixed seeds; the scene (non-cubic grid
(12, 10, 9), K = 4, 4 + 6 channels, 32 samples a ray, a density blob, a
velocity net scaled up so that advection moves samples) and its JAX-built
mask come from ``test_torch_occupancy``.  What the JAX package draws from its
key inside the loss is drawn here with the same key splits
(``trainer.py:228-293``, ``kplane.py:747``, ``pde.py:92-133``) and handed to
the port as a ``TrainDraws``.

Kept out of the gradient tests, because the two frameworks differ there on a
set of measure zero that box sampling does not produce: spatial coords
exactly on a grid node (``jnp.abs`` has derivative 1 at 0, ``torch.abs`` 0).
The clip's tie at ``rgb == 1`` is NOT kept out: it is the common case of a
ray that misses the box, and the port follows JAX there (derivative 0.5).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import velocity as jvelocity
from nvfi_tpu.ops.compositing import raw2alpha as jraw2alpha
from nvfi_tpu.physics import pde as jpde
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_tpu.train import optim as joptim
from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.fields import kplane, velocity
from nvfi_torch.ops import compositing, grid_sample
from nvfi_torch.physics import pde
from nvfi_torch.train import checkpoint, optim, trainer

from test_torch_occupancy import jax_mask, scene

H = W = 8
FOCAL = 6.0
N_PDE = 256
HP = dict(n_rays=32, point_batch=16 * 32, train_iters=100, vel_reg_n_pts=N_PDE,
          vel_occupied_budget=64, L1_weight_initial=8e-4, white_bg=True)
# gradients: f32 sums associate differently in XLA and torch; a leaf's
# absolute tolerance scales with its largest gradient
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 2e-5


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tp(tree, grad=False):
    params = checkpoint.params_from_numpy(tree, "cpu")
    return kplane.map_params(lambda x: x.requires_grad_(grad), params)


def _flat(tree):
    """path -> numpy array, for a tree of jax arrays, tensors, arrays or None."""
    def leaf(x):
        if x is None:
            return None
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = leaf(node)

    walk(tree, "")
    return out


def _assert_trees_close(got, want, rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL, what="grad"):
    """Leaf by leaf; a missing (None) leaf of the port is a zero gradient."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    nonzero = 0
    for path, w in want.items():
        g = got[path]
        if g is None:
            assert not w.any(), f"{what} {path}: the port has none, JAX a non-zero one"
            continue
        nonzero += bool(w.any())
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {path}")
    return nonzero


# ---------------------------------------------------------------------------
# (a) composite: the plain backward, with the clip's tie
# ---------------------------------------------------------------------------

def _jcomposite(sigma, dist, z, rgb_pts, thres, white_bg, far):
    """The JAX package's dense compositing: raw2alpha and the per-ray sums of
    kplane.render_rays (:886-990), which has no function of its own there."""
    _, weight, _ = jraw2alpha(sigma, dist)
    app_mask = weight > thres
    acc = jnp.sum(weight, axis=-1)
    rgb = jnp.sum(weight[..., None] * jnp.where(app_mask[..., None], rgb_pts, 0.0), axis=-2)
    if white_bg:
        rgb = rgb + (1.0 - acc[..., None])
    rgb = jnp.clip(rgb, 0.0, 1.0)
    depth = jnp.sum(weight * z, axis=-1) + (1.0 - acc) * far
    return weight, acc, rgb, depth


def _composite_case(N=7, S=40):
    rng = np.random.RandomState(11)
    sigma = (np.abs(rng.randn(N, S)) * 0.3).astype(np.float32)
    sigma[rng.rand(N, S) < 0.3] = 0.0
    sigma[0] = 0.0  # a ray that misses the box: rgb == 1 exactly over white
    sigma[1, 5] = 1e3  # a saturated sample: alpha rounds to 1, keep is 1e-10
    sigma[2, 3:] = 0.0
    dist = np.full((N, S), 1.25, np.float32)
    dist[:, -1] = 0.0
    z = (2.0 + 0.05 * np.arange(S, dtype=np.float32))[None].repeat(N, 0)
    rgb_pts = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    rgb_pts[3] = 1.5  # composites to more than 1 before the clip over white
    grads = [rng.randn(*s).astype(np.float32) for s in ((N, S), (N,), (N, 3), (N,))]
    return (sigma, dist, z, rgb_pts), grads


@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_backward_matches_jax_grad(white_bg):
    args, grads = _composite_case()
    thres, far = 1e-2, 6.0  # a threshold that masks a good share of the samples

    def scalar(sigma, rgb_pts):
        outs = _jcomposite(sigma, args[1], args[2], rgb_pts, thres, white_bg, far)
        return sum(jnp.sum(o * g) for o, g in zip(outs, grads))

    want = jax.jit(jax.grad(scalar, argnums=(0, 1)))(jnp.asarray(args[0]),
                                                     jnp.asarray(args[3]))
    weight = np.asarray(_jcomposite(*map(jnp.asarray, args), thres, white_bg, far)[0])
    assert 0.1 < (weight > thres).mean() < 0.9

    t_args = [torch.tensor(a) for a in args]
    g_weight, g_acc, g_rgb, g_depth = [torch.tensor(g) for g in grads]
    got = compositing.composite_backward_reference(*t_args, g_rgb, g_acc, g_depth, g_weight,
                                                   thres, white_bg, far)
    # the wrapper takes the plain backward for CPU tensors, as does autograd
    # through the CPU forward
    via_wrapper = compositing.composite_backward(*t_args, None, None, g_rgb, g_acc, g_depth,
                                                 g_weight, thres, white_bg, far)
    leaves = [t_args[0].clone().requires_grad_(True), t_args[3].clone().requires_grad_(True)]
    outs = compositing.composite(leaves[0], t_args[1], t_args[2], leaves[1], thres, white_bg, far)
    via_autograd = torch.autograd.grad(
        sum((o * g).sum() for o, g in zip(outs, (g_weight, g_acc, g_rgb, g_depth))), leaves)
    for name, g, w in zip(("sigma", "rgb_pts"), got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and np.abs(w).max() > 0
        # rtol 1e-4: the cumprod and its transpose associate differently
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    for other in (via_wrapper, via_autograd):
        for g, o in zip(got, other):
            assert torch.equal(g, o)

    # the tie: ray 0 composites to exactly 1 (white) or 0 (black), where the
    # clip's derivative is 0.5; ray 3 over white is clipped, derivative 0
    rgb = np.asarray(_jcomposite(*map(jnp.asarray, args), thres, white_bg, far)[2])
    assert (rgb[0] == (1.0 if white_bg else 0.0)).all()
    only_rgb = compositing.composite_backward_reference(*t_args, g_rgb, None, None, None, thres,
                                                        white_bg, far)
    tied = jax.grad(lambda s: jnp.sum(_jcomposite(s, *map(jnp.asarray, args[1:]), thres,
                                                  white_bg, far)[2] * grads[2]))(
        jnp.asarray(args[0]))
    np.testing.assert_allclose(only_rgb[0].numpy(), np.asarray(tied), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(tied)).max())
    if white_bg:
        assert np.abs(np.asarray(tied)[0]).max() > 0  # half of it passes, not none
        assert (rgb[3] == 1.0).all() and not np.asarray(tied)[3].any()


# ---------------------------------------------------------------------------
# (b) plane_product: the plain backward (six plane grads and d/dxyz)
# ---------------------------------------------------------------------------

def test_plane_product_backward_matches_jax_grad():
    tree, jmeta, _ = scene()
    cd = jmeta.density_n_comp
    rng = np.random.RandomState(12)
    P = 400
    xyzt = rng.uniform(-1.15, 1.15, (P, 4)).astype(np.float32)  # ~13% per axis outside
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, jmeta.app_n_comp).astype(np.float32)
    ga[: P // 4] = 0.0
    gd[: P // 8] = 0.0  # samples the kernel would skip

    def scalar(planes_space, planes_time, x):
        fused = jkplane._plane_product(planes_space, planes_time, x)
        return jnp.sum(jnp.sum(fused[..., :cd], -1) * gd) + jnp.sum(fused[..., cd:] * ga)

    want = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(
        _jp(tree["planes_space"]), _jp(tree["planes_time"]), jnp.asarray(xyzt))
    ps = [torch.tensor(p) for p in tree["planes_space"]]
    pt = [torch.tensor(p) for p in tree["planes_time"]]
    plane_grads, g_xyzt = grid_sample.plane_product_backward_reference(
        ps, pt, torch.tensor(xyzt), cd, torch.tensor(gd), torch.tensor(ga))
    for i, (g, w) in enumerate(zip(plane_grads, list(want[0]) + list(want[1]))):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0
        # scatter-adds in another order
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"plane {i}")
    w = np.asarray(want[2])
    np.testing.assert_allclose(g_xyzt[:, :3].numpy(), w[:, :3], rtol=1e-4,
                               atol=1e-5 * np.abs(w).max())
    assert not g_xyzt[:, 3].any()  # by contract: no parameter sits behind the time column
    outside = (np.abs(xyzt[:, :3]) > 1).any(-1)
    assert outside.sum() > 50 and np.abs(w[outside, :3]).max() > 0

    # autograd through the CPU forward is the same function
    leaves = [p.clone().requires_grad_(True) for p in ps + pt]
    x = torch.tensor(xyzt, requires_grad=True)
    density, app = grid_sample.plane_product(leaves[:3], leaves[3:], x, cd)
    auto = torch.autograd.grad((density * torch.tensor(gd)).sum() + (app * torch.tensor(ga)).sum(),
                               leaves + [x])
    for g, a in zip(plane_grads, auto[:6]):
        assert torch.equal(g, a)
    assert torch.equal(g_xyzt[:, :3], auto[6][:, :3])
    got_planes, got_x = grid_sample.plane_product_backward(
        ps, pt, torch.tensor(xyzt), cd, torch.tensor(gd), torch.tensor(ga), want_xyz=False)
    assert got_x is None and torch.equal(got_planes[0], plane_grads[0])


# ---------------------------------------------------------------------------
# (c) vel_accel and the PDE loss
# ---------------------------------------------------------------------------

def test_vel_accel_matches_jax():
    tree, _, _ = scene()
    xt = np.random.RandomState(13).uniform(-1, 1, (300, 4)).astype(np.float32)
    want = np.asarray(jvelocity.vel_accel(_jp(tree["vel"]), jnp.asarray(xt)))
    got = velocity.vel_accel(_tp(tree)["vel"], torch.tensor(xt)).numpy()
    assert got.shape == (300, 6) and np.abs(want[:, 3:]).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # MLP sums


def _pde_draws(key, n):
    k_x, k_t, k_sel = jax.random.split(key, 3)
    return [torch.tensor(np.asarray(jax.random.uniform(k, shape)))
            for k, shape in ((k_x, (n, 3)), (k_t, (n, 1)), (k_sel, (n,)))]


@pytest.mark.parametrize("branch", ["no_budget", "budget", "prefilter"])
def test_vel_pde_loss_matches_jax(branch):
    tree, jmeta, tmeta = scene()
    key = jax.random.PRNGKey(21)
    state = jax_mask()[0]
    kwargs = {"no_budget": dict(chunk=128), "budget": dict(occupied_budget=64),
              "prefilter": dict(occupied_budget=64)}[branch]
    jkwargs, tkwargs = dict(kwargs), dict(kwargs)
    if branch == "prefilter":
        jkwargs["prefilter_state"] = {k: jnp.asarray(v) for k, v in state.items()}
        tkwargs["prefilter_state"] = checkpoint.alpha_state_from_numpy(state, "cpu")
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jpde.vel_pde_loss(p, jmeta, key, N_PDE, **jkwargs)))(_jp(tree))
    params = _tp(tree, grad=True)
    got = pde.vel_pde_loss(params, tmeta, *_pde_draws(key, N_PDE), **tkwargs)
    got.backward()
    assert float(want) > 1e-4
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)  # Jacobian sums
    grads = kplane.map_params(lambda p: p.grad, params)
    assert _assert_trees_close(grads, want_grads) == 24  # both nets: 6 layers x (w, b)
    # the filter is a filter: some points pass, some do not
    xyz = kplane.normalize_coord(tmeta, _pde_draws(key, N_PDE)[0] * 4.0
                                 + torch.tensor(tmeta.aabb_np[0]))
    occ = pde.occupancy_mask(_tp(tree), tmeta, xyz, torch.full((N_PDE, 1), 0.3), n_steps=1)
    assert 0.05 < float(occ.float().mean()) < 0.95


def test_vel_pde_loss_alpha_state_branch_matches_jax():
    """The mask-only filter (one trilinear lookup, K3's plain version)."""
    tree, jmeta, tmeta = scene()
    key = jax.random.PRNGKey(22)
    state = jax_mask()[0]
    want = jax.jit(lambda p: jpde.vel_pde_loss(
        p, jmeta, key, N_PDE, occupied_budget=64,
        alpha_state={k: jnp.asarray(v) for k, v in state.items()}))(_jp(tree))
    got = pde.vel_pde_loss(_tp(tree), tmeta, *_pde_draws(key, N_PDE), occupied_budget=64,
                           alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        pde.vel_pde_loss(_tp(tree), tmeta, *_pde_draws(key, N_PDE), chunk=100)


# ---------------------------------------------------------------------------
# (d) the plane regularizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["density_l1", "tv_loss_density", "tv_loss_app"])
def test_plane_regularizers_match_jax(name):
    tree, jmeta, tmeta = scene()
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: getattr(jkplane, name)(p, jmeta)))(_jp(tree))
    params = _tp(tree, grad=True)
    got = getattr(kplane, name)(params, tmeta)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)  # plane-sized sums
    n = _assert_trees_close(kplane.map_params(lambda p: p.grad, params), want_grads,
                            rtol=1e-5, atol_rel=1e-6)
    assert n == (3 if name == "tv_loss_app" else 6)


# ---------------------------------------------------------------------------
# (e) the training render
# ---------------------------------------------------------------------------

def _poses():
    """Three cameras above the box looking down -z, rays spread over it."""
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = [[0.3, 0.4, 4.0], [0.1, 0.6, 4.2], [0.2, 0.5, 3.9]]
    return poses


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = np.tile(_poses()[0, :3, 3], (n, 1))
    d = np.concatenate([rng.randn(n, 2).astype(np.float32) * 0.08,
                        -np.ones((n, 1), np.float32)], -1)
    d[0, :2] = [3.0, 3.0]  # misses the box: rgb is exactly the background
    return o, d, rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("advect,white_bg,t", [(True, True, 0.6), (False, True, 0.5),
                                                (True, False, 0.6)])
def test_training_render_matches_jax(advect, white_bg, t):
    tree, jmeta, tmeta = scene()
    o, d, target = _rays(24)
    # without a white background, a key whose coin composites over white
    key = next(k for k in map(jax.random.PRNGKey, range(31, 60))
               if white_bg or bool(jax.random.uniform(jax.random.split(k)[1], ()) < 0.5))

    def jloss(params):
        out = jkplane.render_rays(params, jmeta, jnp.float32(t), jnp.asarray(o), jnp.asarray(d),
                                  key=key, training=True, white_bg=white_bg, advect=advect)
        return jnp.sum((out["rgb"] - target) ** 2), out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_jp(tree))
    k_strat, k_bg = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_strat, (24, 1), jnp.float32))
    coin = bool(jax.random.uniform(k_bg, ()) < 0.5)

    params = _tp(tree, grad=True)
    got = kplane.render_rays(params, tmeta, t, o, d, white_bg=white_bg, training=True,
                             advect=advect, jitter=jitter, bg_coin=coin, device="cpu")
    loss = torch.sum((got["rgb"] - torch.tensor(target)) ** 2)
    loss.backward()
    tol = {"rgb": (1e-5, 1e-5), "acc": (1e-5, 1e-5), "depth": (1e-5, 1e-5),
           "weight": (1e-4, 1e-5), "z_vals": (1e-6, 1e-6)}  # as the eval render's
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    assert got["dropped_blocks"] == 0.0 == float(want["dropped_blocks"])
    assert got["dropped_shade"] == 0.0 == float(want["dropped_shade"])
    acc = np.asarray(want["acc"])
    assert acc[0] == 0.0 and acc.mean() > 0.2
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    grads = kplane.map_params(lambda p: p.grad, params)
    n = _assert_trees_close(grads, want_grads)
    vel_grad = np.abs(np.asarray(want_grads["vel"]["weight_net"][0]["w"])).max()
    assert (vel_grad > 0) == advect  # the keyframe batch does not reach the velocity net
    assert n >= (19 if advect else 13)
    assert grads["vel"]["a_weight_net"][0]["w"] is None  # the render never uses it


def test_training_render_needs_its_draws_and_eval_saves_no_graph():
    tree, _, tmeta = scene()
    o, d, _ = _rays(4)
    params = _tp(tree, grad=True)
    with pytest.raises(ValueError, match="jitter"):
        kplane.render_rays(params, tmeta, 0.5, o, d, white_bg=True, training=True, device="cpu")
    with pytest.raises(ValueError, match="bg_coin"):
        kplane.render_rays(params, tmeta, 0.5, o, d, white_bg=False, training=True,
                           jitter=np.zeros((4, 1), np.float32), device="cpu")
    out = kplane.render_rays(params, tmeta, 0.5, o, d, white_bg=True, device="cpu")
    assert not out["rgb"].requires_grad and out["rgb"].is_inference()
    # zero jitter puts the training samples on the eval positions
    train = kplane.render_rays(params, tmeta, 0.5, o, d, white_bg=True, training=True,
                               jitter=np.zeros((4, 1), np.float32), device="cpu")
    assert train["rgb"].requires_grad
    torch.testing.assert_close(train["rgb"].detach(), out["rgb"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (f) the per-iteration loss: metrics and per-leaf gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dataset():
    rng = np.random.RandomState(41)
    images = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    times = np.array([0.0, 0.5, 0.6], np.float32)  # two keyframes, one between
    return _poses(), images, times


def _metas(prune):
    _, jmeta, tmeta = scene()
    if prune:
        jmeta = dataclasses.replace(jmeta, train_occupancy_prune=True)
        tmeta = dataclasses.replace(tmeta, train_occupancy_prune=True)
    return jmeta, tmeta


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(mode, prune):
    """One jitted value-and-grad of the JAX loss per configuration."""
    jmeta, _ = _metas(prune)
    loss_fn = jtrainer.make_loss_fn(jmeta, jtrainer.TrainHP(**HP), mode, H, W, FOCAL,
                                    use_alpha=prune)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_loss_and_grads(mode, prune, tree, key, step):
    poses, images, times = _dataset()
    state = {k: jnp.asarray(v) for k, v in jax_mask()[0].items()} if prune else None
    (loss, metrics), grads = _jax_grad_fn(mode, prune)(
        _jp(tree), key, jnp.int32(2), jnp.int32(1), jnp.int32(step), jnp.asarray(poses),
        jnp.asarray(images), jnp.asarray(times), jnp.arange(3), jnp.arange(2),
        jnp.float32(HP["L1_weight_initial"]), jnp.float32(0.0), state)
    return loss, metrics, grads


def _draws_from_key(key, tmeta, hp):
    """The draws of the JAX loss for ``key``, by its key splits."""
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


def _torch_inputs(prune):
    poses, images, times = _dataset()
    state = checkpoint.alpha_state_from_numpy(jax_mask()[0], "cpu") if prune else None
    return torch.tensor(poses), torch.tensor(images), torch.tensor(times), state


# (mode, pruned mask): the three jitted JAX configurations of this file
@pytest.mark.parametrize("mode,prune", [("static_dynamic", False), ("static_dynamic", True),
                                        ("vel", False)])
def test_loss_fn_matches_jax(mode, prune):
    tree, _, _ = scene()
    _, tmeta = _metas(prune)
    hp = trainer.TrainHP(**HP)
    assert trainer.ray_chunking(tmeta, hp) == (16, 2)
    key, step = jax.random.PRNGKey(51), 7
    want_loss, want_metrics, want_grads = _jax_loss_and_grads(mode, prune, tree, key, step)

    loss_fn = trainer.make_loss_fn(tmeta, hp, mode, H, W, FOCAL, use_alpha=prune, device="cpu")
    draws = _draws_from_key(key, tmeta, hp)
    poses, images, times, state = _torch_inputs(prune)
    params = _tp(tree, grad=True)
    loss, metrics = loss_fn(params, draws, 2, 1, step, poses, images, times,
                            HP["L1_weight_initial"], 0.0, state)
    assert not loss.requires_grad
    # the port always reports the budget-exactness counts (0 on the dense branch)
    assert sorted(metrics) == sorted([*want_metrics, "dropped_blocks", "dropped_shade"])
    assert metrics["dropped_blocks"] == 0.0 and metrics["dropped_shade"] == 0.0
    for k, w in want_metrics.items():
        # rtol 1e-4: the rendered colours (1e-5) squared and summed; the PDE's Jacobian sums
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert float(want_metrics["rgb_loss_t"]) > 1e-3 and float(want_metrics["vel_pde"]) > 1e-5
    assert (float(want_metrics["rgb_loss_0"]) > 1e-3) == (mode == "static_dynamic")
    grads = kplane.map_params(lambda p: p.grad, params)
    n = _assert_trees_close(grads, want_grads)
    assert n == 6 + 1 + 6 + 24  # planes, basis_mat, shader, both velocity nets

    # one chunk of all the rays gives what the chunk-by-chunk backward gives
    hp1 = trainer.TrainHP(**{**HP, "point_batch": 1 << 20})
    assert trainer.ray_chunking(tmeta, hp1) == (hp.n_rays, 1)
    whole_fn = trainer.make_loss_fn(tmeta, hp1, mode, H, W, FOCAL, use_alpha=prune, device="cpu")
    draws1 = dataclasses.replace(draws, jitter_t=draws.jitter_t.reshape(1, hp.n_rays, 1),
                                 jitter_0=draws.jitter_0.reshape(1, hp.n_rays, 1))
    params1 = _tp(tree, grad=True)
    whole, _ = whole_fn(params1, draws1, 2, 1, step, poses, images, times,
                        HP["L1_weight_initial"], 0.0, state)
    np.testing.assert_allclose(float(whole), float(loss), rtol=1e-6)
    for a, p in zip(optim.tree_leaves(params1), optim.tree_leaves(params)):
        if a is None:
            continue
        if a.grad is None:
            assert p.grad is None
        else:  # the same terms, summed into .grad chunk by chunk
            torch.testing.assert_close(a.grad, p.grad, rtol=1e-5,
                                       atol=1e-6 * float(a.grad.abs().max()))

    # without a graph the function only evaluates
    with torch.no_grad():
        again, _ = loss_fn(_tp(tree), draws, 2, 1, step, poses, images, times,
                           HP["L1_weight_initial"], 0.0, state)
    np.testing.assert_allclose(float(again), float(loss), rtol=1e-6)


def test_pruned_mask_changes_the_loss_through_k4s_plain_version():
    """With train_occupancy_prune the mask drops samples (sample_occupied) and
    routes the PDE budget (prefilter): the loss differs from the unpruned one,
    in JAX and in the port alike (both held to JAX above)."""
    tree, _, _ = scene()
    key = jax.random.PRNGKey(51)
    pruned = _jax_loss_and_grads("static_dynamic", True, tree, key, 7)[1]
    dense = _jax_loss_and_grads("static_dynamic", False, tree, key, 7)[1]
    assert abs(float(pruned["rgb_loss_t"]) - float(dense["rgb_loss_t"])) > 1e-6
    assert abs(float(pruned["vel_pde"]) - float(dense["vel_pde"])) > 1e-9


@pytest.mark.parametrize("what", ["ndc", "mode"])
def test_make_loss_fn_refuses_what_is_not_ported(what):
    _, tmeta = _metas(False)
    if what == "mode":
        with pytest.raises(ValueError, match="mode"):
            trainer.make_loss_fn(tmeta, trainer.TrainHP(**HP), "segm", H, W, FOCAL, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.make_loss_fn(tmeta, trainer.TrainHP(**{**HP, what: True}), "static_dynamic",
                             H, W, FOCAL, device="cpu")


# ---------------------------------------------------------------------------
# (g) the Adam update and the decay schedule, on identical gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,reset", [("static_dynamic", True), ("static_dynamic", False),
                                        ("vel", True)])
def test_optimizer_update_matches_jax(mode, reset):
    tree, _, _ = scene()
    rng = np.random.RandomState(61)
    hp_kw = {**HP, "lr_upsample_reset": reset}
    jparams, params = _jp(tree), _tp(tree)
    jstate, state = joptim.init_state(jparams), optim.init_state(params)
    jupdate = jax.jit(functools.partial(jtrainer._optimizer_update,
                                        hp=jtrainer.TrainHP(**hp_kw), mode=mode))
    for step in (40, 41, 42):  # the optimizer restarted at a stage start, 40 steps in
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 1e-2, tree)
        jparams, jstate = jupdate(jparams, _jp(grads), jstate, global_step=jnp.int32(step))
        params, state = trainer._optimizer_update(params, _tp(grads), state,
                                                  trainer.TrainHP(**hp_kw), mode, step)
    assert state["step"] == int(jstate["step"]) == 3
    # tight: the same formula on the same numbers; the scalars (bias
    # corrections, decay powers) are float64 on the host here, float32 in JAX
    _assert_trees_close(params, jparams, rtol=2e-6, atol_rel=2e-7, what="param")
    _assert_trees_close(state["m"], jstate["m"], rtol=2e-6, atol_rel=2e-7, what="m")
    _assert_trees_close(state["v"], jstate["v"], rtol=2e-6, atol_rel=2e-7, what="v")
    moved = np.abs(_flat(params)["planes_space/0"] - tree["planes_space"][0]).max()
    assert (moved == 0) == (mode == "vel")
    assert np.abs(_flat(params)["vel/weight_net/0/w"] - tree["vel"]["weight_net"][0]["w"]).max() > 0


def _shared_fields(hp, jhp):
    """Every field of the port's TrainHP (those the train step reads) equals
    the JAX package's field of the same name."""
    got, want = dataclasses.asdict(hp), dataclasses.asdict(jhp)
    assert len(got) >= 20 and set(got) <= set(want)
    return all(got[k] == want[k] for k in got)


def test_schedules_match_jax():
    hp, jhp = trainer.TrainHP(**HP), jtrainer.TrainHP(**HP)
    assert _shared_fields(hp, jhp) and hp.lr_factor == jhp.lr_factor
    assert trainer.exp_schedule(262144, 8000000, 5) == jtrainer.exp_schedule(262144, 8000000, 5)
    for reset in (True, False):
        assert trainer.decay_scales(hp.lr_factor, reset, 3.0, 40.0) == \
            jtrainer.decay_scales(hp.lr_factor, reset, 3.0, 40.0)
    lr = optim.make_lr_tree(_tp(scene()[0]), 0.02, 1e-3, 5e-4)
    assert lr["planes_time"][2] == 0.02 and lr["shader"][0]["w"] == 1e-3
    assert lr["vel"]["a_weight_net"][5]["b"] == 5e-4 and lr["basis_mat"]["w"] == 1e-3
    counters = trainer.update_counters(trainer.init_counters(), {"dropped_shade": 2.0})
    assert counters == {"dropped_blocks": 0.0, "dropped_shade": 2.0}


def test_train_hp_from_the_bat_config_matches_jax():
    import os

    from nvfi_tpu.config import load_config as jload_config
    from nvfi_torch.config import load_config

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "synth", "bat.yaml")
    hp, jhp = trainer.TrainHP.from_cfg(load_config(path)), jtrainer.TrainHP.from_cfg(
        jload_config(path))
    assert _shared_fields(hp, jhp)
    assert (hp.n_rays, hp.point_batch, hp.vel_reg_n_pts, hp.vel_occupied_budget) == \
        (2048, 131072, 262144, 32768)


# ---------------------------------------------------------------------------
# (h) a five-step trajectory
# ---------------------------------------------------------------------------

def test_five_step_trajectory_matches_jax():
    tree, _, tmeta = scene()
    mode, n_steps = "static_dynamic", 5
    hp, jhp = trainer.TrainHP(**HP), jtrainer.TrainHP(**HP)
    train_step = trainer.make_train_step(tmeta, hp, mode, H, W, FOCAL, device="cpu")
    poses, images, times, _ = _torch_inputs(False)
    params, jparams = _tp(tree), _jp(tree)
    state, jstate = optim.init_state(params), joptim.init_state(jparams)
    jupdate = jax.jit(functools.partial(jtrainer._optimizer_update, hp=jhp, mode=mode))
    counters = trainer.init_counters()
    keys = jax.random.split(jax.random.PRNGKey(71), n_steps)
    steady = None  # elements whose JAX gradient stays clear of rounding noise
    for step in range(n_steps):
        want_loss, _, jgrads = _jax_loss_and_grads(mode, False, jax.tree.map(np.asarray, jparams),
                                                   keys[step], step)
        jparams, jstate = jupdate(jparams, jgrads, jstate, global_step=jnp.int32(step))
        params, state, counters, metrics = train_step(
            params, state, counters, _draws_from_key(keys[step], tmeta, hp), 2, 1, step, poses,
            images, times, HP["L1_weight_initial"], 0.0, None)
        # rtol 2e-4: the loss of parameters that have drifted apart by the
        # tolerance below, on top of one step's 1e-4
        np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=2e-4,
                                   err_msg=f"step {step}")
        clear = {k: np.abs(g) > 1e-3 * np.abs(g).max() for k, g in _flat(jgrads).items()}
        steady = clear if steady is None else {k: steady[k] & clear[k] for k in clear}
    assert counters == trainer.init_counters() and state["step"] == n_steps
    assert all(p.grad is None for p in optim.tree_leaves(params) if p is not None)
    got, want, start = _flat(params), _flat(jparams), _flat(tree)
    compared = 0
    for path, w in want.items():
        keep = steady[path]
        if not keep.any():
            continue
        compared += int(keep.sum())
        lr = hp.lr_grid if path.startswith("planes") else hp.lr_net
        assert np.abs(w - start[path])[keep].max() > 0.5 * lr  # Adam moved them: ~lr a step
        # Adam divides by sqrt(v): an element moves ~lr a step whatever its
        # gradient's size, so a relative gradient error of 2e-4 moves it by
        # well under 1e-2 lr over five steps; elements whose gradient is ever
        # under 1e-3 of the leaf's largest are rounding noise in either package
        np.testing.assert_allclose(got[path][keep], w[keep], rtol=0, atol=1e-2 * lr,
                                   err_msg=path)
    assert compared > 2000


# ---------------------------------------------------------------------------
# (i) the optimizer state through a checkpoint, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_opt_state_crosses_checkpoints_both_ways(writer, tmp_path):
    tree, jmeta, tmeta = scene()
    rng = np.random.RandomState(81)
    m = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), tree)
    v = jax.tree.map(lambda p: rng.rand(*p.shape).astype(np.float32), tree)
    path = str(tmp_path / "model_00012")
    if writer == "jax":
        jcheckpoint.save(path, _jp(tree), jmeta,
                         opt_state={"m": _jp(m), "v": _jp(v), "step": jnp.int32(12)})
        params, meta, state, alpha_state, _ = checkpoint.load(path, device="cpu")
        assert meta == tmeta and alpha_state is None and state["step"] == 12
        assert all(isinstance(x, torch.Tensor) for x in optim.tree_leaves(state["m"]))
        # the loaded state is one the port's optimizer steps on
        grads = kplane.map_params(torch.ones_like, params)
        optim.apply_updates(params, grads, state, optim.make_lr_tree(params, 0.02, 1e-3), 1.0)
        assert state["step"] == 13
        state = checkpoint.opt_state_to_numpy(checkpoint.load(path, device="cpu")[2])
    else:
        state = checkpoint.opt_state_from_numpy({"m": m, "v": v, "step": np.int32(12)}, "cpu")
        checkpoint.save(path, _tp(tree), tmeta, opt_state=state)
        _, _, state, _, _ = jcheckpoint.load(path)
    assert int(state["step"]) == 12 and np.asarray(state["step"]).dtype == np.int32
    for name, want in (("m", m), ("v", v)):
        got = _flat(state[name])
        for k, w in _flat(want).items():
            np.testing.assert_array_equal(got[k], w)

"""The CUDA kernels of nvfi_torch (K1 plane_product, its density-only entry
K1d and its backward K1b, K2 composite and its backward K2b, K3
occupancy_trilinear, K4 occupancy_nearest, K5 row_gather) held against their
plain PyTorch versions.

This file imports neither jax nor nvfi_tpu, so it also runs on a machine with
a card and no JAX:  python -m pytest --noconftest -q tests/test_torch_kernels.py
Tests marked ``cuda`` skip where there is no card.
"""

import numpy as np
import pytest
import torch

from nvfi_torch.ops import compositing, gather, grid_sample, occupancy

WRAPPERS = (grid_sample.plane_product, grid_sample.plane_product_density,
            compositing.composite, occupancy.occupancy_trilinear,
            occupancy.occupancy_nearest, gather.row_gather,
            grid_sample.plane_product_backward, compositing.composite_backward)
# the backward kernels: atomics in any order (K1b), scan association (K2b);
# the absolute part scales with the largest gradient of each output
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
MODEL_AABB = np.array([[-2.0, -1.5, -2.5], [2.0, 2.5, 1.5]], np.float32)


def _plane_case(P, seed=0, gs=(12, 10, 9), K=4, Cd=4, Ca=37):
    """Non-cubic grid, random time planes, C = 41 (not a multiple of 32), and
    coords of which ~13% per axis lie outside [-1, 1]."""
    rng = np.random.RandomState(seed)
    C = Cd + Ca
    space = [rng.uniform(0.2, 1.0, (gs[m1], gs[m0], C)).astype(np.float32)
             for m0, m1 in grid_sample.MAT_SPACE]
    time = [rng.uniform(0.5, 1.5, (K, gs[m0], C)).astype(np.float32)
            for m0, _ in grid_sample.MAT_TIME]
    xyzt = rng.uniform(-1.15, 1.15, (P, 4)).astype(np.float32)
    edge = np.array([[-1, -1, -1, -1], [1, 1, 1, 1], [0.9999, -0.3, 1.0001, 0.2], [0, 0, 0, 0]])
    xyzt[:4] = edge[:P]
    return space, time, xyzt, Cd


def _ray_case(P, Cd, Ca, seed=4, gs=(12, 10, 9), K=4, S=23):
    """The planes of ``_plane_case`` with ray-major coords, as a render chunk
    orders them: rays of S samples half a voxel apart, centred on origins in
    [-0.62, 0.62]^3, one time per ray; about 13% of the samples lie outside
    [-1, 1] on some axis."""
    space, time, _, Cd = _plane_case(P=4, seed=seed, gs=gs, K=K, Cd=Cd, Ca=Ca)
    rng = np.random.RandomState(seed)
    n = -(-P // S)
    d = rng.randn(n, 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = rng.uniform(-0.62, 0.62, (n, 1, 3)) + d * 0.09 * (np.arange(S) - (S - 1) / 2)[:, None]
    t = np.broadcast_to(rng.uniform(-1.0, 1.0, (n, 1, 1)), (n, S, 1))
    xyzt = np.concatenate([xyz, t], -1).reshape(-1, 4)[:P].astype(np.float32)
    return space, time, xyzt, Cd


def _composite_case(N, S, seed=1):
    rng = np.random.RandomState(seed)
    sigma = (np.abs(rng.randn(N, S)) * rng.uniform(0.0, 0.1, (N, 1))).astype(np.float32)
    sigma[rng.rand(N, S) < 0.3] = 0.0
    sigma[0, 5] = 1e3  # alpha rounds to exactly 1: the 1e-10 floor carries T
    dist = np.full((N, S), 1.25, np.float32)
    dist[:, -1] = 0.0
    z = np.cumsum(np.full((N, S), 0.05, np.float32), -1) + 2.0
    rgb_pts = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return sigma, dist, z, rgb_pts


def _mask_case(P, seed=2, grid=(11, 9, 7)):
    """A binary volume (gz, gy, gx) with its corner-dilated twin (numpy), a
    mask aabb that differs from the model's, and coords reaching past both;
    the first rows sit on voxel centres of the mask's own box."""
    rng = np.random.RandomState(seed)
    gx, gy, gz = grid
    vol = (rng.rand(gz, gy, gx) < 0.3).astype(np.float32)
    dil = vol.copy()
    for ax in range(3):
        idx = np.minimum(np.arange(dil.shape[ax]) + 1, dil.shape[ax] - 1)
        dil = np.maximum(dil, np.take(dil, idx, axis=ax))
    aabb = np.array([[-1.6, -1.2, -2.1], [1.7, 2.2, 1.0]], np.float32)
    xyz = rng.uniform(-1.3, 1.3, (P, 3)).astype(np.float32)
    lin = [np.linspace(-1, 1, s, dtype=np.float32) for s in grid]
    aligned = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    n = min(P // 2, len(aligned))
    xyz[:n] = aligned[:n]
    return vol, dil, aabb, xyz


def _gather_case(n, R, C, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(R, C).astype(np.float32), rng.randint(0, R, n).astype(np.int32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    for w in WRAPPERS:
        w.launches = 0
    space, time, xyzt, Cd = _plane_case(P=50)
    args = ([torch.tensor(p) for p in space], [torch.tensor(p) for p in time],
            torch.tensor(xyzt), Cd)
    for got, want in zip(grid_sample.plane_product(*args),
                         grid_sample.plane_product_reference(*args)):
        assert torch.equal(got, want)
    cargs = [torch.tensor(x) for x in _composite_case(N=3, S=40)] + [1e-4, True, 6.0]
    for got, want in zip(compositing.composite(*cargs), compositing.composite_reference(*cargs)):
        assert torch.equal(got, want)
    assert torch.equal(
        grid_sample.plane_product_density(*args),
        grid_sample.plane_product_reference(*args, density_only=True))
    vol, dil, aabb, xyz = [torch.tensor(a) for a in _mask_case(P=300)]
    bits = occupancy.occupancy_bits(vol)
    for model_aabb in (MODEL_AABB, None):
        assert torch.equal(occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, aabb),
                           occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, aabb))
        assert torch.equal(occupancy.occupancy_nearest(dil, xyz, model_aabb, aabb),
                           occupancy.occupancy_nearest_reference(dil, xyz, model_aabb, aabb))
    tab, idx = [torch.tensor(a) for a in _gather_case(40, 12, 7)]
    assert torch.equal(gather.row_gather(tab, idx), tab[idx.long()])
    # the backward wrappers, and autograd through the CPU forwards
    rng = np.random.RandomState(5)
    gd, ga = torch.tensor(rng.randn(50).astype(np.float32)), torch.tensor(
        rng.randn(50, 37).astype(np.float32))
    got = grid_sample.plane_product_backward(*args, gd, ga)
    want = grid_sample.plane_product_backward_reference(*args, gd, ga)
    assert all(torch.equal(g, w) for g, w in zip(got[0] + [got[1]], list(want[0]) + [want[1]]))
    g_rgb = torch.tensor(rng.randn(3, 3).astype(np.float32))
    got = compositing.composite_backward(*cargs[:4], None, None, g_rgb, None, None, None,
                                         *cargs[4:])
    want = compositing.composite_backward_reference(*cargs[:4], g_rgb, None, None, None,
                                                    *cargs[4:])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_reference_returns_the_colour_before_the_clip(white_bg):
    sigma, dist, z, rgb_pts = _composite_case(N=4, S=40)
    sigma[1] = 0.0  # misses everything: exactly the background colour
    rgb_pts[2] *= 3.0  # composites past 1: the clip bites
    args = [torch.tensor(x) for x in (sigma, dist, z, rgb_pts)] + [1e-4, white_bg, 6.0]
    plain = compositing.composite_reference(*args)
    with_raw = compositing.composite_reference(*args, return_raw=True)
    assert len(plain) == 4 and len(with_raw) == 5
    assert all(torch.equal(a, b) for a, b in zip(plain, with_raw))
    raw = with_raw[4]
    assert torch.equal(raw.clamp(0.0, 1.0), with_raw[2])
    assert torch.equal(raw[1], torch.full((3,), 1.0 if white_bg else 0.0))
    assert float(raw[2].max()) > 1.0 and float(with_raw[2].max()) == 1.0


def _grad_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * max(float(w.abs().max()), 1e-30))


@pytest.mark.parametrize("bad", ["g_density_shape", "g_app_shape", "g_app_dtype",
                                 "g_density_strided", "weight_shape", "g_rgb_shape",
                                 "g_acc_dtype", "g_weight_strided", "meta_device"])
def test_backward_wrappers_refuse_bad_arguments(bad):
    """The argument checks of K1b and K2b raise whatever the device (the
    launches behind them need the card)."""
    rng = np.random.RandomState(6)
    xyzt = torch.tensor(_plane_case(P=8)[2])
    gd, ga = torch.zeros(8), torch.zeros(8, 37)
    sigma, dist, z, rgb = [torch.tensor(a) for a in _composite_case(N=4, S=40)]
    more = dict(weight=torch.zeros(4, 40), g_rgb=torch.zeros(4, 3), g_acc=torch.zeros(4),
                g_weight=torch.zeros(4, 40))
    if bad == "meta_device":
        space, time, _, Cd = _plane_case(P=8)
        on_meta = lambda xs: [torch.tensor(x).to("meta") for x in xs]  # noqa: E731
        with pytest.raises(ValueError, match="unsupported device"):
            grid_sample.plane_product_backward(on_meta(space), on_meta(time), xyzt.to("meta"),
                                               Cd, gd.to("meta"), ga.to("meta"))
        with pytest.raises(ValueError, match="unsupported device"):
            compositing.composite_backward(*[x.to("meta") for x in (sigma, dist, z, rgb)],
                                           None, None, None, None, None, None, 1e-4, True, 6.0)
        return
    if bad.startswith("g_density") or bad.startswith("g_app"):
        if bad == "g_density_shape":
            gd = torch.zeros(7)
        elif bad == "g_app_shape":
            ga = torch.zeros(8, 36)
        elif bad == "g_app_dtype":
            ga = ga.double()
        else:
            gd = torch.zeros(16)[::2]
        with pytest.raises(ValueError, match="plane_product_backward"):
            grid_sample._check_plane_grad_args(xyzt, 37, gd, ga)
        return
    if bad == "weight_shape":
        more["weight"] = torch.zeros(4, 39)
    elif bad == "g_rgb_shape":
        more["g_rgb"] = torch.zeros(4, 4)
    elif bad == "g_acc_dtype":
        more["g_acc"] = more["g_acc"].double()
    else:
        more["g_weight"] = torch.tensor(rng.randn(40, 4).astype(np.float32)).t()
    with pytest.raises(ValueError, match="composite"):
        compositing._check_composite_args(sigma, dist, z, rgb, **more)
    compositing._check_composite_args(sigma, dist, z, rgb, weight=torch.zeros(4, 40),
                                      g_rgb=None)  # an absent grad is no fault


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_backward_kernel_matches_plain_on_card(P):
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    rng = np.random.RandomState(7)
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, 37).astype(np.float32)
    gd[::3], ga[::3] = 0.0, 0.0  # samples the kernel skips
    ga[1::3] = 0.0
    gd, ga = torch.tensor(gd, device=dev), torch.tensor(ga, device=dev)
    n0 = grid_sample.plane_product_backward.launches
    got_planes, got_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga)
    want_planes, want_x = grid_sample.plane_product_backward_reference(ts, tt, x, Cd, gd, ga)
    torch.cuda.synchronize()
    assert grid_sample.plane_product_backward.launches == n0 + 1
    # rows 0 and 1 of the case sit exactly on grid nodes, where abs and clamp
    # have one-sided derivatives: the kernel follows torch's rule there
    _grad_close(got_planes + [got_x], list(want_planes) + [want_x])
    assert not got_x[:, 3].any() and not got_x[::3].any()
    only_planes, none = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga, want_xyz=False)
    assert none is None
    _grad_close(only_planes, want_planes)
    none, only_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga, want_planes=False)
    assert none is None
    _grad_close([only_x], [want_x])
    # through autograd: the forward counts one K1 launch, the backward one K1b
    leaves = [p.clone().requires_grad_(True) for p in ts + tt]
    xg = x.clone().requires_grad_(True)
    n0, n1 = grid_sample.plane_product.launches, grid_sample.plane_product_backward.launches
    density, app = grid_sample.plane_product(leaves[:3], leaves[3:], xg, Cd)
    auto = torch.autograd.grad((density * gd).sum() + (app * ga).sum(), leaves + [xg])
    assert grid_sample.plane_product.launches == n0 + 1
    assert grid_sample.plane_product_backward.launches == n1 + 1
    _grad_close(auto, list(want_planes) + [want_x])
    with torch.no_grad():  # no graph: nothing saved, no backward to launch
        density, _ = grid_sample.plane_product(leaves[:3], leaves[3:], xg, Cd)
    assert not density.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("N,S", [(1, 6), (300, 686), (64, 33)])
def test_composite_backward_kernel_matches_plain_on_card(N, S, white_bg):
    dev = _card()
    sigma, dist, z, rgb = _composite_case(N=N, S=S)
    if N > 2:
        sigma[2] = 0.0  # misses everything: the clip's tie at rgb == 1 (white) or 0
    args = [torch.tensor(a, device=dev) for a in (sigma, dist, z, rgb)]
    rng = np.random.RandomState(8)
    g_weight, g_acc, g_rgb, g_depth = [
        torch.tensor(rng.randn(*s).astype(np.float32), device=dev)
        for s in ((N, S), (N,), (N, 3), (N,))]
    thres, far = 1e-3, 6.0
    leaves = [args[0].clone().requires_grad_(True), args[3].clone().requires_grad_(True)]
    n0, n1 = compositing.composite.launches, compositing.composite_backward.launches
    outs = compositing.composite(leaves[0], args[1], args[2], leaves[1], thres, white_bg, far)
    got = torch.autograd.grad(
        sum((o * g).sum() for o, g in zip(outs, (g_weight, g_acc, g_rgb, g_depth))), leaves)
    want = compositing.composite_backward_reference(*args, g_rgb, g_acc, g_depth, g_weight,
                                                    thres, white_bg, far)
    torch.cuda.synchronize()
    assert compositing.composite.launches == n0 + 1
    assert compositing.composite_backward.launches == n1 + 1
    # a weight within a last place of the threshold may fall on either side of
    # it in the two versions: leave those samples' colour grads out
    edge = ((outs[0].detach() - thres).abs() <= 1e-6 * thres)[..., None]
    _grad_close([got[0], torch.where(edge, 0.0, got[1])],
                [want[0], torch.where(edge, 0.0, want[1])])
    # the train step's case: a gradient for rgb alone
    rgb_out = compositing.composite(leaves[0], args[1], args[2], leaves[1], thres, white_bg,
                                    far)[2]
    got = torch.autograd.grad((rgb_out * g_rgb).sum(), leaves)
    want = compositing.composite_backward_reference(*args, g_rgb, None, None, None, thres,
                                                    white_bg, far)
    _grad_close([got[0], torch.where(edge, 0.0, got[1])],
                [want[0], torch.where(edge, 0.0, want[1])])
    assert rgb_out.shape == (N, 3)
    with pytest.raises(ValueError, match="dist and z_vals"):
        compositing.composite(leaves[0], args[1].clone().requires_grad_(True), args[2],
                              leaves[1], thres, white_bg, far)


@pytest.mark.parametrize("bad", ["too_large", "negative", "int64", "float64_table", "2d_idx"])
def test_row_gather_refuses_bad_arguments_on_any_device(bad):
    tab, idx = [torch.tensor(a) for a in _gather_case(10, 12, 8)]
    if bad == "too_large":
        idx[3] = 12
    elif bad == "negative":
        idx[3] = -1
    elif bad == "int64":
        idx = idx.long()
    elif bad == "float64_table":
        tab = tab.double()
    else:
        idx = idx.reshape(2, 5)
    with pytest.raises(IndexError if bad in ("too_large", "negative") else ValueError):
        gather.row_gather(tab, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_kernel_matches_plain_on_card(P):
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    n0 = grid_sample.plane_product.launches
    got = grid_sample.plane_product(ts, tt, x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd)
    torch.cuda.synchronize()
    assert grid_sample.plane_product.launches == n0 + 1
    for g, w in zip(got, want):  # tolerance: FMA contraction in the kernel
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_density_kernel_equals_the_full_kernel_on_card(P):
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    n0, n1 = grid_sample.plane_product_density.launches, grid_sample.plane_product.launches
    got = grid_sample.plane_product_density(ts, tt, x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd, density_only=True)
    full = grid_sample.plane_product(ts, tt, x, Cd)[0]
    torch.cuda.synchronize()
    assert grid_sample.plane_product_density.launches == n0 + 1
    assert grid_sample.plane_product.launches == n1 + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # FMA contraction
    assert torch.equal(got, full)  # the same body, the same channel order


# (Cd, Ca, K1.bf16's vec, K1d.bf16's vec): one case per path of the bf16
# plan; K1d.bf16 reads a copy of the Cd density channels, so its path
# follows Cd alone
BF16_PATHS = [(4, 37, 1, 1), (24, 48, 8, 8), (24, 37, 1, 8), (8, 36, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("Cd,Ca,vec,vec_d", BF16_PATHS)
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_bf16_kernels_match_plain_on_card(P, Cd, Ca, vec, vec_d):
    """K1.bf16 and K1d.bf16 against the plain bf16 version on the card: app
    equal bit for bit (the same roundings, op by op, no FMA), the densities
    within f32 summation order (K1d's with the chain's last product in f32,
    as JAX's density_feature); the gap between the two densities printed."""
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P, Cd=Cd, Ca=Ca)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    bf16 = torch.bfloat16
    planes = ts + tt
    assert grid_sample.plane_product_inputs(planes, Cd, False, bf16)[2].vec == vec
    assert grid_sample.plane_product_inputs(planes, Cd, True, bf16)[2].vec == vec_d
    counts = [(w.launches, w.launches_bf16) for w in (grid_sample.plane_product,
                                                      grid_sample.plane_product_density)]
    density, app = grid_sample.plane_product(ts, tt, x, Cd, bf16)
    dens_only = grid_sample.plane_product_density(ts, tt, x, Cd, bf16)
    want_density, want_app = grid_sample.plane_product_reference(ts, tt, x, Cd,
                                                                 compute_dtype=bf16)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_bf16) for w in (grid_sample.plane_product,
                                                    grid_sample.plane_product_density)] == \
        [(n, n_bf16 + 1) for n, n_bf16 in counts]
    assert app.dtype == bf16 and density.dtype == torch.float32
    assert torch.equal(app, want_app)
    torch.testing.assert_close(density, want_density, rtol=1e-5, atol=1e-6)  # f32 sum order
    want_dens_only = grid_sample.plane_product_reference(ts, tt, x, Cd, density_only=True,
                                                         compute_dtype=bf16)
    torch.testing.assert_close(dens_only, want_dens_only, rtol=1e-5, atol=1e-6)
    print(f"K1d.bf16 against K1.bf16's density: {float((dens_only - density).abs().max()):.3e}")
    f32 = grid_sample.plane_product(ts, tt, x, Cd)[1]
    assert (app.float() - f32).abs().max() > 0  # the arm rounds


@pytest.mark.cuda
@pytest.mark.parametrize("Cd,Ca,vec", [(4, 37, 1), (4, 36, 1), (24, 48, 8)])
@pytest.mark.parametrize("P", [1, 5000])
def test_plane_product_backward_bf16_kernel_matches_plain_on_card(P, Cd, Ca, vec, monkeypatch):
    """K1b.bf16 against the plain bf16 backward (autograd through the bf16
    chain, with the running bf16 channel sum for the tent products'
    cotangents): plane grads to f32 atomics' order, grad_xyz to the order
    of its f32 tail; through the wrapper and through autograd, on the narrow
    path and the 16-byte one; grad_xyz of two launches bit for bit; the
    backward reads the copies the forward made."""
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=P, Cd=Cd, Ca=Ca)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    rng = np.random.RandomState(7)
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, Ca).astype(np.float32)
    gd[::3], ga[::3] = 0.0, 0.0  # samples the kernel skips
    ga[1::3] = 0.0
    bf16 = torch.bfloat16
    gd, ga = torch.tensor(gd, device=dev), torch.tensor(ga, device=dev).to(bf16)
    copies = grid_sample.bf16_planes(ts + tt, Cd + Ca)
    assert grid_sample.plane_product_bwd_plan(
        Cd + Ca, Cd, [p.data_ptr() for p in copies] + [ga.data_ptr()], bf16).vec == vec
    n0 = grid_sample.plane_product_backward.launches_bf16
    got_planes, got_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga,
                                                           compute_dtype=bf16)
    again_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga, want_planes=False,
                                                 compute_dtype=bf16)[1]
    want_planes, want_x = grid_sample.plane_product_backward_reference(ts, tt, x, Cd, gd, ga,
                                                                       bf16)
    torch.cuda.synchronize()
    assert grid_sample.plane_product_backward.launches_bf16 == n0 + 2
    # rows 0 and 1 of the case sit exactly on grid nodes: torch's rule there
    _grad_close(got_planes + [got_x], list(want_planes) + [want_x])
    assert not got_x[:, 3].any() and not got_x[::3].any()
    assert torch.equal(got_x.view(torch.int32), again_x.view(torch.int32))  # no atomics
    with pytest.raises(ValueError, match="g_app"):  # the arm takes bf16 grads only
        grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga.float(), compute_dtype=bf16)
    leaves = [p.clone().requires_grad_(True) for p in ts + tt]
    xg = x.clone().requires_grad_(True)
    n0, n1 = grid_sample.plane_product.launches_bf16, \
        grid_sample.plane_product_backward.launches_bf16
    made = []
    copy = grid_sample._bf16_copy
    monkeypatch.setattr(grid_sample, "_bf16_copy", lambda p, c: made.append(c) or copy(p, c))
    density, app = grid_sample.plane_product(leaves[:3], leaves[3:], xg, Cd, bf16)
    auto = torch.autograd.grad([density, app], leaves + [xg], [gd, ga])
    assert grid_sample.plane_product.launches_bf16 == n0 + 1
    assert grid_sample.plane_product_backward.launches_bf16 == n1 + 1
    assert made == [Cd + Ca] * 6  # the forward's copies, which the backward read again
    _grad_close(auto, list(want_planes) + [want_x])


@pytest.mark.cuda
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("P", [1, 20000])
def test_occupancy_kernels_match_plain_on_card(P, renorm):
    dev = _card()
    vol, dil, aabb, xyz = [torch.tensor(a, device=dev) for a in _mask_case(P=P)]
    bits = occupancy.occupancy_bits(vol)
    model_aabb = MODEL_AABB if renorm else None
    n3, n4 = occupancy.occupancy_trilinear.launches, occupancy.occupancy_nearest.launches
    tri = occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, aabb)
    occ = occupancy.occupancy_nearest(dil, xyz, model_aabb, aabb)
    tri_want = occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, aabb)
    occ_want = occupancy.occupancy_nearest_reference(dil, xyz, model_aabb, aabb)
    torch.cuda.synchronize()
    assert occupancy.occupancy_trilinear.launches == n3 + 1
    assert occupancy.occupancy_nearest.launches == n4 + 1
    assert occ.dtype == torch.bool and tri.shape == occ.shape == (P,)
    # the kernels round every step as the plain versions do (no FMA, a true
    # division), so they agree to the last place and in every bit
    torch.testing.assert_close(tri, tri_want, rtol=0, atol=1e-6)
    assert torch.equal(tri > 0, tri_want > 0)
    assert torch.equal(occ, occ_want)
    assert bool((occ | ~(tri > 0)).all())  # K4 keeps a superset of K3 > 0
    # batches keep their shape
    if P > 1:
        assert occupancy.occupancy_trilinear(vol, bits, xyz.reshape(4, -1, 3), model_aabb,
                                             aabb).shape == (4, P // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,R,C", [(1024, 512, 128), (1, 3, 5), (3000, 700, 192), (257, 33, 7)])
def test_row_gather_kernel_matches_plain_on_card(n, R, C):
    dev = _card()
    tab, idx = [torch.tensor(a, device=dev) for a in _gather_case(n, R, C)]
    n0 = gather.row_gather.launches
    got = gather.row_gather(tab, idx)
    torch.cuda.synchronize()
    assert gather.row_gather.launches == n0 + 1
    assert torch.equal(got, gather.row_gather_reference(tab, idx))  # a copy: exact


@pytest.mark.cuda
@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_kernel_matches_plain_on_card(white_bg):
    dev = _card()
    args = [torch.tensor(a, device=dev) for a in _composite_case(N=300, S=686)]
    n0 = compositing.composite.launches
    got = compositing.composite(*args, 1e-4, white_bg, 6.0)
    want = compositing.composite_reference(*args, 1e-4, white_bg, 6.0)
    torch.cuda.synchronize()
    assert compositing.composite.launches == n0 + 1
    for g, w in zip(got, want):  # tolerance: the scan associates differently
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    # as under autograd: the kernel also stores the colour before the clip
    got = compositing._launch_composite(*args, 1e-4, white_bg, 6.0, True)
    want = compositing.composite_reference(*args, 1e-4, white_bg, 6.0, return_raw=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[2], got[4].clamp(0.0, 1.0))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=8)
    ts = [torch.tensor(p, device=dev) for p in space]
    tt = [torch.tensor(p, device=dev) for p in time]
    x = torch.tensor(xyzt, device=dev)
    with pytest.raises(ValueError):
        grid_sample.plane_product(ts, tt, x.double(), Cd)
    with pytest.raises(ValueError):
        grid_sample.plane_product([ts[0].transpose(0, 1)] + ts[1:], tt, x, Cd)
    sigma, dist, z, rgb = [torch.tensor(a, device=dev) for a in _composite_case(N=4, S=40)]
    with pytest.raises(ValueError):
        compositing.composite(sigma, dist, z, rgb[:, :, :2], 1e-4, True, 6.0)
    with pytest.raises(ValueError):
        compositing.composite(sigma.t(), dist, z, rgb, 1e-4, True, 6.0)
    with pytest.raises(ValueError):
        grid_sample.plane_product_density(ts, tt, x[:, :3].contiguous(), Cd)
    with pytest.raises(ValueError):
        grid_sample.plane_product_density(ts, [p.cpu() for p in tt], x, Cd)
    vol, dil, aabb, xyz = [torch.tensor(a, device=dev) for a in _mask_case(P=16)]
    bits = occupancy.occupancy_bits(vol)
    turned = vol.permute(2, 1, 0)  # not contiguous
    for wrapper, head, turned_head in ((occupancy.occupancy_trilinear, (bits,),
                                        (occupancy.occupancy_bits(turned),)),
                                       (occupancy.occupancy_nearest, (), ())):
        with pytest.raises(ValueError):
            wrapper(vol.double(), *head, xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(turned, *turned_head, xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, *head, xyz[:, :2].contiguous(), MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, *head, xyz, MODEL_AABB, aabb.cpu())
    with pytest.raises(ValueError):  # the cell bits: the volume's shape, int32, on the card
        occupancy.occupancy_trilinear(vol, bits[:, :-1].contiguous(), xyz, MODEL_AABB, aabb)
    with pytest.raises(ValueError):
        occupancy.occupancy_trilinear(vol, bits.float(), xyz, MODEL_AABB, aabb)
    with pytest.raises(ValueError):
        occupancy.occupancy_trilinear(vol, bits.cpu(), xyz, MODEL_AABB, aabb)
    gd, ga = torch.zeros(8, device=dev), torch.zeros(8, 37, device=dev)
    with pytest.raises(ValueError):
        grid_sample.plane_product_backward(ts, tt, x, Cd, gd[:7], ga)
    with pytest.raises(ValueError):
        grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga.cpu())
    weight = torch.zeros_like(sigma)
    with pytest.raises(ValueError):  # g_rgb needs the colour before the clip
        compositing.composite_backward(sigma, dist, z, rgb, weight, None,
                                       torch.zeros(4, 3, device=dev), None, None, None,
                                       1e-4, True, 6.0)
    with pytest.raises(ValueError):
        compositing.composite_backward(sigma, dist, z, rgb, weight[:, :39].contiguous(), None,
                                       None, None, None, None, 1e-4, True, 6.0)
    tab, idx = [torch.tensor(a, device=dev) for a in _gather_case(10, 12, 8)]
    with pytest.raises(ValueError):
        gather.row_gather(tab.t(), idx)
    with pytest.raises(ValueError):
        gather.row_gather(tab, idx.cpu())
    with pytest.raises(IndexError):
        gather.row_gather(tab, idx + 12)


RUN = grid_sample.PLANE_PRODUCT_RUN
THREADS = 256  # csrc/plane_product.cu kThreads


def _plane_product_work(plan, P, c_end):
    """The work items of one K1 (c_end = C) or K1d (c_end = Cd) launch as
    phase 2 of csrc/plane_product.cu walks them: block b owns samples
    [b*run, b*run + n), and thread t takes items t, t + THREADS, ... of the
    n * (c_end / vec) (sample, channel group) items, the group fastest.
    Returns (block, thread, sample, first channel) per item; an item covers
    channels [first, first + plan.vec)."""
    groups = c_end // plan.vec
    out = []
    for b in range(-(-P // plan.run)):
        n = min(plan.run, P - b * plan.run)
        item = np.arange(n * groups)
        out.append(np.stack([np.full_like(item, b), item % THREADS,
                             b * plan.run + item // groups, item % groups * plan.vec]))
    return tuple(np.concatenate(out, axis=1))


@pytest.mark.parametrize("C,Cd,misaligned,vec", [
    (72, 24, False, 4),  # the model's planes: the 16-byte path
    (41, 4, False, 1),   # C not a multiple of 4
    (72, 22, False, 1),  # a group would straddle the density/app split
    (72, 24, True, 1),   # a plane off a 16-byte boundary
    (8, 0, False, 4),    # no density channel
])
def test_plane_product_plan_picks_the_path(C, Cd, misaligned, vec):
    ptrs = [4096 * (k + 1) for k in range(6)]
    if misaligned:
        ptrs[4] += 4
    plan = grid_sample.plane_product_plan(C, Cd, ptrs)
    assert plan.vec == vec and plan.run == RUN
    # cell offsets (4 B) and corner weights (16 B) of six planes, and the
    # density partials (4 B a group), for each sample of the run
    assert plan.smem_bytes == RUN * (6 * 20 + Cd // vec * 4) <= 48 * 1024


RUN_BF16 = grid_sample.PLANE_PRODUCT_RUN_BF16


@pytest.mark.parametrize("C,Cd,misaligned,vec", [
    (72, 24, False, 8),  # K1.bf16 on the bat planes' copies: the 16-byte path
    (24, 24, False, 8),  # K1d.bf16: the copies of bat's 24 density channels
    (61, 24, False, 1),  # C not a multiple of 8
    (40, 4, False, 1),   # a group would straddle the density/app split
    (72, 24, True, 1),   # a copy off a 16-byte boundary
    (8, 0, False, 8),    # no density channel
])
def test_plane_product_bf16_plan_picks_the_path(C, Cd, misaligned, vec):
    ptrs = [4096 * (k + 1) for k in range(6)]
    if misaligned:
        ptrs[2] += 8
    plan = grid_sample.plane_product_plan(C, Cd, ptrs, torch.bfloat16)
    assert plan.vec == vec and plan.run == RUN_BF16
    # cell offsets (4 B) and the four bf16 tent products (8 B) of six planes,
    # and the density partials (4 B a group), for each sample of the run
    assert plan.smem_bytes == RUN_BF16 * (6 * 12 + Cd // vec * 4) <= 48 * 1024
    # bat's widths: 9 groups a sample for K1.bf16, 3 for K1d.bf16, so that
    # a block's items are whole rounds of its threads
    if (C, Cd, vec) in ((72, 24, 8), (24, 24, 8)):
        assert RUN_BF16 * (C // vec) % THREADS == 0


def test_plane_product_bf16_plan_shrinks_the_run_to_fit_shared_memory():
    plan = grid_sample.plane_product_plan(4000, 4000, [0] * 6, torch.bfloat16)  # 500 groups
    assert plan == grid_sample.PlaneProductPlan(vec=8, run=16, smem_bytes=16 * (72 + 2000))
    plan = grid_sample.plane_product_plan(4001, 4001, [0] * 6, torch.bfloat16)
    assert (plan.vec, plan.run) == (1, 2) and plan.smem_bytes == 2 * (72 + 4 * 4001)


def test_bf16_planes_are_made_once_per_plane_version():
    """The bf16 copies the bf16 arms read: the planes rounded to nearest
    (ties to even), made anew only when a plane changes in place, one copy a
    channel count, none kept for an inference tensor or a dead plane."""
    space, time, _, Cd = _plane_case(P=4, Cd=24, Ca=48)
    planes = [torch.tensor(p) for p in space + time]
    for p in planes:
        p.requires_grad_(True)
    full = grid_sample.bf16_planes(planes, 72)
    dens = grid_sample.bf16_planes(planes, Cd)
    for p, f, d in zip(planes, full, dens):
        assert f.dtype == torch.bfloat16 and f.is_contiguous() and d.is_contiguous()
        assert torch.equal(f, p.detach().to(torch.bfloat16))
        assert torch.equal(d, p.detach()[..., :Cd].to(torch.bfloat16))
        assert not f.requires_grad
    assert all(a is b for a, b in zip(grid_sample.bf16_planes(planes, 72), full))
    assert all(a is b for a, b in zip(grid_sample.bf16_planes(planes, Cd), dens))
    with torch.no_grad():  # an optimizer's in-place update moves the version
        planes[0].sub_(0.25)
    again = grid_sample.bf16_planes(planes, 72)
    assert again[0] is not full[0] and all(a is b for a, b in zip(again[1:], full[1:]))
    assert torch.equal(again[0], planes[0].detach().to(torch.bfloat16))
    # ties go to even, as __float2bfloat16_rn rounds
    tie = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]).view(1, 2, 1).expand(2, 2, 1)
    got = grid_sample.bf16_planes([tie.contiguous()], 1)[0].float().reshape(-1)[:2]
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -6]
    n = len(grid_sample._BF16_COPIES)
    with torch.inference_mode():
        frozen = torch.ones(2, 3, 8)
        assert grid_sample.bf16_planes([frozen], 8)[0] is not grid_sample.bf16_planes([frozen], 8)[0]
    assert len(grid_sample._BF16_COPIES) == n
    del planes, full, dens, again, p  # p: the last plane of the loop above
    assert len(grid_sample._BF16_COPIES) == n - 6


def test_bf16_planes_are_made_anew_when_a_plane_takes_other_storage():
    """``plane.data = ...`` keeps the plane's version but gives it other
    storage: the next call makes the copy from the new values."""
    plane = torch.zeros(2, 3, 8, requires_grad=True)
    first = grid_sample.bf16_planes([plane], 8)[0]
    plane.data = torch.full((2, 3, 8), 0.5)
    again = grid_sample.bf16_planes([plane], 8)[0]
    assert again is not first and torch.equal(again, torch.full((2, 3, 8), 0.5,
                                                                 dtype=torch.bfloat16))
    assert grid_sample.bf16_planes([plane], 8)[0] is again


def test_plane_product_plan_shrinks_the_run_to_fit_shared_memory():
    plan = grid_sample.plane_product_plan(4000, 4000, [0] * 6)  # 1000 density groups
    assert plan == grid_sample.PlaneProductPlan(vec=4, run=8, smem_bytes=8 * (120 + 4000))
    plan = grid_sample.plane_product_plan(4001, 4001, [0] * 6)  # scalar: 4001 groups
    assert (plan.vec, plan.run) == (1, 2) and plan.smem_bytes == 2 * (120 + 4 * 4001)
    with pytest.raises(ValueError, match="shared memory"):
        grid_sample.plane_product_plan(20001, 20001, [0] * 6)


@pytest.mark.parametrize("P,C,Cd", [(1, 72, 24), (RUN - 1, 72, 24), (RUN, 72, 24),
                                    (RUN + 1, 72, 24), (3 * RUN + 5, 41, 4), (RUN + 1, 8, 0),
                                    (RUN + 1, 8, 8)])
def test_plane_product_work_covers_every_sample_and_channel_once(P, C, Cd):
    plan = grid_sample.plane_product_plan(C, Cd, [0] * 6)
    density_items = []
    for density_only in (False, True):
        c_end = Cd if density_only else C
        block, thread, sample, first = _plane_product_work(plan, P, c_end)
        assert (thread < THREADS).all()
        assert (block == sample // plan.run).all()  # a block owns one run of samples
        assert (first % plan.vec == 0).all() and (first + plan.vec <= c_end).all()
        # no item straddles the density/app split
        assert ((first + plan.vec <= Cd) | (first >= Cd)).all()
        hits = np.zeros((P, max(c_end, 1)), np.int64)
        for j in range(plan.vec):
            np.add.at(hits, (sample, first + j), 1)
        assert (hits[:, :c_end] == 1).all()
        dens = first < Cd
        density_items.append(sorted(zip(sample[dens].tolist(), first[dens].tolist())))
    # K1 and K1d cut the density channels into the same groups
    assert density_items[0] == density_items[1]


@pytest.mark.parametrize("P,C,Cd", [(1, 72, 24), (RUN_BF16 - 1, 72, 24), (RUN_BF16, 72, 24),
                                    (RUN_BF16 + 1, 72, 24), (3 * RUN_BF16 + 5, 41, 4),
                                    (RUN_BF16 + 1, 61, 24), (RUN_BF16 + 1, 8, 0)])
def test_plane_product_bf16_work_covers_every_sample_and_channel_once(P, C, Cd):
    """K1.bf16 walks all C channels of its copies, K1d.bf16 the Cd channels
    of the density copies (row stride Cd), each with its own plan."""
    for c_end in (C, Cd):
        plan = grid_sample.plane_product_plan(c_end, Cd, [0] * 6, torch.bfloat16)
        block, thread, sample, first = _plane_product_work(plan, P, c_end)
        assert (thread < THREADS).all() and (block == sample // plan.run).all()
        assert (first % plan.vec == 0).all() and (first + plan.vec <= c_end).all()
        assert ((first + plan.vec <= Cd) | (first >= Cd)).all()
        hits = np.zeros((P, max(c_end, 1)), np.int64)
        for j in range(plan.vec):
            np.add.at(hits, (sample, first + j), 1)
        assert (hits[:, :c_end] == 1).all()


def _on_card(space, time, xyzt, dev):
    return ([torch.tensor(p, device=dev) for p in space],
            [torch.tensor(p, device=dev) for p in time], torch.tensor(xyzt, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["uniform", "rays"])
@pytest.mark.parametrize("Cd,Ca,vec", [(24, 48, 4), (4, 37, 1)])
@pytest.mark.parametrize("P", [1, RUN - 1, RUN, RUN + 1, 3 * RUN + 5])
def test_plane_product_kernels_at_the_run_edges_on_card(P, Cd, Ca, vec, order):
    dev = _card()
    case = _plane_case(P=P, Cd=Cd, Ca=Ca) if order == "uniform" else _ray_case(P, Cd, Ca)
    ts, tt, x = _on_card(*case[:3], dev)
    plan = grid_sample.plane_product_plan(Cd + Ca, Cd, [p.data_ptr() for p in ts + tt])
    assert plan.vec == vec
    n0, n1 = grid_sample.plane_product.launches, grid_sample.plane_product_density.launches
    got = grid_sample.plane_product(ts, tt, x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd)
    dens = grid_sample.plane_product_density(ts, tt, x, Cd)
    dens_want = grid_sample.plane_product_reference(ts, tt, x, Cd, density_only=True)
    torch.cuda.synchronize()
    assert grid_sample.plane_product.launches == n0 + 1
    assert grid_sample.plane_product_density.launches == n1 + 1
    assert got[0].shape == (P,) and got[1].shape == (P, Ca)
    for g, w in zip(got, want):  # tolerance: FMA contraction in the kernel
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dens, dens_want, rtol=1e-5, atol=1e-5)
    assert torch.equal(dens, got[0])  # the same body, the same channel order


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["uniform", "rays"])
@pytest.mark.parametrize("Cd,Ca,vec,vec_d", BF16_PATHS[:3])
@pytest.mark.parametrize("P", [1, RUN_BF16 - 1, RUN_BF16, RUN_BF16 + 1, 3 * RUN_BF16 + 5])
def test_plane_product_bf16_kernels_at_the_run_edges_on_card(P, Cd, Ca, vec, vec_d, order):
    dev = _card()
    case = _plane_case(P=P, Cd=Cd, Ca=Ca) if order == "uniform" else _ray_case(P, Cd, Ca)
    ts, tt, x = _on_card(*case[:3], dev)
    bf16 = torch.bfloat16
    assert grid_sample.plane_product_inputs(ts + tt, Cd, False, bf16)[2].vec == vec
    assert grid_sample.plane_product_inputs(ts + tt, Cd, True, bf16)[2].vec == vec_d
    got = grid_sample.plane_product(ts, tt, x, Cd, bf16)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd, compute_dtype=bf16)
    dens = grid_sample.plane_product_density(ts, tt, x, Cd, bf16)
    dens_want = grid_sample.plane_product_reference(ts, tt, x, Cd, density_only=True,
                                                    compute_dtype=bf16)
    torch.cuda.synchronize()
    assert got[0].shape == (P,) and got[1].shape == (P, Ca)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)  # f32 sum order
    torch.testing.assert_close(dens, dens_want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_plane_product_takes_the_scalar_path_for_misaligned_planes_on_card():
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=300, Cd=24, Ca=48)
    ts, tt, x = _on_card(space, time, xyzt, dev)
    # the same values one float past a 16-byte boundary: contiguous, misaligned
    shifted = []
    for p in ts + tt:
        buf = torch.empty(p.numel() + 1, device=dev)
        buf[1:] = p.reshape(-1)
        shifted.append(buf[1:].view(p.shape))
    plan = grid_sample.plane_product_plan(72, Cd, [p.data_ptr() for p in shifted])
    assert plan.vec == 1
    got = grid_sample.plane_product(shifted[:3], shifted[3:], x, Cd)
    want = grid_sample.plane_product_reference(ts, tt, x, Cd)
    dens = grid_sample.plane_product_density(shifted[:3], shifted[3:], x, Cd)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert torch.equal(dens, got[0])
    # the kernel refuses a 16-byte plan on those planes instead of misreading them
    from nvfi_torch.ops import kernels
    import ctypes
    hw = (ctypes.c_int * 12)(*[int(d) for p in shifted for d in p.shape[:2]])
    out = torch.empty(300, device=dev)
    err = kernels.load().nvfi_plane_product_density_fwd(
        *[p.data_ptr() for p in shifted], hw, x.data_ptr(), 300, 72, Cd, 4, RUN, 48 * 1024,
        0, out.data_ptr(), kernels.stream_ptr(dev))
    assert err != 0


# --- K1b: the launch plan, its work items and the merge of its atomics -----

BWD_CHUNK = grid_sample.PLANE_PRODUCT_BWD_CHUNK  # csrc/plane_product_bwd.cu kChunkChannels
BWD_TILE = 16  # csrc/plane_product_bwd.cu kTile: active samples of a phase-2 item
WARPS = THREADS // 32


@pytest.mark.parametrize("C,Cd,misaligned,vec", [
    (72, 24, None, 4),   # the model's planes: the 16-byte path
    (41, 4, None, 1),    # C not a multiple of 4
    (72, 22, None, 1),   # a group would straddle the density/app split
    (72, 24, 3, 1),      # a plane off a 16-byte boundary
    (72, 24, 6, 1),      # g_app off a 16-byte boundary
    (72, 24, 9, 1),      # a plane grad off a 16-byte boundary
])
def test_plane_product_bwd_plan_picks_the_path(C, Cd, misaligned, vec):
    ptrs = [4096 * (k + 1) for k in range(13)]  # six planes, g_app, six grads
    if misaligned is not None:
        ptrs[misaligned] += 8
    plan = grid_sample.plane_product_bwd_plan(C, Cd, ptrs)
    assert plan.vec == vec and plan.run == RUN
    # tents and their derivatives (2 x 16 B), the cell offset (4 B) of six
    # planes, the compacted index and g_density (8 B), and grad_xyz partials
    # (12 B) for each chunk of channels, for each sample of the run
    chunks = -(-C // BWD_CHUNK)
    assert plan.smem_bytes == RUN * (6 * 36 + 8 + chunks * 12) <= 48 * 1024


def test_plane_product_bwd_plan_shrinks_the_run_to_fit_shared_memory():
    plan = grid_sample.plane_product_bwd_plan(BWD_CHUNK * 100, 0, [0] * 13)  # 100 chunks
    assert plan == grid_sample.PlaneProductBwdPlan(vec=4, run=32, smem_bytes=32 * (224 + 1200))
    with pytest.raises(ValueError, match="shared memory"):
        grid_sample.plane_product_bwd_plan(BWD_CHUNK * 4100, 0, [0] * 13)


def _k1b_work(plan, active, C):
    """The phase-2 work of csrc/plane_product_bwd.cu: block b owns samples
    [b*run, b*run + n) and compacts its active ones in order; warp w takes
    items w, w + WARPS, ... of the (tile of BWD_TILE compacted samples, chunk
    of BWD_CHUNK channels) items; lanes 2i and 2i + 1 hold the tile's i-th
    sample and walk the chunk in steps of 2 vec channels, the even lane taking
    the first vec of a step and the odd lane the next.  Returns (block, warp,
    lane, sample, first channel) per (sample, group)."""
    P = active.shape[0]
    chunks = -(-C // BWD_CHUNK)
    rows = []
    for b in range(-(-P // plan.run)):
        idx = b * plan.run + np.flatnonzero(active[b * plan.run:(b + 1) * plan.run])
        tiles = -(-len(idx) // BWD_TILE)
        for item in range(tiles * chunks):
            tile, chunk = divmod(item, chunks)
            c_begin, c_end = chunk * BWD_CHUNK, min(C, (chunk + 1) * BWD_CHUNK)
            steps = -(-(c_end - c_begin) // (2 * plan.vec))
            for lane in range(2 * min(BWD_TILE, len(idx) - BWD_TILE * tile)):
                for step in range(steps):
                    c = c_begin + (2 * step + lane % 2) * plan.vec
                    if c < c_end:
                        rows.append((b, item % WARPS, lane, idx[BWD_TILE * tile + lane // 2], c))
    return np.array(rows, np.int64).reshape(-1, 5).T


@pytest.mark.parametrize("P,C,Cd", [(1, 72, 24), (RUN - 1, 72, 24), (RUN, 72, 24),
                                    (RUN + 1, 72, 24), (3 * RUN + 5, 72, 24),
                                    (3 * RUN + 5, 41, 4), (RUN + 1, 8, 0)])
def test_plane_product_bwd_work_covers_every_active_sample_and_channel_once(P, C, Cd):
    plan = grid_sample.plane_product_bwd_plan(C, Cd, [0] * 13)
    active = np.random.RandomState(P).rand(P) < 0.6
    active[0] = True
    block, warp, lane, sample, first = _k1b_work(plan, active, C)
    assert (warp < WARPS).all() and (lane < 32).all()
    assert (block == sample // plan.run).all()  # a block keeps to its own run
    assert (first % plan.vec == 0).all() and (first + plan.vec <= C).all()
    assert ((first + plan.vec <= Cd) | (first >= Cd)).all()  # no group straddles Cd
    hits = np.zeros((P, C), np.int64)
    for j in range(plan.vec):
        np.add.at(hits, (sample, first + j), 1)
    assert (hits[active] == 1).all() and (hits[~active] == 0).all()
    # an even lane starts a run of 2 vec channels that its odd neighbour ends:
    # on the 16-byte path one 32-byte sector of a plane row a pair
    assert (first[lane % 2 == 0] % (2 * plan.vec) == 0).all()
    assert (first[lane % 2 == 1] % (2 * plan.vec) == plan.vec).all()
    # a warp's pairs hold consecutive active samples, in order
    for b in np.unique(block):
        in_b = block == b
        assert (np.diff(sample[in_b & (lane == 0) & (first == 0)]) > 0).all()


def _segments(off):
    """plane_product_bwd.cu segment_of for one tile, in pairs: per pair,
    whether it heads its segment and the last pair of the segment; pairs
    whose cell offsets are equal and adjacent share a segment."""
    pairs = np.arange(len(off))
    head = np.r_[True, off[1:] != off[:-1]]
    tail = np.r_[off[1:] != off[:-1], True]
    last = np.array([pairs[tail & (pairs >= i)].min() for i in pairs])
    return head, last


def _segmented_suffix_sum(v, last):
    """The kernel's shuffle loop: steps d = 1, 2, 4, ... while d is under the
    longest segment; pair i adds pair i + d's value where i + d <= last[i]."""
    v = v.astype(np.float64).copy()
    pairs = np.arange(len(v))
    longest = (last - pairs + 1)[_segments_heads(last)].max()
    d = 1
    while d < longest:
        shifted = np.r_[v[d:], v[-d:]]  # __shfl_down_sync keeps the value past the warp
        v = np.where(pairs + d <= last, v + shifted, v)
        d *= 2
    return v


def _segments_heads(last):
    return np.r_[True, last[1:] != last[:-1]]


@pytest.mark.parametrize("pattern", ["all_one_cell", "all_distinct", "runs", "dead_lanes",
                                     "revisit"])
def test_plane_product_bwd_segments_break_where_the_cell_changes(pattern):
    rng = np.random.RandomState(11)
    n = BWD_TILE
    if pattern == "all_one_cell":
        off = np.full(n, 72 * 5)
    elif pattern == "all_distinct":
        off = 72 * np.arange(n)
    elif pattern == "runs":  # a ray: 1-4 consecutive samples a cell
        off = 72 * np.repeat(np.arange(n), rng.randint(1, 5, n))[:n]
    elif pattern == "dead_lanes":  # 10 live pairs, then the tile's end
        off = np.r_[72 * np.repeat(np.arange(5), 2), -1 - 2 * np.arange(10, n)]
    else:  # a cell left and entered again is two segments
        off = 72 * np.r_[[3] * 5, [4] * 6, [3] * 5]
    head, last = _segments(off)
    pairs = np.arange(n)
    assert (head[1:] == (off[1:] != off[:-1])).all() and head[0]
    for i in pairs:  # the segment of pair i is [its head, last[i]], one cell
        start = pairs[head & (pairs <= i)].max()
        assert (off[start:last[i] + 1] == off[i]).all()
        assert last[i] == n - 1 or off[last[i] + 1] != off[i]
    v = rng.randn(n)
    got = _segmented_suffix_sum(v, last)
    for i in pairs[head]:
        np.testing.assert_allclose(got[i], v[i:last[i] + 1].sum(), rtol=1e-12)
    if pattern == "all_distinct":
        assert (got == v).all()  # no step runs


BWD_BF16_THREADS = 128  # csrc/plane_product_bwd.cu kThreadsBf16
BWD_BF16_WARPS = BWD_BF16_THREADS // 32


@pytest.mark.parametrize("C,Cd,misaligned,vec", [
    (72, 24, None, 8),    # the bat planes' copies: the 16-byte path
    (8, 0, None, 8),      # no density channel
    (4000, 4000, None, 8),  # wide planes: the run still fits (no partials)
    (61, 24, None, 1),    # C not a multiple of 8
    (40, 4, None, 1),     # a step would straddle the density/app split
    (72, 24, 3, 1),       # a copy off a 16-byte boundary
    (72, 24, 6, 1),       # g_app off a 16-byte boundary
    (72, 24, 9, 1),       # a plane grad off a 16-byte boundary
])
def test_plane_product_bwd_bf16_plan_picks_the_path(C, Cd, misaligned, vec):
    ptrs = [4096 * (k + 1) for k in range(13)]  # six copies, g_app, six grads
    if misaligned is not None:
        ptrs[misaligned] += 8
    plan = grid_sample.plane_product_bwd_plan(C, Cd, ptrs, torch.bfloat16)
    assert plan.vec == vec and plan.run == RUN
    # tents and their derivatives (2 x 16 B), the cell offset (4 B) of six
    # planes, the compacted index and g_density (8 B), for each sample of the
    # run: no grad_xyz partials, whatever C
    assert plan.smem_bytes == RUN * (6 * 36 + 8) <= 48 * 1024
    # a block's warps take one tile of 16 active samples each when half of
    # the run is active, as in a train chunk
    assert RUN // 2 == BWD_BF16_WARPS * BWD_TILE
    # the float32 arm keeps its own plan
    assert grid_sample.plane_product_bwd_plan(C, Cd, ptrs).vec in (1, 4)


def _k1b_bf16_work(plan, active, C):
    """The walk of csrc/plane_product_bwd.cu's bf16 arm, in the order each
    lane takes it: block b owns samples [b*run, b*run + n) and compacts its
    active ones in order; warp w takes tiles w, w + BWD_BF16_WARPS, ... of
    BWD_TILE compacted samples and walks all C channels of each; lanes 2i and
    2i + 1 hold the tile's i-th sample, the even lane for the space planes
    (0, 1, 2), the odd one for the time planes (3, 4, 5); a step takes vec
    channels as vec / 2 pairs (one on the narrow path), a pair's low channel
    first.  Returns (block, warp, lane, sample, plane, channel, order) per
    (sample, plane, channel) that reaches a running sum, order counting the
    lane's adds."""
    P = active.shape[0]
    rows = []
    for b in range(-(-P // plan.run)):
        idx = b * plan.run + np.flatnonzero(active[b * plan.run:(b + 1) * plan.run])
        for tile in range(-(-len(idx) // BWD_TILE)):
            warp = tile % BWD_BF16_WARPS
            for lane in range(2 * min(BWD_TILE, len(idx) - BWD_TILE * tile)):
                sample = idx[BWD_TILE * tile + lane // 2]
                order = 0
                for c in range(0, C, plan.vec):
                    for pair in range(max(plan.vec // 2, 1)):
                        for ch in (c + 2 * pair, c + 2 * pair + 1)[:min(plan.vec, 2)]:
                            for plane in range(3 * (lane % 2), 3 * (lane % 2) + 3):
                                rows.append((b, warp, lane, sample, plane, ch, order))
                            order += 1
    return np.array(rows, np.int64).reshape(-1, 7).T


@pytest.mark.parametrize("P,C,Cd", [(1, 72, 24), (RUN - 1, 72, 24), (RUN, 72, 24),
                                    (RUN + 1, 72, 24), (3 * RUN + 5, 72, 24),
                                    (3 * RUN + 5, 41, 4), (RUN + 1, 8, 0)])
def test_plane_product_bwd_bf16_walk_covers_every_active_sample_and_channel_in_order(P, C, Cd):
    plan = grid_sample.plane_product_bwd_plan(C, Cd, [0] * 13, torch.bfloat16)
    active = np.random.RandomState(P).rand(P) < 0.5
    active[0] = True
    block, warp, lane, sample, plane, ch, order = _k1b_bf16_work(plan, active, C)
    assert (warp < BWD_BF16_WARPS).all() and (lane < 32).all()
    assert (block == sample // plan.run).all()  # a block keeps to its own run
    assert (plane // 3 == lane % 2).all()  # the even lane: space planes; the odd: time
    hits = np.zeros((P, 6, C), np.int64)
    np.add.at(hits, (sample, plane, ch), 1)
    assert (hits[active] == 1).all() and (hits[~active] == 0).all()
    # one lane holds each (sample, plane) running sum, and adds channels
    # 0..C-1 to it in order, across its steps
    key = (sample * 6 + plane) * 64 + warp * 32 + lane
    for k in np.unique(sample * 6 + plane):
        mine = sample * 6 + plane == k
        assert len(np.unique(key[mine])) == 1
        assert (ch[mine][np.argsort(order[mine], kind="stable")] == np.arange(C)).all()
    # a warp's pairs hold consecutive active samples, in order
    for b in np.unique(block):
        first = (block == b) & (lane % 2 == 0) & (ch == 0) & (plane == 0)
        assert (np.diff(sample[first]) > 0).all()


@pytest.mark.parametrize("vec", [8, 1])
def test_plane_product_bwd_bf16_walk_gives_the_tent_cotangents_of_the_plain_version(vec,
                                                                                    monkeypatch):
    """The order of the bf16 arm's running sums, run in torch bf16: every
    (sample, plane, corner) sum takes the products bf16(t * r_i) in the
    order of the walk's mirror, each add rounded to bf16, from +0; it must
    give the tent products' cotangents of the plain bf16 backward
    (_Bf16Corners.backward, the same t and rows) bit for bit, where the
    reversed order does not."""
    P, Cd, Ca = 40, 8, 32
    space, time, xyzt, Cd = _plane_case(P=P, Cd=Cd, Ca=Ca)
    C = Cd + Ca
    rng = np.random.RandomState(12)
    gd = torch.tensor(rng.randn(P).astype(np.float32))
    ga = torch.tensor(rng.randn(P, Ca).astype(np.float32)).to(torch.bfloat16)
    seen = []  # per _Bf16Corners call: (t, bf16 rows, tent products' cotangents)
    backward = grid_sample._Bf16Corners.backward

    def recording(ctx, g):
        g_rows, g_w = backward(ctx, g)
        seen.append((g, ctx.saved_tensors[0], g_w))
        return g_rows, g_w

    monkeypatch.setattr(grid_sample._Bf16Corners, "backward", staticmethod(recording))
    planes = [torch.tensor(p) for p in space + time]
    grid_sample.plane_product_backward_reference(planes[:3], planes[3:], torch.tensor(xyzt), Cd,
                                                 gd, ga, torch.bfloat16)
    assert len(seen) == 6
    plan = grid_sample.PlaneProductBwdPlan(vec=vec, run=RUN, smem_bytes=0)
    _, _, _, sample, plane, ch, order = _k1b_bf16_work(plan, np.ones(P, bool), C)
    walk = np.lexsort((order, sample * 6 + plane))  # each sum's adds in the lane's order
    for t, r, want in seen:  # the plane's sums: the walk's order, then its reverse
        g = [t * r[:, i * C:(i + 1) * C] for i in range(4)]
        sums = []
        for rev in (False, True):
            acc = torch.zeros(P, 4, dtype=torch.bfloat16)
            for j in (walk[::-1] if rev else walk):
                if plane[j] == 0:  # one plane's order stands for all six
                    for i in range(4):
                        acc[sample[j], i] = acc[sample[j], i] + g[i][sample[j], ch[j]]
            sums.append(acc.float())
        assert torch.equal(sums[0], want)
        assert not torch.equal(sums[1], want)


def _lane_suffix_sum(v, last):
    """scatter's shuffle loop on the 32 lanes of a warp: lane l adds lane
    l + 2d's value where its pair i = l // 2 has i + d <= last[i]
    (__shfl_down_sync past the warp gives the lane its own value)."""
    v = v.astype(np.float64).copy()
    lanes = np.arange(32)
    pair = lanes // 2
    longest = (last - np.arange(len(last)) + 1)[_segments_heads(last)].max()
    d = 1
    while d < longest:
        v = np.where(pair + d <= last[pair], v + v[np.where(lanes + 2 * d < 32, lanes + 2 * d,
                                                            lanes)], v)
        d *= 2
    return v


@pytest.mark.parametrize("pattern", ["runs", "all_one_cell", "dead_lanes"])
def test_plane_product_bwd_bf16_narrow_path_adds_each_plane_from_its_own_lanes(pattern):
    """The bf16 arm's narrow path (one channel a step): the even lane of
    pair i holds sample i's row cotangent of plane j, the odd lane that of
    plane j + 3.  Two merges run over the pairs' cells (segment_of, as in
    the f32 arm), plane j's with only the even lanes adding, plane j + 3's
    with only the odd ones: each segment's total leaves once, from its head
    pair's lane of that plane, and the atomics are the f32 arm's at one
    channel a lane, one a segment head of each plane."""
    rng = np.random.RandomState(13)
    n = BWD_TILE
    cells_j = 72 * np.repeat(np.arange(n), rng.randint(1, 5, n))[:n]
    cells_k = 72 * np.repeat(np.arange(n), rng.randint(1, 4, n))[:n] + 1
    live = np.ones(n, bool)
    if pattern == "all_one_cell":
        cells_j[:], cells_k[:] = 72 * 5, 72 * 7
    elif pattern == "dead_lanes":  # 10 live pairs, then the tile's end
        live[10:] = False
        cells_j[10:] = cells_k[10:] = -1 - 2 * np.arange(10, n)
    a, b = rng.randn(n), rng.randn(n)
    q = np.stack([a, b], -1).reshape(32)  # lane 2i: plane j's, lane 2i + 1: plane j + 3's
    lanes = np.arange(32)
    for parity, cells, vals in ((0, cells_j, a), (1, cells_k, b)):
        head, last = _segments(cells)
        got = _lane_suffix_sum(q, last)
        issue = np.repeat(live & head, 2) & (lanes % 2 == parity)
        heads = np.flatnonzero(live & head)
        assert (np.flatnonzero(issue) == 2 * heads + parity).all()
        for i in heads:
            np.testing.assert_allclose(got[2 * i + parity], vals[i:last[i] + 1].sum(),
                                       rtol=1e-12)
        if pattern == "all_one_cell":
            assert len(heads) == 1


def test_zero_plane_grads_are_views_of_one_zeroed_allocation():
    space, time, _, _ = _plane_case(P=4, Cd=24, Ca=48)
    planes = [torch.tensor(p) for p in space + time]
    grads = grid_sample._zero_plane_grads(planes)
    base = grads[0].untyped_storage().data_ptr()
    offset = 0
    for g, p in zip(grads, planes):
        assert g.shape == p.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert not g.any()
        assert g.untyped_storage().data_ptr() == base  # one allocation, one memset
        assert g.data_ptr() == base + offset and (g.data_ptr() - base) % 16 == 0
        offset += p.numel() * 4


# --- K2: the launch plan -----------------------------------------------------

@pytest.mark.parametrize("N", [1, 128, 4096])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 686])
def test_composite_plan_covers_every_sample_once(N, S):
    plan = compositing.composite_plan(N, S, 132 * 32)  # an H100's 132 multiprocessors
    W, T, R = plan.warps_per_ray, plan.tiles_per_warp, plan.rays_per_block
    assert 1 <= W * R <= compositing.COMPOSITE_MAX_WARPS
    assert W == 1 or T <= compositing.COMPOSITE_MAX_TILES  # a shared ray's segments fit registers
    hits = np.zeros(S, np.int64)
    for w in range(W):  # warp w owns samples [w T 32, min(S, (w + 1) T 32))
        seg = np.arange(w * T * 32, min(S, (w + 1) * T * 32))
        assert len(seg) > 0  # no warp without samples
        hits[seg] += 1
    assert (hits == 1).all()
    if (N, S) == (128, 686):
        assert N * W >= 2000  # a train chunk: thousands of warps in flight
        assert T == 1
    if N == 4096:  # a render chunk: one warp streams each ray
        assert W == 1 and T == -(-S // 32)


def _one_cell_case(P, Cd, Ca):
    """Every sample within one cell of every plane: the merge path."""
    space, time, xyzt, Cd = _plane_case(P=P, Cd=Cd, Ca=Ca)
    jitter = 1e-3 * np.random.RandomState(9).rand(P, 4).astype(np.float32)
    return space, time, np.array([0.11, -0.23, 0.31, 0.07], np.float32) + jitter, Cd


def _plane_grads_case(P, Ca, kind, seed=7):
    """Incoming grads: "masked" (a third of the samples all zero, another
    third with g_app zero, as in training), "dense" or "zero"."""
    rng = np.random.RandomState(seed)
    gd = rng.randn(P).astype(np.float32)
    ga = rng.randn(P, Ca).astype(np.float32)
    if kind == "masked":
        gd[::3], ga[::3] = 0.0, 0.0
        ga[1::3] = 0.0
    elif kind == "zero":
        gd[:], ga[:] = 0.0, 0.0
    return gd, ga


def _k1b_atomics(space, time, xyzt, Cd, active, run, width):
    """The global atomics the kernel issues, from its work items: per block
    tile and plane, one per segment of equal cells, group of ``width``
    channels (the floats one atomic adds: 4 on the 16-byte paths of both
    arms, 1 on the narrow ones) and corner whose tent weight is non-zero in
    some sample of the segment."""
    x = torch.tensor(xyzt)
    C = space[0].shape[-1]
    cells, nonzero = [], []
    for plane, (a, b) in zip(space + time, grid_sample.MAT_SPACE + grid_sample.MAT_TIME):
        H, W = plane.shape[:2]
        u = (x[:, a] + 1.0) * 0.5 * (W - 1)
        v = (x[:, b] + 1.0) * 0.5 * (H - 1)
        x0 = torch.clamp(torch.floor(u), 0, W - 2)
        y0 = torch.clamp(torch.floor(v), 0, H - 2)
        wx = [torch.clamp(1 - (u - x0 - i).abs(), 0, 1) for i in (0, 1)]
        wy = [torch.clamp(1 - (v - y0 - i).abs(), 0, 1) for i in (0, 1)]
        cells.append((y0 * W + x0).long().numpy())
        nonzero.append(np.stack([(wy[i] * wx[j] != 0).numpy() for i in (0, 1) for j in (0, 1)], -1))
    total = 0
    for b in range(-(-len(xyzt) // run)):
        idx = b * run + np.flatnonzero(active[b * run:(b + 1) * run])
        for t0 in range(0, len(idx), BWD_TILE):
            tile = idx[t0:t0 + BWD_TILE]
            for cell, nz in zip(cells, nonzero):
                head, last = _segments(np.r_[cell[tile], -1 - 2 * np.arange(len(tile), BWD_TILE)])
                for i in np.flatnonzero(head[:len(tile)]):
                    total += int(nz[tile[i:last[i] + 1]].any(0).sum())
    return total * (C // width)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["uniform", "rays", "one_cell"])
@pytest.mark.parametrize("Cd,Ca,vec", [(24, 48, 4), (4, 37, 1)])
@pytest.mark.parametrize("P", [1, RUN - 1, RUN, RUN + 1, 3 * RUN + 5])
def test_plane_product_backward_at_the_run_edges_on_card(P, Cd, Ca, vec, order):
    dev = _card()
    case = {"uniform": _plane_case(P=P, Cd=Cd, Ca=Ca), "rays": _ray_case(P, Cd, Ca),
            "one_cell": _one_cell_case(P, Cd, Ca)}[order]
    ts, tt, x = _on_card(*case[:3], dev)
    gd, ga = _plane_grads_case(P, Ca, "dense" if order == "rays" else "masked")
    active = (gd != 0) | (ga != 0).any(-1)
    gd, ga = torch.tensor(gd, device=dev), torch.tensor(ga, device=dev)
    plan = grid_sample.plane_product_bwd_plan(Cd + Ca, Cd, [p.data_ptr() for p in ts + tt]
                                              + [ga.data_ptr()])
    assert plan.vec == vec
    n0 = grid_sample.plane_product_backward.launches
    got_planes, got_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga)
    want_planes, want_x = grid_sample.plane_product_backward_reference(ts, tt, x, Cd, gd, ga)
    torch.cuda.synchronize()
    assert grid_sample.plane_product_backward.launches == n0 + 1
    _grad_close(got_planes + [got_x], list(want_planes) + [want_x])
    assert not got_x[:, 3].any() and not got_x[torch.tensor(~active, device=dev)].any()
    # the kernel's own count of its global atomics is the work items' count
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    grads = grid_sample._zero_plane_grads(ts + tt)
    grid_sample.launch_plane_product_backward(ts + tt, x, Cd, gd, ga, grads, None, stats)
    torch.cuda.synchronize()
    assert grid_sample.plane_product_backward.launches == n0 + 2  # the helper counts its launch
    _grad_close(grads, want_planes)
    assert int(stats[0]) == _k1b_atomics(*case, active, plan.run, plan.vec)
    if order == "one_cell" and int(active.sum()) > 1:
        assert int(stats[2]) > 0  # updates merged before they left the SM


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["uniform", "rays", "one_cell"])
@pytest.mark.parametrize("Cd,Ca,vec", [(24, 48, 8), (4, 37, 1)])
@pytest.mark.parametrize("P", [1, RUN - 1, RUN, RUN + 1, 3 * RUN + 5])
def test_plane_product_backward_bf16_at_the_run_edges_on_card(P, Cd, Ca, vec, order):
    """K1b.bf16 at the edges of its runs and tiles: against the plain bf16
    backward, zero rows for the samples it skips, grad_xyz of two launches
    bit for bit, and its own count of its atomics equal to the model's and
    to the f32 arm's on the same grads (the same segments and sectors)."""
    dev = _card()
    case = {"uniform": _plane_case(P=P, Cd=Cd, Ca=Ca), "rays": _ray_case(P, Cd, Ca),
            "one_cell": _one_cell_case(P, Cd, Ca)}[order]
    ts, tt, x = _on_card(*case[:3], dev)
    gd, ga = _plane_grads_case(P, Ca, "dense" if order == "rays" else "masked")
    active = (gd != 0) | (ga != 0).any(-1)
    bf16 = torch.bfloat16
    gd, ga = torch.tensor(gd, device=dev), torch.tensor(ga, device=dev).to(bf16)
    copies = grid_sample.bf16_planes(ts + tt, Cd + Ca)
    plan = grid_sample.plane_product_bwd_plan(Cd + Ca, Cd, [p.data_ptr() for p in copies]
                                              + [ga.data_ptr()], bf16)
    assert plan.vec == vec
    got_planes, got_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga,
                                                           compute_dtype=bf16)
    want_planes, want_x = grid_sample.plane_product_backward_reference(ts, tt, x, Cd, gd, ga,
                                                                       bf16)
    stats = {}
    for arm, g_app in (("bf16", ga), ("f32", ga.float())):
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        grads, g_x = grid_sample._zero_plane_grads(ts + tt), torch.empty_like(x)
        grid_sample.launch_plane_product_backward(ts + tt, x, Cd, gd, g_app, grads, g_x, counts)
        stats[arm] = counts.tolist()
        if arm == "bf16":
            assert torch.equal(g_x.view(torch.int32), got_x.view(torch.int32))
            _grad_close(grads, want_planes)
    torch.cuda.synchronize()
    _grad_close(got_planes + [got_x], list(want_planes) + [want_x])
    assert not got_x[:, 3].any() and not got_x[torch.tensor(~active, device=dev)].any()
    assert stats["bf16"][0] == _k1b_atomics(*case, active, plan.run, min(vec, 4))
    assert stats["bf16"] == stats["f32"]
    if order == "one_cell" and int(active.sum()) > 1:
        assert stats["bf16"][2] > 0  # updates merged before they left the SM


@pytest.mark.cuda
@pytest.mark.parametrize("want_planes,want_xyz", [(True, True), (True, False), (False, True),
                                                  (False, False)])
@pytest.mark.parametrize("grads", ["masked", "zero"])
def test_plane_product_backward_outputs_on_request_on_card(want_planes, want_xyz, grads):
    dev = _card()
    space, time, xyzt, Cd = _ray_case(3 * RUN + 5, 24, 48)
    ts, tt, x = _on_card(space, time, xyzt, dev)
    gd, ga = [torch.tensor(g, device=dev) for g in _plane_grads_case(len(xyzt), 48, grads)]
    n0 = grid_sample.plane_product_backward.launches
    got_planes, got_x = grid_sample.plane_product_backward(ts, tt, x, Cd, gd, ga,
                                                           want_planes=want_planes,
                                                           want_xyz=want_xyz)
    want_planes_, want_x = grid_sample.plane_product_backward_reference(ts, tt, x, Cd, gd, ga)
    torch.cuda.synchronize()
    launched = want_planes or want_xyz
    assert grid_sample.plane_product_backward.launches == n0 + launched
    assert (got_planes is None) != want_planes and (got_x is None) != want_xyz
    if want_planes:
        _grad_close(got_planes, want_planes_)
    if want_xyz:
        _grad_close([got_x], [want_x])
    if grads == "zero":
        assert all(not g.any() for g in (got_planes or []) + ([got_x] if want_xyz else []))


@pytest.mark.cuda
def test_plane_product_backward_refuses_a_plan_its_inputs_do_not_allow_on_card():
    dev = _card()
    space, time, xyzt, Cd = _plane_case(P=300, Cd=24, Ca=48)
    ts, tt, x = _on_card(space, time, xyzt, dev)
    gd, ga = [torch.tensor(g, device=dev) for g in _plane_grads_case(300, 48, "masked")]
    grads = grid_sample._zero_plane_grads(ts + tt)
    from nvfi_torch.ops import kernels
    import ctypes
    hw = (ctypes.c_int * 12)(*[int(d) for p in ts + tt for d in p.shape[:2]])
    lib = kernels.load()

    def launch(vec, run, smem, g_app=ga):
        ptrs = (ctypes.c_void_p * 6)(*[g.data_ptr() for g in grads])
        return lib.nvfi_plane_product_bwd(
            *[p.data_ptr() for p in ts + tt], hw, x.data_ptr(), 300, 72, Cd, vec, run, smem,
            0, gd.data_ptr(), g_app.data_ptr(), ptrs, None, None, kernels.stream_ptr(dev))

    plan = grid_sample.plane_product_bwd_plan(72, Cd, [0] * 13)
    assert launch(plan.vec, plan.run, plan.smem_bytes) == 0
    assert launch(3, plan.run, plan.smem_bytes) != 0  # no such path
    assert launch(4, plan.run, plan.smem_bytes - 4) != 0  # too little shared memory
    assert launch(4, 0, plan.smem_bytes) != 0
    shifted = torch.empty(ga.numel() + 1, device=dev)
    shifted[1:] = ga.reshape(-1)
    assert launch(4, plan.run, plan.smem_bytes, shifted[1:]) != 0  # g_app misaligned
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 686])
@pytest.mark.parametrize("N", [1, 128, 4096])
def test_composite_kernel_at_the_plan_edges_on_card(N, S, white_bg):
    dev = _card()
    sigma, dist, z, rgb = [np.ascontiguousarray(a[:, :S])
                           for a in _composite_case(N=N, S=max(S, 6))]
    if N > 2:
        sigma[2] = 0.0  # misses the box: exactly the background colour
        sigma[N // 2:N // 2 + 8, S // 3] = 1e3  # saturated samples, at a segment's edge or not
        rgb[3] *= 3.0  # composites past 1: the clip bites
    args = [torch.tensor(a, device=dev) for a in (sigma, dist, z, rgb)]
    n0 = compositing.composite.launches
    got = compositing._launch_composite(*args, 1e-4, white_bg, 6.0, True)
    want = compositing.composite_reference(*args, 1e-4, white_bg, 6.0, return_raw=True)
    plain = compositing.composite(*args, 1e-4, white_bg, 6.0)  # no graph: no colour kept
    torch.cuda.synchronize()
    assert compositing.composite.launches == n0 + 2
    for g, w in zip(got, want):  # tolerance: the scan associates differently
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * max(float(w.abs().max()), 1e-30))
    assert all(torch.equal(a, b) for a, b in zip(plain, got[:4]))  # the same plan, the same sums
    assert torch.equal(got[2], got[4].clamp(0.0, 1.0))
    if N > 2:
        assert torch.equal(got[4][2], torch.full((3,), 1.0 if white_bg else 0.0, device=dev))
        assert not got[0][2].any()


# --- K2b: the launch plan ----------------------------------------------------

@pytest.mark.parametrize("N", [1, 127, 128, 129, 4096])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 129, 686, 1100, 4096])
def test_composite_backward_plan_covers_every_sample_of_every_ray_once(N, S):
    """K2b's index mapping (csrc/composite_bwd.cu) over its plan: every ray
    is one block's, and its warps' segments, at most COMPOSITE_MAX_TILES
    tiles each (held in registers), cover each sample once, contiguous and
    non-empty."""
    plan = compositing.composite_bwd_plan(N, S, 132 * 32)  # an H100's 132 multiprocessors
    W, T, R = plan.warps_per_ray, plan.tiles_per_warp, plan.rays_per_block
    assert W * R <= compositing.COMPOSITE_MAX_WARPS and T <= compositing.COMPOSITE_MAX_TILES
    rays = np.zeros(N, np.int64)
    for block in range(-(-N // R)):
        ray = block * R + np.arange(R)
        rays[ray[ray < N]] += 1
    assert (rays == 1).all()
    hits, end_before = np.zeros(S, np.int64), 0
    for w in range(W):
        begin, end = w * T * 32, min(S, (w + 1) * T * 32)
        assert begin == end_before and end > begin  # contiguous, non-empty
        end_before = end
        for t in range(compositing.COMPOSITE_MAX_TILES):
            s0 = begin + 32 * t
            n = max(0, min(32, end - s0)) if t < T else 0
            hits[s0:s0 + n] += 1
    assert end_before == S and (hits == 1).all()
    if (N, S) == (128, 686):  # a train chunk: about 21 warps a multiprocessor
        assert (W, T, R) == (22, 1, 1)
    if (N, S) == (4096, 686):  # a render chunk: the fewest warps that hold a ray
        assert (W, T, R) == (6, 4, 1)


def test_composite_backward_plan_refuses_rays_longer_than_4096_samples():
    assert compositing.composite_bwd_plan(2, 4096, 132 * 32).warps_per_ray == 32
    with pytest.raises(ValueError, match="4096"):
        compositing.composite_bwd_plan(2, 4097, 132 * 32)


# --- K3: the cell bits ---------------------------------------------------------

def _bits_by_definition(vol):
    """The cell bits of a numpy volume from their definition, cell by cell:
    bit 0 where the eight corners c, min(c + 1, size - 1) all hold +0.0."""
    D, H, W = vol.shape
    raw = vol.view(np.int32)
    Dc, Hc, words = occupancy.occupancy_bits_shape(vol.shape)
    out = np.zeros((Dc, Hc, words), np.int64)
    for cz in range(Dc):
        for cy in range(Hc):
            for cx in range(max(W - 1, 1)):
                corners = raw[np.ix_([cz, min(cz + 1, D - 1)], [cy, min(cy + 1, H - 1)],
                                     [cx, min(cx + 1, W - 1)])]
                if (corners != 0).any():
                    out[cz, cy, cx // 32] |= 1 << (cx % 32)
    return np.where(out >= 2**31, out - 2**32, out).astype(np.int32)


def _bits_volume(shape, kind, seed=9):
    """A sparse binary volume; all +0.0; +0.0 but one -0.0; or sparse with a
    NaN and an inf."""
    rng = np.random.RandomState(seed)
    vol = (rng.rand(*shape) < 0.05).astype(np.float32)
    mid = tuple(s // 2 for s in shape)
    if kind in ("zeros", "negative_zero"):
        vol[:] = 0.0
    if kind == "negative_zero":
        vol[mid] = -0.0
    if kind == "nan":
        vol[mid] = np.nan
        vol[(0,) * len(shape)] = np.inf
    return vol


def _edge_coords(shape, P, seed=10):
    """Coords in the volume's own box: every combination of pix = -1, 0,
    size - 1 and size on the three axes, a NaN and an inf row, then uniform
    coords reaching past the box."""
    D, H, W = shape
    sizes = np.array([W, H, D], np.float32)
    pix = np.stack(np.meshgrid(*[[-1.0, 0.0, s - 1.0, s] for s in sizes], indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    edges = pix * np.float32(2.0) / np.maximum(sizes - 1, 1) - 1.0
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.3, 1.3, (max(P, 66), 3)).astype(np.float32)
    xyz[:64] = edges
    xyz[64], xyz[65] = np.nan, [0.1, np.inf, -0.2]
    return xyz[:P]


@pytest.mark.parametrize("kind", ["sparse", "zeros", "negative_zero", "nan"])
@pytest.mark.parametrize("shape", [(7, 9, 11), (3, 4, 70), (1, 5, 33), (2, 1, 2), (1, 1, 1)])
def test_occupancy_bits_match_their_definition(shape, kind):
    vol = _bits_volume(shape, kind)
    bits = occupancy.occupancy_bits(torch.tensor(vol))
    assert bits.dtype == torch.int32 and bits.is_contiguous()
    assert tuple(bits.shape) == occupancy.occupancy_bits_shape(shape)
    np.testing.assert_array_equal(bits.numpy(), _bits_by_definition(vol))
    if kind == "zeros":
        assert not bits.any()
    if kind == "negative_zero":  # a -0.0 corner sets its cells' bits
        assert bits.any()


@pytest.mark.parametrize("kind", ["sparse", "zeros", "negative_zero", "nan"])
@pytest.mark.parametrize("renorm", [True, False])
def test_the_samples_the_bits_skip_are_exactly_zero_in_the_plain_version(kind, renorm):
    """Where a sample's cell has bit 0 and its pixel coords are finite, the
    plain trilinear value is +0.0 exactly (bit pattern 0): the kernel writes
    that without a gather."""
    shape = (7, 9, 11)
    vol = torch.tensor(_bits_volume(shape, kind))
    bits = occupancy.occupancy_bits(vol)
    aabb = torch.tensor(_mask_case(P=1)[2])
    model_aabb, box = (MODEL_AABB, aabb) if renorm else (None, torch.tensor([[-1.0] * 3,
                                                                              [1.0] * 3]))
    xyz = torch.tensor(_edge_coords(shape, 4000))
    skip = occupancy.occupancy_bits_skip(bits, shape, xyz, model_aabb, box)
    want = occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, box)
    assert bool((want[skip].view(torch.int32) == 0).all())
    assert not bool(skip[64:66].any())  # a non-finite pix takes the full path
    share = float(skip.float().mean())
    assert share > {"sparse": 0.3, "zeros": 0.99, "negative_zero": 0.9, "nan": 0.3}[kind]
    if kind != "zeros":  # the cells around the -0.0 or the NaN are not skipped
        assert share < 1.0


def test_occupancy_trilinear_refuses_cell_bits_of_another_volume():
    vol, _, aabb, xyz = [torch.tensor(a) for a in _mask_case(P=20)]
    bits = occupancy.occupancy_bits(vol)
    for bad in (None, bits[:-1], occupancy.occupancy_bits(vol.permute(2, 1, 0).contiguous())):
        with pytest.raises(ValueError, match="cell bits"):
            occupancy.occupancy_trilinear(vol, bad, xyz, MODEL_AABB, aabb)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sparse", "zeros", "negative_zero", "nan"])
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("shape,P", [((7, 9, 11), 1), ((7, 9, 11), 5000), ((1, 5, 33), 1025),
                                     ((2, 1, 2), 66)])
def test_occupancy_trilinear_at_the_cell_edges_on_card(shape, P, kind, renorm):
    """K3 at pix = -1, 0, size - 1 and size, at NaN and inf coords, on an
    all-zero volume and on volumes with a -0.0 or a NaN: equal to the plain
    version bit for bit (NaN where it has NaN), and +0.0 wherever the bits
    skip; also from coords that are not 16-byte aligned."""
    dev = _card()
    vol = torch.tensor(_bits_volume(shape, kind), device=dev)
    bits = occupancy.occupancy_bits(vol)
    aabb = torch.tensor(_mask_case(P=1)[2], device=dev)
    model_aabb, box = (MODEL_AABB, aabb) if renorm else (
        None, torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev))
    padded = torch.tensor(np.concatenate([np.zeros((1, 3), np.float32),
                                          _edge_coords(shape, P)]), device=dev)
    n0 = occupancy.occupancy_trilinear.launches
    for xyz in (padded[1:].contiguous(), padded[1:]):  # aligned, then 12 bytes in
        got = occupancy.occupancy_trilinear(vol, bits, xyz, model_aabb, box)
        want = occupancy.occupancy_trilinear_reference(vol, xyz, model_aabb, box)
        skip = occupancy.occupancy_bits_skip(bits, shape, xyz, model_aabb, box)
        torch.cuda.synchronize()
        same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
        assert bool(same.all()), int((~same).sum())
        assert bool((got[skip].view(torch.int32) == 0).all())
    assert occupancy.occupancy_trilinear.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 129, 686, 1100])
@pytest.mark.parametrize("N", [1, 128, 4096])
def test_composite_backward_kernel_at_the_plan_edges_on_card(N, S, white_bg):
    """K2b against its plain backward where its plan changes: one warp a
    ray or several, one tile a warp or up to four, one ray a block or more, with
    every incoming grad, with g_rgb alone (the train step's) and with
    g_depth and g_weight (no colour grads); the same bits on a second run
    (no atomics)."""
    dev = _card()
    sigma, dist, z, rgb = [np.ascontiguousarray(a[:, :S])
                           for a in _composite_case(N=N, S=max(S, 6))]
    if N > 2:
        sigma[2] = 0.0  # misses the box: the clip's tie
        sigma[N // 2:N // 2 + 8, S // 3] = 1e3  # saturated samples, at a segment's edge or not
        rgb[3] *= 3.0  # composites past 1: the clip bites
    args = [torch.tensor(a, device=dev) for a in (sigma, dist, z, rgb)]
    thres, far = 1e-4, 6.0
    weight, _, _, _, raw = compositing._launch_composite(*args, thres, white_bg, far, True)
    rng = np.random.RandomState(11)
    grads = [torch.tensor(rng.randn(*s).astype(np.float32), device=dev)
             for s in ((N, 3), (N,), (N,), (N, S))]
    edge = ((weight - thres).abs() <= 1e-6 * thres)[..., None]
    n0 = compositing.composite_backward.launches
    for which in ("radw", "r", "dw"):
        g = [x if k in which else None for x, k in zip(grads, "radw")]
        got = compositing.composite_backward(*args, weight, raw, *g, thres, white_bg, far)
        again = compositing.composite_backward(*args, weight, raw, *g, thres, white_bg, far)
        want = compositing.composite_backward_reference(*args, *g, thres, white_bg, far)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        _grad_close([got[0], torch.where(edge, 0.0, got[1])],
                    [want[0], torch.where(edge, 0.0, want[1])])
        if "r" not in which and "w" not in which:
            assert not got[1].any()
    assert compositing.composite_backward.launches == n0 + 6


@pytest.mark.cuda
def test_composite_backward_takes_rays_of_up_to_4096_samples_on_card():
    dev = _card()
    for S in (4096, 4097):
        args = [torch.tensor(a, device=dev) for a in _composite_case(N=2, S=S)]
        weight, _, _, _, raw = compositing._launch_composite(*args, 1e-4, True, 6.0, True)
        g_rgb = torch.ones(2, 3, device=dev)
        if S > 4096:
            with pytest.raises(ValueError, match="4096"):
                compositing.composite_backward(*args, weight, raw, g_rgb, None, None, None,
                                               1e-4, True, 6.0)
            continue
        got = compositing.composite_backward(*args, weight, raw, g_rgb, None, None, None, 1e-4,
                                             True, 6.0)
        want = compositing.composite_backward_reference(*args, g_rgb, None, None, None, 1e-4,
                                                        True, 6.0)
        torch.cuda.synchronize()
        edge = ((weight - 1e-4).abs() <= 1e-10)[..., None]
        _grad_close([got[0], torch.where(edge, 0.0, got[1])],
                    [want[0], torch.where(edge, 0.0, want[1])])

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
    for model_aabb in (MODEL_AABB, None):
        assert torch.equal(occupancy.occupancy_trilinear(vol, xyz, model_aabb, aabb),
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


@pytest.mark.cuda
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("P", [1, 20000])
def test_occupancy_kernels_match_plain_on_card(P, renorm):
    dev = _card()
    vol, dil, aabb, xyz = [torch.tensor(a, device=dev) for a in _mask_case(P=P)]
    model_aabb = MODEL_AABB if renorm else None
    n3, n4 = occupancy.occupancy_trilinear.launches, occupancy.occupancy_nearest.launches
    tri = occupancy.occupancy_trilinear(vol, xyz, model_aabb, aabb)
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
        assert occupancy.occupancy_trilinear(vol, xyz.reshape(4, -1, 3), model_aabb,
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
    for wrapper in (occupancy.occupancy_trilinear, occupancy.occupancy_nearest):
        with pytest.raises(ValueError):
            wrapper(vol.double(), xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol.permute(2, 1, 0), xyz, MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, xyz[:, :2].contiguous(), MODEL_AABB, aabb)
        with pytest.raises(ValueError):
            wrapper(vol, xyz, MODEL_AABB, aabb.cpu())
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

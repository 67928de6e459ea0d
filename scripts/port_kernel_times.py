"""Device times of the port's K1 (plane_product_fwd), K2 (composite_fwd), K2b
(composite_bwd), K1b (plane_product_bwd), K3 (occupancy_trilinear), K4
(occupancy_nearest), K5 (row_gather) and of the static lookup's K6
(plane_line_fwd), K6d (plane_line_density_fwd) and K6b (plane_line_bwd), VM
and CP, for the ``nvfi_torch`` package of a given checkout, so that the
kernels of two commits can be compared on one card in one call:

    python3 scripts/port_kernel_times.py [--tree DIR] [--mask PATH]
                                         [--group all|keyframe|static]

DIR defaults to this checkout. The kernels are DIR's; the inputs, the bat
model's seeded planes and the timing are those of this checkout's
``chip_smoke.py`` (``composite_inputs``, ``composite_grad_inputs``,
``plane_grad_inputs``, ``mask_kernel_inputs``, ``bat_params``, ``static_bat``,
``static_coords``, ``static_step_grad_inputs``, ``graph_ms``: CUDA graphs,
the card's time without the host's cost of a call). ``--group keyframe``
times K1 to K5 alone, ``--group static`` K6, K6d and K6b and the static step
and frame alone (default: both). Every kernel is timed through an entry
point that every checkout has.

Keyframe group: K2 through
``ops.compositing._launch_composite`` at the render chunk's (4096, 686) and
the train chunk's (128, 686); K2b through ``composite_backward`` with the
train step's grads (g_rgb alone) at the same two shapes; K1b through
``ops.grid_sample.plane_product_backward``, zeroing the plane grads included,
at phase K1b's uniform coords and with every incoming grad non-zero, in both
arms (float32, and bf16 with g_app cast to bf16), with a digest of its
grad_xyzt (which no atomic touches); K3
through ``fields.kplane.sample_alpha`` on the ray-ordered samples of the
middle 4096-ray render chunk at t = 0.4 with the bat mask; K4 through
``fields.kplane.sample_occupied`` (the mask looked up in the shrunk box, as
chip_smoke's phase K4 does) at the pruned train step's shapes, P = 87,808
and 262,144, and at a render chunk's 2,809,856, each also held equal to
``occupancy_nearest_reference``; K5 launched alone (without the wrapper's
index-range check, which reads back to the host) at the probe's shape and at
turbo's three picks of bat (``bat_picks``), each held equal to
``tab[idx]``; K1 through ``ops.grid_sample.plane_product`` on the
ray-ordered middle render chunk at t = 0.4 and on uniform coords of the same
size, and K1d through ``plane_product_density`` on the grid-ordered middle
chunk of the 199^3 mask sweep at t = 0.4, each in both arms (float32 and
bf16), with a digest of its outputs (the first 16 hex digits of the SHA-256
of density and app), so that two trees' K1, K1d and K1b can be held bit for
bit.
The mask (``update_alpha_mask`` on the 199^3 grid,
volume and aabb) is built on the first run and kept in PATH (default
``build/port_kernel_times/mask.npz``, git-ignored), so that every tree is
timed on the same mask; ``checkpoint.alpha_state_from_numpy`` of DIR makes
its alpha state.

Static group, on the seeded blob fields of chip_smoke's phase K6 at bat's
widths (199^3, Cd 24, Ca 48), VM and CP: K6 through ``ops.plane_line.plane_line``
at the train step's 2048 x 686 jittered samples and at the middle 4096-ray
render chunk, K6d through ``plane_line_density`` at the grid-ordered middle
chunk of the 199^3 mask sweep, each with a digest of its outputs; K6b
through ``plane_line_backward`` (zeroing the grads included) on one real
static step's coords and incoming grads; for VM also the median of ten
synchronized ``train.static.make_static_step`` steps at 199^3 (after three),
the 199^3 mask build's seconds and a masked 400^2 frame's rays/s (two
frames). Prints one JSON object. Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--mask", default=os.path.join(HERE, "build", "port_kernel_times",
                                                   "mask.npz"))
    ap.add_argument("--group", choices=("all", "keyframe", "static"), default="all")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # chip_smoke's `import nvfi_torch` finds DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch = smoke.torch
    if not torch.cuda.is_available():
        sys.exit("port_kernel_times: no CUDA device")
    dev = torch.device("cuda")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    if args.group != "static":
        keyframe_times(smoke, args, dev, out)
    if args.group != "keyframe":
        static_times(smoke, dev, out)
    print(json.dumps(out))


def digest(*tensors):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def static_times(smoke, dev, out):
    torch, np, plane_line = smoke.torch, smoke.np, smoke.plane_line
    pose = smoke.look_at(4.0, 0.6, 0.35)
    o, d = smoke.rays.ray_bundle(pose, smoke.IMAGE, smoke.IMAGE, smoke.FOCAL)
    mid = smoke.IMAGE * smoke.IMAGE // 2
    n_sweep = -(-int(np.prod(smoke.STATIC_MASK_GRID)) // smoke.ALPHA_CHUNK)
    for arm in ("VM", "CP"):
        sfx = "_cp" if arm == "CP" else ""
        meta, params, white_bg, cfg = smoke.static_bat(arm, dev)
        groups = smoke.static_groups(params, meta)
        hp = smoke.replace(smoke.trainer.TrainHP.from_cfg(cfg), n_rays=smoke.STATIC_TRAIN_RAYS)
        to, td, _ = smoke.static_train_rays(o, d, hp.n_rays, smoke.SEED + 31)
        inputs = {"train_step": smoke.static_coords(meta, to, td, dev, jitter_seed=smoke.SEED + 32),
                  "render_chunk": smoke.static_coords(meta, o.reshape(-1, 3)[mid:mid + smoke.CHUNK],
                                                      d.reshape(-1, 3)[mid:mid + smoke.CHUNK], dev)}
        sweep = smoke.grid_ordered_xyz(meta, smoke.STATIC_MASK_GRID, n_sweep // 2, dev)
        with torch.no_grad():
            for tag, x in inputs.items():
                out[f"plane_line_fwd{sfx}_{tag}_sha256"] = digest(*plane_line.plane_line(*groups, x))
                out[f"plane_line_fwd{sfx}_{tag}_{x.shape[0]}_ms"] = smoke.graph_ms(
                    lambda: plane_line.plane_line(*groups, x))
            dens = plane_line.plane_line_density(groups[0], groups[1], sweep)
            out[f"plane_line_density_fwd{sfx}_sweep_chunk_sha256"] = digest(dens)
            out[f"plane_line_density_fwd{sfx}_sweep_chunk_{sweep.shape[0]}_ms"] = smoke.graph_ms(
                lambda: plane_line.plane_line_density(groups[0], groups[1], sweep))
        del inputs, sweep, dens
        xyz, g_density, g_app = smoke.static_step_grad_inputs(meta, params, white_bg, hp, dev)
        out[f"plane_line_bwd{sfx}_train_step_{xyz.shape[0]}_ms"] = smoke.graph_ms(
            lambda: plane_line.plane_line_backward(*groups, xyz, g_density, g_app))
        del xyz, g_density, g_app
        if arm == "VM":
            static_step_and_frame(smoke, meta, params, white_bg, hp, o, d, dev, out)
        del params, groups
        torch.cuda.empty_cache()


def static_step_and_frame(smoke, meta, params, white_bg, hp, o, d, dev, out, steps=10, warmup=3):
    """The median of ``steps`` synchronized static steps (after ``warmup``),
    the 199^3 mask build and two masked 400^2 frames."""
    torch, np, time = smoke.torch, smoke.np, smoke.time
    step = smoke.static.make_static_step(meta, hp, smoke.IMAGE, smoke.IMAGE, smoke.FOCAL, dev)
    p = smoke.kplane.map_params(lambda x: x.detach().clone(), params)
    opt_state = smoke.optim.init_state(p)
    poses, images = smoke.static_target(dev)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 33)
    secs = []
    for it in range(warmup + steps):
        draws = smoke.static.draw_static_inputs(gen, hp, smoke.IMAGE, smoke.IMAGE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt_state, _ = step(p, opt_state, draws, 0, it, poses, images)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["static_step_median_s"] = float(np.median(secs[warmup:]))
    out["static_step_s"] = secs[warmup:]
    del p, opt_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = smoke.tensorf_vm.update_alpha_mask(params, meta, smoke.STATIC_MASK_GRID, device=dev)
    torch.cuda.synchronize()
    out["static_mask_s"] = time.perf_counter() - t0
    rays_o, rays_d = o.reshape(-1, 3), d.reshape(-1, 3)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, rays_o.shape[0], smoke.CHUNK):
            smoke.tensorf_vm.render_rays(params, meta, rays_o[i:i + smoke.CHUNK],
                                         rays_d[i:i + smoke.CHUNK], white_bg=white_bg,
                                         alpha_state=state, device=dev)
        torch.cuda.synchronize()
        rates.append(rays_o.shape[0] / (time.perf_counter() - t0))
    out["static_frame_rays_per_s"] = rates


def keyframe_times(smoke, args, dev, out):
    torch, np, compositing, grid_sample = smoke.torch, smoke.np, smoke.compositing, smoke.grid_sample
    from nvfi_torch.train import checkpoint

    meta, white_bg = smoke.bat_meta()
    S = meta.n_samples
    thres, far = meta.raymarch_weight_thres, meta.near_far[1]
    for n in (smoke.CHUNK, smoke.TRAIN_RAYS):
        cargs = smoke.composite_inputs(n, S, meta.step_size, dev)
        out[f"composite_fwd_{n}x{S}_ms"] = smoke.graph_ms(
            lambda: compositing._launch_composite(*cargs, thres, white_bg, far, False))
        gargs, grads = smoke.composite_grad_inputs(n, S, meta.step_size, dev)
        weight, _, _, _, raw = compositing._launch_composite(*gargs, thres, white_bg, far, True)
        out[f"composite_bwd_{n}x{S}_ms"] = smoke.graph_ms(lambda: compositing.composite_backward(
            *gargs, weight, raw, grads[0], None, None, None, thres, white_bg, far))
    params = smoke.bat_params(meta, dev)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    # the bf16 plane copies, made here in every tree: a tree whose K1b.bf16
    # reads them would otherwise make them before the kernels below and
    # another after, and the kernels would be timed on other allocations
    grid_sample.bf16_planes(list(ps) + list(pt), ps[0].shape[-1])
    P = smoke.TRAIN_RAYS * S
    for tag, dense in (("uniform", False), ("dense_grads", True)):
        x, gd, ga = smoke.plane_grad_inputs(meta, P, dev, dense=dense)
        for arm, g_app in (("", ga), ("_bf16", ga.to(torch.bfloat16))):
            dt = g_app.dtype
            g_xyzt = grid_sample.plane_product_backward(ps, pt, x, cd, gd, g_app,
                                                        compute_dtype=dt)[1]
            digest = hashlib.sha256(g_xyzt.cpu().numpy().tobytes())
            out[f"plane_product_bwd{arm}_{tag}_grad_xyzt_sha256"] = digest.hexdigest()[:16]
            out[f"plane_product_bwd{arm}_{tag}_{P}_ms"] = smoke.graph_ms(
                lambda: grid_sample.plane_product_backward(ps, pt, x, cd, gd, g_app,
                                                           compute_dtype=dt))
            del g_xyzt

    if not os.path.exists(args.mask):
        grid = tuple(min(g, 200) for g in meta.grid_size)
        state, new_aabb = smoke.kplane.update_alpha_mask(params, meta, grid, device=dev)
        os.makedirs(os.path.dirname(args.mask), exist_ok=True)
        np.savez(args.mask, volume=state["volume"].cpu().numpy(),
                 aabb=state["aabb"].cpu().numpy(), new_aabb=np.asarray(new_aabb, np.float32))
    saved = np.load(args.mask)
    vol = torch.tensor(saved["volume"], device=dev)
    alpha_state = checkpoint.alpha_state_from_numpy(
        {"volume": saved["volume"], "aabb": saved["aabb"],
         "dilated": smoke.kplane.corner_dilate(vol).cpu().numpy()}, dev)
    pose = smoke.look_at(4.0, 0.6, 0.35)
    o, d = smoke.rays.ray_bundle(pose, smoke.IMAGE, smoke.IMAGE, smoke.FOCAL)
    mid = smoke.IMAGE * smoke.IMAGE // 2
    pts, _, _ = smoke.kplane.sample_ray(
        meta, torch.tensor(o.reshape(-1, 3)[mid:mid + smoke.CHUNK], dtype=torch.float32,
                           device=dev),
        torch.tensor(d.reshape(-1, 3)[mid:mid + smoke.CHUNK], dtype=torch.float32, device=dev), S)
    xyz = smoke.kplane.normalize_coord(meta, pts).reshape(-1, 3).contiguous()
    out[f"occupancy_trilinear_ray_ordered_{xyz.shape[0]}_ms"] = smoke.graph_ms(
        lambda: smoke.kplane.sample_alpha(alpha_state, xyz, meta))
    o_mid, d_mid = o.reshape(-1, 3)[mid:mid + smoke.CHUNK], d.reshape(-1, 3)[mid:mid + smoke.CHUNK]
    ray_xyzt = smoke.ray_ordered_xyzt(meta, o_mid, d_mid, smoke.TIMES[0], dev)
    rng = np.random.RandomState(smoke.SEED + 1)
    uniform_xyzt = torch.tensor(rng.uniform(-1.1, 1.1, tuple(ray_xyzt.shape)).astype(np.float32),
                                device=dev)
    n_chunks = -(-int(np.prod([min(g, 200) for g in meta.grid_size])) // smoke.ALPHA_CHUNK)
    grid_xyzt = smoke.grid_ordered_xyzt(meta, smoke.TIMES[0], n_chunks // 2, dev)
    for arm, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
        for tag, x in (("ray_ordered", ray_xyzt), ("uniform", uniform_xyzt)):
            density, app = grid_sample.plane_product(ps, pt, x, cd, dt)
            digest = hashlib.sha256(density.cpu().numpy().tobytes()
                                    + app.view(torch.int16 if arm else torch.float32)
                                    .cpu().numpy().tobytes())
            out[f"plane_product_fwd{arm}_{tag}_sha256"] = digest.hexdigest()[:16]
            out[f"plane_product_fwd{arm}_{tag}_ms"] = smoke.graph_ms(
                lambda: grid_sample.plane_product(ps, pt, x, cd, dt))
            del density, app
        density = grid_sample.plane_product_density(ps, pt, grid_xyzt, cd, dt)
        digest = hashlib.sha256(density.cpu().numpy().tobytes())
        out[f"plane_product_density_fwd{arm}_grid_ordered_sha256"] = digest.hexdigest()[:16]
        out[f"plane_product_density_fwd{arm}_grid_ordered_ms"] = smoke.graph_ms(
            lambda: grid_sample.plane_product_density(ps, pt, grid_xyzt, cd, dt))
        del density
    del ray_xyzt, uniform_xyzt, grid_xyzt
    uniform, box = smoke.mask_kernel_inputs(meta, alpha_state, saved["new_aabb"], dev)
    boxed = dict(alpha_state, aabb=box)  # the mask looked up in the shrunk box
    for n in (P, smoke.bat_train_hp().vel_reg_n_pts, smoke.CHUNK * S):
        pts_n = uniform[:n]
        got = smoke.kplane.sample_occupied(boxed, pts_n, meta)
        out[f"occupancy_nearest_{n}_exact"] = bool(torch.equal(
            got, smoke.occupancy.occupancy_nearest_reference(alpha_state["dilated"], pts_n,
                                                              meta.aabb_np, box)))
        out[f"occupancy_nearest_{n}_ms"] = smoke.graph_ms(
            lambda: smoke.kplane.sample_occupied(boxed, pts_n, meta))
    del uniform
    tables, sel = bat_picks(smoke, meta, alpha_state, o_mid, d_mid, dev)
    picks = {"probe": (torch.ones(512, 128, device=dev),
                       (torch.arange(1024, device=dev) % 512).to(torch.int32))}
    picks.update({f"pick_{name}": (tab, sel) for name, tab in tables.items()})
    for name, (tab, idx) in picks.items():
        buf = torch.empty(idx.shape[0], tab.shape[1], device=dev)
        launch = row_gather_launch(smoke, tab, idx, buf)
        launch()
        out[f"row_gather_{name}_exact"] = bool(torch.equal(buf, tab[idx.long()]))
        out[f"row_gather_{name}_{idx.shape[0]}x{tab.shape[1]}_ms"] = smoke.graph_ms(launch)


def bat_picks(smoke, meta, alpha_state, o, d, dev):
    """Turbo's picks of one 4096-ray render chunk of bat at t = 0.4, as the
    block-sparse render makes them (nvfi_tpu/fields/kplane.py:849-863): the
    sample axis padded to whole blocks of ``meta.sample_block`` samples; a
    block is active where one of its samples is valid (in the box, and
    trilinear mask > 0 as the masked eval render tests it); B = the active
    blocks rounded up to a multiple of 8; ``sel`` = the active blocks in
    order, then the first inactive ones.  Returns ({table name: (N * nb,
    SB * c) table}, sel int32)."""
    torch, kplane = smoke.torch, smoke.kplane
    SB = meta.sample_block
    o = torch.as_tensor(o, dtype=torch.float32, device=dev)
    d = torch.as_tensor(d, dtype=torch.float32, device=dev)
    N, S = o.shape[0], meta.n_samples
    nb = -(-S // SB)
    pad = nb * SB - S
    pts, _, valid = kplane.sample_ray(meta, o, d, S)
    xyz = kplane.normalize_coord(meta, pts)
    valid = valid & (kplane.sample_alpha(alpha_state, xyz.reshape(-1, 3), meta) > 0).reshape(N, S)
    xyz = torch.cat([xyz, xyz.new_zeros(N, pad, 3)], 1)
    valid = torch.cat([valid, valid.new_zeros(N, pad)], 1)
    t = torch.full((N, nb * SB, 1), smoke.TIMES[0], device=dev)
    active = valid.reshape(N * nb, SB).any(-1)
    n_active = int(active.sum())
    B = min(N * nb, max(8, (n_active + 7) // 8 * 8))
    sel = torch.argsort((~active).to(torch.int8), stable=True)[:B].to(torch.int32)
    tables = {name: x.reshape(N * nb, -1).contiguous() for name, x in
              (("xyz", xyz), ("t", t), ("base_times", kplane.snap_to_keyframe(meta, t)))}
    return tables, sel


def row_gather_launch(smoke, tab, idx, out):
    """K5 alone on checked inputs, without the wrapper's index check (which
    reads back to the host): the tree's C entry, (tab, idx, n, C, out, stream)
    in both of K5's designs."""
    lib, kernels = smoke.kernels.load(), smoke.kernels
    return lambda: kernels.check(lib.nvfi_row_gather_fwd(
        tab.data_ptr(), idx.data_ptr(), idx.shape[0], tab.shape[1], out.data_ptr(),
        kernels.stream_ptr(tab.device)), "row_gather_fwd")


if __name__ == "__main__":
    main()

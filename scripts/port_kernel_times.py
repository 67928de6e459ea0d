"""Device times of the port's K1 (plane_product_fwd), K2 (composite_fwd), K2b
(composite_bwd), K1b (plane_product_bwd), K3 (occupancy_trilinear) and K4
(occupancy_nearest) for the ``nvfi_torch`` package of a given checkout, so
that the kernels of two commits can be compared on one card in one call:

    python3 scripts/port_kernel_times.py [--tree DIR] [--mask PATH]

DIR defaults to this checkout. The kernels are DIR's; the inputs, the bat
model's seeded planes and the timing are those of this checkout's
``chip_smoke.py`` (``composite_inputs``, ``composite_grad_inputs``,
``plane_grad_inputs``, ``mask_kernel_inputs``, ``bat_params``, ``graph_ms``:
CUDA graphs, the card's time without the host's cost of a call). Every kernel
is timed through an entry point that every checkout has: K2 through
``ops.compositing._launch_composite`` at the render chunk's (4096, 686) and
the train chunk's (128, 686); K2b through ``composite_backward`` with the
train step's grads (g_rgb alone) at the same two shapes; K1b through
``ops.grid_sample.plane_product_backward``, zeroing the plane grads included,
at phase K1b's uniform coords and with every incoming grad non-zero, in both
arms (float32, and bf16 with g_app cast to bf16), with a digest of its
grad_xyzt (which no atomic touches); K3
through ``fields.kplane.sample_alpha`` on the ray-ordered samples of the
middle 4096-ray render chunk at t = 0.4 with the bat mask; K4 through
``ops.occupancy.occupancy_nearest`` at the pruned train step's shapes, P =
87,808 and 262,144; K1 through ``ops.grid_sample.plane_product`` on the
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
its alpha state. Prints one JSON object. Needs a card.
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
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # chip_smoke's `import nvfi_torch` finds DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch, np, compositing, grid_sample = smoke.torch, smoke.np, smoke.compositing, smoke.grid_sample
    from nvfi_torch.train import checkpoint

    if not torch.cuda.is_available():
        sys.exit("port_kernel_times: no CUDA device")
    dev = torch.device("cuda")
    meta, white_bg = smoke.bat_meta()
    S = meta.n_samples
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
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
    for n in (P, smoke.bat_train_hp().vel_reg_n_pts):
        pts_n = uniform[:n]
        out[f"occupancy_nearest_{n}_ms"] = smoke.graph_ms(lambda: smoke.occupancy.occupancy_nearest(
            alpha_state["dilated"], pts_n, meta.aabb_np, box))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

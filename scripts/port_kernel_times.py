"""Device times of the port's K2 (composite_fwd) and K1b (plane_product_bwd)
for the ``nvfi_torch`` package of a given checkout, so that the kernels of two
commits can be compared on one card in one call:

    python3 scripts/port_kernel_times.py [--tree DIR]

DIR defaults to this checkout. The kernels are DIR's; the inputs, the bat
model's seeded planes and the timing are those of this checkout's
``chip_smoke.py`` (``composite_inputs``, ``plane_grad_inputs``, ``bat_params``,
``graph_ms``: CUDA graphs, the card's time without the host's cost of a
call). K2 is timed through ``ops.compositing._launch_composite`` at the render
chunk's (4096, 686) and the train chunk's (128, 686); K1b through
``ops.grid_sample.plane_product_backward``, zeroing the plane grads included
(the entry point every checkout has), at phase K1b's uniform coords and with
every incoming grad non-zero. Prints one JSON object. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)  # chip_smoke's `import nvfi_torch` finds DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch, compositing, grid_sample = smoke.torch, smoke.compositing, smoke.grid_sample
    if not torch.cuda.is_available():
        sys.exit("port_kernel_times: no CUDA device")
    dev = torch.device("cuda")
    meta, white_bg = smoke.bat_meta()
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    extra = (meta.raymarch_weight_thres, white_bg, meta.near_far[1], False)
    for n in (smoke.CHUNK, smoke.TRAIN_RAYS):
        args = smoke.composite_inputs(n, meta.n_samples, meta.step_size, dev)
        out[f"composite_fwd_{n}x{meta.n_samples}_ms"] = smoke.graph_ms(
            lambda: compositing._launch_composite(*args, *extra))
    params = smoke.bat_params(meta, dev)
    ps, pt, cd = params["planes_space"], params["planes_time"], meta.density_n_comp
    P = smoke.TRAIN_RAYS * meta.n_samples
    for tag, dense in (("uniform", False), ("dense_grads", True)):
        x, gd, ga = smoke.plane_grad_inputs(meta, P, dev, dense=dense)
        out[f"plane_product_bwd_{tag}_{P}_ms"] = smoke.graph_ms(
            lambda: grid_sample.plane_product_backward(ps, pt, x, cd, gd, ga))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Count K1b launches that leave rows of grad_xyzt unwritten.

    python3 scripts/k1b_unwritten_rows.py [--tree build/parent] [--launches 200]

Launches ``nvfi_plane_product_bwd`` of ``--tree`` (this checkout by default;
another commit's ``git archive`` unpacked under ``build/`` to compare) again
and again into a NaN-filled grad_xyzt, in both arms, on seeded planes at
bat's width (199^2 space planes, 16 keyframes, 72 channels of which 24
density) and on their first 18 channels (a model-axis slice without app
channels), at a train chunk's 128 x 686 samples of which half have a
non-zero incoming grad.  A launch counts when any row differs from a launch
into a zeroed buffer: every row, an inactive sample's zero too, is the
kernel's to write.  Prints one line an input.  Needs a card.
"""

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="the checkout whose kernel runs")
    ap.add_argument("--launches", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    import torch

    from nvfi_torch.ops import grid_sample

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    S, K, C, CD, P = 199, 16, 72, 24, 128 * 686
    ps = [torch.tensor(rng.randn(S, S, C).astype(np.float32) * 0.5, device=dev)
          for _ in range(3)]
    pt = [torch.tensor(rng.randn(K, S, C).astype(np.float32) * 0.5 + 1, device=dev)
          for _ in range(3)]
    x = torch.tensor(np.c_[rng.uniform(-1, 1, (P, 3)), np.full((P, 1), 0.2)].astype(np.float32),
                     device=dev)
    live = rng.rand(P) < 0.5
    gd = torch.tensor((rng.randn(P) * live).astype(np.float32), device=dev)
    ga32 = torch.tensor((rng.randn(P, C - CD) * live[:, None]).astype(np.float32), device=dev)
    for tag, lo, hi, bf16 in (("f32 C=72", 0, 72, False), ("bf16 C=72", 0, 72, True),
                              ("f32 [0,18)", 0, 18, False), ("bf16 [0,18)", 0, 18, True)):
        planes = [p[..., lo:hi].contiguous() for p in ps + pt]
        cd = min(max(CD - lo, 0), hi - lo)
        ga = ga32[:, max(lo, CD) - CD:max(hi, CD) - CD].contiguous()
        ga = ga.to(torch.bfloat16) if bf16 else ga
        grads = grid_sample._zero_plane_grads(planes)
        ref = torch.zeros_like(x)
        grid_sample.launch_plane_product_backward(planes, x, cd, gd, ga, grads, ref)
        bad = rows = 0
        for _ in range(args.launches):
            gx = torch.full_like(x, float("nan"))
            grid_sample.launch_plane_product_backward(planes, x, cd, gd, ga, grads, gx)
            differ = int((gx.view(torch.int32) != ref.view(torch.int32)).any(-1).sum())
            bad += differ > 0
            rows += differ
        torch.cuda.synchronize()
        print(f"[race] {tag}: {bad} of {args.launches} launches left rows unwritten ({rows} rows "
              f"in all)", flush=True)


if __name__ == "__main__":
    main()

"""Chunked image rendering (port of ``nvfi_tpu/render/renderer.py:35-112``).

An eager loop over fixed-size ray chunks around ``kplane.render_rays``.  The
step bucketing and the padding of the last chunk are the JAX package's, so the
two render the same image: the last chunk is padded with zero origins, which
lie inside the box, so that whole chunk starts at ``near`` (see
``kplane.sample_ray``; ROADMAP.md C records this JAX behaviour).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields import kplane


@torch.inference_mode()
def render_image(
    params,
    meta: kplane.KPlaneMeta,
    t: float,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    *,
    white_bg: bool,
    transfer_vel: bool = False,
    alpha_state=None,
    mask_params=None,
    chunk: int = 4096,
    device="cuda",
):
    """Render a full image (eval mode, dense-exact).

    Args:
      params: on ``device``.
      rays_o, rays_d: (H, W, 3) host arrays (from ``rays.ray_bundle``).
      alpha_state: optional occupancy mask on ``device``; prunes samples.
    Returns:
      dict of numpy maps: rgb (H,W,3), depth (H,W), acc (H,W), and
      ``dropped``, the JAX package's budget-exactness count, which is always
      0.0 on the dense path (``harness.render_split`` reads it).
    """
    dev = resolve_device(device)
    H, W = rays_o.shape[:2]
    o = np.asarray(rays_o, dtype=np.float32).reshape(-1, 3)
    d = np.asarray(rays_d, dtype=np.float32).reshape(-1, 3)
    n = o.shape[0]

    # two step buckets: every t <= tmax needs exactly one RK2 step, the rest
    # take the full bound (extra steps are dt = 0 no-ops, so this is exact)
    exact_steps = kplane.render_steps_for_time(meta, t, transfer_vel)
    bound = meta.transfer_adv_steps if transfer_vel else meta.render_adv_steps
    adv_steps = 1 if exact_steps == 1 else bound

    outs = {"rgb": [], "depth": [], "acc": []}
    for start in range(0, n, chunk):
        co = o[start : start + chunk]
        cd = d[start : start + chunk]
        pad = chunk - co.shape[0]
        if pad:
            co = np.concatenate([co, np.zeros((pad, 3), co.dtype)])
            cd = np.concatenate([cd, np.tile(d[-1:], (pad, 1))])
        res = kplane.render_rays(
            params, meta, t, co, cd, white_bg=white_bg, training=False,
            transfer_vel=transfer_vel, alpha_state=alpha_state, mask_params=mask_params,
            adv_steps=adv_steps, device=dev,
        )
        for k in outs:
            outs[k].append(res[k][: chunk - pad])

    merged = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
    merged["rgb"] = merged["rgb"].reshape(H, W, 3)
    merged["depth"] = merged["depth"].reshape(H, W)
    merged["acc"] = merged["acc"].reshape(H, W)
    merged["dropped"] = 0.0
    return merged

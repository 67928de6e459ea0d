"""Physics PDE regularization of the velocity field.

Port of ``nvfi_tpu/physics/pde.py``: uniform (x, t) samples in aabb x [0, 1),
filtered by the density at the backward-advected keyframe position (no
gradient), then the per-point Jacobian of the velocity net in forward mode
(4 inputs -> 6 outputs) and

    loss = 5 * mean(div^2) + 0.1 * mean(transport^2),
    div = tr(dv/dx),  transport = (v . grad) v + dv/dt - a,

with the means taken over the surviving points (x3 components for the
transport term).  As in the JAX package the filter is a masked mean over a
fixed number of points, the times are stratified into [0, tmax) and [tmax, 1)
so that each stratum's advection depth is static, and ``occupied_budget``
runs the Jacobian on a uniform subsample of the occupied points only.

What the JAX package draws from its key is an argument here: the uniform
numbers behind the points, the times and the selection noise.  The velocity
net's products stay ``torch`` matmuls; the density lookup of the filter is
kernel K1d, the mask lookups K4 (``prefilter_state``) and K3 (``alpha_state``).
With ``compute_dtype = "bfloat16"`` only the filter's density lookup takes
the bf16 arm (K1d.bf16): the params are not cast here, as in the JAX package,
so the filter's advection and the Jacobian run in float32.
"""

from __future__ import annotations

import torch

from ..fields import kplane
from ..fields import velocity as vel_mod


@torch.no_grad()
def occupancy_mask(params, meta: kplane.KPlaneMeta, xyz_norm: torch.Tensor, t: torch.Tensor,
                   n_steps: int | None = None) -> torch.Tensor:
    """Density-based point filter, without gradient: (N,) bool,
    ``alpha >= alphaMask_thres`` with the proxy opacity
    ``1 - exp(-sigma * 0.01 * 25)``.

    ``t`` may lie past tmax, where the snapped offset exceeds dt_max: the
    default step count is the eval bound; a caller that knows every t is
    within dt_max of its keyframe passes 1."""
    base = kplane.snap_to_keyframe(meta, t)
    if n_steps is None:
        n_steps = meta.render_adv_steps
    prev = kplane.integrate_pos(params, meta, xyz_norm, t, base, n_steps=n_steps)
    xyzt = torch.cat([prev, kplane.normalize_time(meta, base)], dim=-1)
    sigma = kplane.feature2density(meta, kplane.density_feature(params, meta, xyzt))
    alpha = 1.0 - torch.exp(-sigma * 0.01 * 25.0)
    return alpha >= torch.tensor(meta.alpha_mask_thres, dtype=alpha.dtype, device=alpha.device)


def _strata_budgets(occupied_budget: int, n1: int, n2: int, tmax: float) -> tuple[int, int]:
    """Per-stratum budgets, proportional to the strata and clamped into
    [1, stratum size]."""
    if occupied_budget < 2:
        raise ValueError(f"occupied_budget={occupied_budget} too small for the 2-stratum "
                         "time split (needs >= 1 point per stratum)")
    b1 = min(n1, max(1, int(round(occupied_budget * tmax))))
    b2 = occupied_budget - b1
    if not 1 <= b2 <= n2:
        b2 = min(max(b2, 1), n2)
        b1 = occupied_budget - b2
    if not (1 <= b1 <= n1 and 1 <= b2 <= n2):
        raise ValueError(f"infeasible PDE strata split: budget={occupied_budget} n1={n1} "
                         f"n2={n2} -> b1={b1} b2={b2}")
    return b1, b2


def vel_pde_loss(params, meta: kplane.KPlaneMeta, points_u: torch.Tensor,
                 times_u: torch.Tensor, sel_noise: torch.Tensor, chunk: int = 32768,
                 occupied_budget: int | None = None, alpha_state: dict | None = None,
                 prefilter_state: dict | None = None) -> torch.Tensor:
    """Divergence-free + transport-equation loss over occupied samples.

    Args:
      points_u (n, 3), times_u (n, 1), sel_noise (n,): uniform numbers in
        [0, 1): the points are ``points_u`` scaled into the aabb, the times
        ``times_u`` mapped into their stratum, and ``sel_noise`` breaks the
        ties of the budget's top-k.
      occupied_budget: run the Jacobian on this many points, chosen uniformly
        among the occupied ones (top-k over occupancy + noise).
      alpha_state: replace the advect-then-density filter by one trilinear
        lookup in the occupancy volume (K3); keeps a superset of the points.
      prefilter_state: the occupancy volume only routes the budget: points
        are pre-screened by one dilated lookup (K4), the budget is drawn among
        the pre-passing points per time stratum, and the exact filter runs on
        the selected points only.
    The Jacobian chunks stay in one autograd graph (one chunk at the default
    budget).
    """
    n_pts = points_u.shape[0]
    a = meta.aabb_np
    pts = points_u * kplane._f32(a[1] - a[0], points_u) + kplane._f32(a[0], points_u)
    xyz = kplane.normalize_coord(meta, pts)

    split = (alpha_state is None and meta.use_vel and 0.0 < meta.tmax < 1.0
             and meta.num_keyframes > 1)
    n1 = n2 = 0
    if split:
        n1 = min(max(int(round(n_pts * meta.tmax)), 0), n_pts)
        n2 = n_pts - n1
        t = torch.cat([times_u[:n1] * meta.tmax,
                       meta.tmax + times_u[n1:] * (1.0 - meta.tmax)], dim=0)
    else:
        t = times_u
    two_strata = split and n1 > 0 and n2 > 0

    def strata_mask(xyz1, t1, xyz2, t2):
        return torch.cat([occupancy_mask(params, meta, xyz1, t1, n_steps=1),
                          occupancy_mask(params, meta, xyz2, t2,
                                         n_steps=meta.render_adv_steps)]).to(torch.float32)

    def budget_select(score, b, *arrays):
        """Uniform subsample among the passing points: their scores lie in
        [1, 2), the failing ones' in [0, 1)."""
        sel = torch.topk(score, b).indices
        return [x[sel] for x in arrays]

    budgeted = occupied_budget is not None and occupied_budget < n_pts
    if prefilter_state is not None and budgeted:
        with torch.no_grad():
            pre = kplane.sample_occupied(prefilter_state, xyz, meta).to(torch.float32)
        score = pre + sel_noise
        if two_strata:
            b1, b2 = _strata_budgets(occupied_budget, n1, n2, meta.tmax)
            xyz1, t1 = budget_select(score[:n1], b1, xyz[:n1], t[:n1])
            xyz2, t2 = budget_select(score[n1:], b2, xyz[n1:], t[n1:])
            mask = strata_mask(xyz1, t1, xyz2, t2)
            xyz, t = torch.cat([xyz1, xyz2]), torch.cat([t1, t2])
        else:
            xyz, t = budget_select(score, occupied_budget, xyz, t)
            mask = occupancy_mask(params, meta, xyz, t).to(torch.float32)
        n_pts = occupied_budget
    else:
        if alpha_state is not None:
            with torch.no_grad():
                mask = (kplane.sample_alpha(alpha_state, xyz, meta) > 0).to(torch.float32)
        elif two_strata:
            mask = strata_mask(xyz[:n1], t[:n1], xyz[n1:], t[n1:])
        else:
            mask = occupancy_mask(params, meta, xyz, t).to(torch.float32)
        if budgeted:
            xyz, t, mask = budget_select(mask + sel_noise, occupied_budget, xyz, t, mask)
            n_pts = occupied_budget

    vel_params = params["vel"]

    def u_func_aux(xt):
        u = vel_mod.vel_accel(vel_params, xt)
        return u, u

    jac_fn = torch.func.vmap(torch.func.jacfwd(u_func_aux, has_aux=True))
    chunk = min(chunk, n_pts)
    if n_pts % chunk:
        raise ValueError(f"n_pts {n_pts} must be a multiple of the PDE chunk size {chunk}")
    div_sum = trans_sum = 0.0
    for start in range(0, n_pts, chunk):
        xyzt = torch.cat([xyz[start:start + chunk], t[start:start + chunk]], dim=-1)
        mask_c = mask[start:start + chunk]
        jac, u = jac_fn(xyzt)  # (C, 6, 4), (C, 6)
        vel, acc = u[..., :3], u[..., 3:]
        divergence = jac[..., 0, 0] + jac[..., 1, 1] + jac[..., 2, 2]
        transport = (torch.einsum("noi,ni->no", jac[..., :3, :3], vel) + jac[..., :3, 3] - acc)
        div_sum = div_sum + torch.sum(mask_c * divergence**2)
        trans_sum = trans_sum + torch.sum(mask_c[:, None] * transport**2)
    n_occ = torch.sum(mask)
    denom = torch.clamp(n_occ, min=1.0)
    loss = (div_sum / denom) * 5.0 + (trans_sum / (denom * 3.0)) * 0.1
    return torch.where(n_occ > 0, loss, torch.zeros_like(loss))

"""Segmentation losses: the rigid-fit dynamic loss, the KNN smooth loss, the
entropy and rank losses (port of ``nvfi_tpu/utils/seg_loss.py``).

* ``fit_motion_svd_batch``: the mask-weighted Kabsch fit, batched, with the
  reflection corrected; a NaN covariance is replaced by the identity before
  the SVD (``torch.linalg.svd`` on the card may raise on NaN, where LAPACK
  returns NaN) and its slot gets the identity motion.
* ``dynamic_loss``: each mask slot's points must move rigidly.  The cloud
  moved by the fitted motions carries no gradient (JAX ``stop_gradient``s
  it), so the fit runs on detached tensors and builds no SVD backward, and
  in float64 (``fit_dtype``): one R and t a slot move every point of it the
  same way, so their float32 rounding (~1e-6 in R from a 3 x 3 SVD) adds up
  over all the points in the grad of the MaskField's head bias, a sum that
  nearly cancels (on the H100, ``chip_smoke.py``'s seg step: 1.3e-2 of its
  largest element with the fit in float32, 2.7e-4 in float64, against
  float64 throughout).
* ``smooth_loss``: KNN (k = 4) mask agreement; neighbours whose *squared*
  distance exceeds ``radius`` are replaced by the nearest (self), as JAX
  compares them.
* ``entropy_loss``, ``rank_loss``.

Norms are written as JAX computes them, so their derivatives agree where the
argument is 0: ``sqrt(sum(x * x))`` for ``jnp.linalg.norm`` and
``where(x >= 0, x, -x)`` for ``jnp.abs`` (+1 at 0; ``torch.abs`` gives 0).
"""

from __future__ import annotations

import torch

from ..fields.kplane import abs_jax  # |x| with JAX's derivative at 0 (+1)
from ..ops.knn import knn


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1)`` as JAX computes it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def fit_motion_svd_batch(pc1: torch.Tensor, pc2: torch.Tensor, mask: torch.Tensor | None = None):
    """Weighted Kabsch fit per batch.

    Args:
      pc1, pc2: (B, N, 3); mask: optional (B, N) weights.
    Returns:
      R (B, 3, 3), t (B, 3).
    """
    if mask is None:
        pc1_mean = torch.mean(pc1, dim=1, keepdim=True)
        pc2_mean = torch.mean(pc2, dim=1, keepdim=True)
        w = torch.ones(pc1.shape[:2], dtype=pc1.dtype, device=pc1.device)
    else:
        safe = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1e-12)
        pc1_mean = (torch.einsum("bnd,bn->bd", pc1, mask) / safe)[:, None]
        pc2_mean = (torch.einsum("bnd,bn->bd", pc2, mask) / safe)[:, None]
        w = mask

    pc1_c = pc1 - pc1_mean
    pc2_c = pc2 - pc2_mean
    S = torch.einsum("bnd,bn,bne->bde", pc1_c, w, pc2_c)

    # ill-posed (NaN) covariances take the identity, before the SVD
    bad = torch.any(torch.isnan(S).flatten(1), dim=1)
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand_as(S)
    S_safe = torch.where(bad[:, None, None], eye, S)

    u, _, vh = torch.linalg.svd(S_safe)
    v = vh.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    diag = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = v @ (diag[..., None] * ut)
    t = pc2_mean[:, 0] - torch.einsum("bij,bj->bi", R, pc1_mean[:, 0])

    R = torch.where(bad[:, None, None], eye, R)
    t = torch.where(bad[:, None], 0.0, t)
    return R, t


def dynamic_loss(pc: torch.Tensor, mask: torch.Tensor, flow: torch.Tensor,
                 fit_dtype: torch.dtype | None = torch.float64):
    """Rigid-cluster flow discrepancy.

    pc (B, N, 3), mask (B, N, K) soft assignments, flow (B, N, 3);
    ``fit_dtype``: the dtype of the rigid fit (None: the inputs', as JAX
    fits).  Returns (scalar loss, the mixture of the moved clouds (B, N, 3))."""
    n_batch, n_point, n_object = mask.shape
    pc2 = pc + flow
    with torch.no_grad():
        fit = fit_dtype or pc.dtype
        mask_flat = mask.detach().transpose(1, 2).reshape(n_batch * n_object, n_point)
        pc_rep = torch.repeat_interleave(pc.detach(), n_object, dim=0)
        pc2_rep = torch.repeat_interleave(pc2.detach(), n_object, dim=0)
        R, t = fit_motion_svd_batch(pc_rep.to(fit), pc2_rep.to(fit), mask_flat.to(fit))
        R, t = R.to(pc.dtype), t.to(pc.dtype)
        pc_tr = torch.einsum("bij,bnj->bni", R, pc_rep) + t[:, None]
        pc_tr = pc_tr.reshape(n_batch, n_object, n_point, 3)

    mixed = torch.sum(mask.transpose(1, 2)[..., None] * pc_tr, dim=1)
    loss = _norm(mixed - pc2)
    return torch.mean(loss), mixed


def smooth_loss(pc: torch.Tensor, mask: torch.Tensor, k: int = 4, radius: float = 0.01,
                loss_norm: int = 1) -> torch.Tensor:
    """KNN mask-agreement smoothness.

    pc (B, N, 3), mask (B, N, K).  Neighbours out of the radius are replaced
    by the nearest one (self), which zeroes their term."""
    losses = []
    for pc_b, mask_b in zip(pc, mask):
        with torch.no_grad():
            dist, idx = knn(pc_b.detach(), k)
            # the squared distances are compared with the radius, as in JAX
            idx = torch.where(dist > radius, idx[:, :1], idx)
        diff = mask_b[:, None, :] - mask_b[idx]
        if loss_norm == 1:
            losses.append(torch.mean(torch.sum(abs_jax(diff), dim=-1)))
        else:
            losses.append(torch.mean(torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)))
    return torch.mean(torch.stack(losses))


def entropy_loss(mask: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-point assignment entropy."""
    loss = -(mask * torch.log(torch.clamp(mask, min=epsilon)))
    return torch.mean(torch.sum(loss, dim=-1))


def rank_loss(mask: torch.Tensor) -> torch.Tensor:
    """Nuclear norm of the (N, K) mask matrices."""
    return torch.mean(torch.sum(torch.linalg.svdvals(mask), dim=-1))

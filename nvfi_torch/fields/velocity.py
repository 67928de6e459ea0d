"""Velocity field: rigid-motion-basis MLP with boundary gating.

Port of ``nvfi_tpu/fields/velocity.py:33-123``: input (x,y,z,t) ->
position encoder (3 freqs) -> a 6-layer SiLU MLP emitting 6 weights over a
rigid-motion basis (3 translations + 3 instantaneous rotations).  The gate
zeroes the velocity near the [-1,1]^3 boundary ('aabb') or outside a
normalized surround box ('sur'), as a multiplicative mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.encoding import position_encoder
from .mlp import mlp_apply, mlp_init

_ENCODE_DIM = 3
_IN_DIM = 4 + 4 * 2 * _ENCODE_DIM  # 28
_HIDDEN = 128


class VelGate(NamedTuple):
    """Static gate spec: 'aabb' zeroes velocity within ``eps`` of the [-1,1]^3
    boundary; 'sur' zeroes it outside the normalized box ``bounds``.
    ``world`` is the same box in world coordinates ('sur' only)."""

    mode: str  # 'aabb' | 'sur'
    eps: float = 0.03
    bounds: tuple = ()  # ((xmin,ymin,zmin),(xmax,ymax,zmax)) in normalized coords
    world: tuple = ()


def init_velocity_params(generator: torch.Generator, hidden: int = _HIDDEN):
    layers = [_IN_DIM] + [hidden] * 5 + [6]
    return {
        "weight_net": mlp_init(generator, layers),
        "a_weight_net": mlp_init(generator, layers),
    }


def get_vel(params, xt: torch.Tensor) -> torch.Tensor:
    """Velocity only: (..., 4) xyzt -> (..., 3).

    ``sum_i w_i b_i`` over the rigid velocity basis of the JAX package's
    ``_rigid_bases`` (b1..b3 the unit translations, b4 = (0, z, -y),
    b5 = (-z, 0, x), b6 = (y, -x, 0)) written out per component.  An
    ``einsum`` over a stacked (..., 6, 3) basis becomes 43 chunked cuBLAS
    gemv launches per evaluation at 2.8 M samples, 11-14% of a render
    chunk's device time (chip_smoke.py's profile on an H100).
    """
    enc = position_encoder(xt, _ENCODE_DIM)
    w = mlp_apply(params["weight_net"], enc, F.silu)
    x, y, z = xt[..., 0], xt[..., 1], xt[..., 2]
    w1, w2, w3, w4, w5, w6 = w.unbind(-1)
    return torch.stack([w1 - w5 * z + w6 * y, w2 + w4 * z - w6 * x, w3 - w4 * y + w5 * x], -1)


def gate_box(gate: VelGate, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of the region where the velocity is not gated off."""
    if gate.mode == "sur":
        lo, hi = gate.bounds
    else:
        e = gate.eps
        lo, hi = (-1 + e,) * 3, (1 - e,) * 3
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


def gated_velocity(params, gate: VelGate, xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Boundary-gated velocity at normalized positions xyz (..., 3), times t (..., 1)."""
    v = get_vel(params, torch.cat([xyz, t], dim=-1))
    lo, hi = gate_box(gate, xyz.device)
    inside = torch.all((xyz >= lo) & (xyz <= hi), dim=-1, keepdim=True)
    return v * inside.to(v.dtype)

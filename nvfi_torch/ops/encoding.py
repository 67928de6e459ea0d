"""Positional / Fourier encodings (port of ``nvfi_tpu/ops/encoding.py``).

Two conventions, with the JAX package's exact feature order:

* ``positional_encoding(x, freqs)`` — shader flavor: frequencies
  2^0..2^(F-1) over a ``(D, freqs)``-major flattening, all sines before all
  cosines, identity NOT included.
* ``position_encoder(x, F)`` — velocity-net flavor: identity first, then
  per-frequency ``[sin(x*f), cos(x*f)]`` pairs.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """Shader encoding: (..., D) -> (..., 2*freqs*D), sin-block then cos-block."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def position_encoder(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Velocity-net encoding: (..., D) -> (..., D*(1+2*num_freqs)), identity first."""
    out = [x]
    for i in range(num_freqs):
        f = 2.0**i
        out.append(torch.sin(x * f))
        out.append(torch.cos(x * f))
    return torch.cat(out, dim=-1)

"""MaskField: the per-point K-way object-mask MLP of the unsupervised
segmentation (port of ``nvfi_tpu/fields/mask_field.py``).

An ``n_layer`` ReLU MLP (the segmentation trainer's: 4 layers, 128 wide, no
skips) from a normalized position to a softmax over ``mask_dim`` object
slots, with an optional Fourier point embedding.  The params are the JAX
package's tree, ``{"layers": [{'w', 'b'}, ...], "head": {'w', 'b'}}``, so
``train.checkpoint.params_from_numpy`` carries JAX's init across unchanged.
The static options (skips, embedding bands, activation) go to ``apply``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.encoding import position_encoder
from .mlp import linear, linear_init


def init(generator: torch.Generator, n_layer: int = 4, n_dim: int = 128, input_dim: int = 3,
         skips: tuple = (), mask_dim: int = 2, point_embed_freqs: int = 0, device="cuda"):
    """MaskField params, drawn on the CPU from ``generator`` (torch.nn.Linear's
    init), then moved to ``device``.  ``point_embed_freqs`` bands of the
    embedding widen the input (identity plus a sine and a cosine a band)."""
    dev = resolve_device(device)
    in_dim = input_dim * (1 + 2 * point_embed_freqs) if point_embed_freqs else input_dim
    layers = []
    d = in_dim
    for l in range(n_layer):
        d_in = d + in_dim if (l > 0 and (l - 1) in skips) else d
        layers.append(linear_init(generator, d_in, n_dim))
        d = n_dim
    head = linear_init(generator, n_dim, mask_dim)

    def move(p):
        return {k: v.to(dev) for k, v in p.items()}

    return {"layers": [move(p) for p in layers], "head": move(head)}


def apply(params, xyz: torch.Tensor, skips: tuple = (), embed_freqs: int = 0,
          mask_act: str = "softmax") -> torch.Tensor:
    """(..., 3) points -> (..., mask_dim) object probabilities (``mask_act``
    "softmax" or "sigmoid"; anything else gives the logits)."""
    x = position_encoder(xyz, embed_freqs) if embed_freqs else xyz
    h = x
    for l, layer in enumerate(params["layers"]):
        h = torch.relu(linear(layer, h))
        if l in skips:
            h = torch.cat([x, h], dim=-1)
    logits = linear(params["head"], h)
    if mask_act == "softmax":
        return torch.softmax(logits, dim=-1)
    if mask_act == "sigmoid":
        return torch.sigmoid(logits)
    return logits

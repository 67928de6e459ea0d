"""Grid lifecycle ops (port of ``nvfi_tpu/ops/resize.py:49-59``).

Ported: ``max_pool3d_same``, the dilation of the alpha mask.  The JAX package
computes it with ``lax.reduce_window`` outside any kernel, so PyTorch's
``max_pool3d`` is its counterpart.  ``resize_bilinear_ac`` waits for the
trainer's upsampling (ROADMAP.md A5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool3d_same(volume: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3D max pool of a (D, H, W) volume, stride 1, same size (the padding
    counts as -inf)."""
    return F.max_pool3d(volume[None, None], kernel, stride=1, padding=kernel // 2)[0, 0]

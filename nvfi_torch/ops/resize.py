"""Grid lifecycle ops (port of ``nvfi_tpu/ops/resize.py``).

``resize_bilinear_ac`` resamples plane axes with align_corners=True
semantics for the coarse-to-fine upsample schedule, and ``max_pool3d_same``
dilates the alpha mask.  The JAX package computes both with XLA ops outside
any kernel, once per stage event, so plain PyTorch is their counterpart.
The resize is the JAX package's separable formula, op for op (not
``F.interpolate``, which rounds differently).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize_axis_ac(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Linear resample of one axis, align_corners=True: output index i reads
    input coordinate i * (in - 1) / (out - 1)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size == 1:
        return x.narrow(axis, 0, 1)
    if in_size == 1:
        reps = [1] * x.ndim
        reps[axis] = out_size
        return x.repeat(*reps)
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * (in_size - 1) \
        / (out_size - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    w = (pos - lo.to(torch.float32)).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape)
    return x.index_select(axis, lo) * (1 - w) + x.index_select(axis, hi) * w


def resize_bilinear_ac(x: torch.Tensor, out_shape: tuple, axes: tuple) -> torch.Tensor:
    """Resize the given axes of ``x`` to ``out_shape``, align_corners=True,
    one axis after another."""
    for axis, size in zip(axes, out_shape):
        x = _resize_axis_ac(x, axis, int(size))
    return x


def max_pool3d_same(volume: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3D max pool of a (D, H, W) volume, stride 1, same size (the padding
    counts as -inf)."""
    return F.max_pool3d(volume[None, None], kernel, stride=1, padding=kernel // 2)[0, 0]

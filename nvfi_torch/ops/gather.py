"""Row gather ``out[i, :] = tab[idx[i], :]`` (kernel K5).

The JAX package's only two ``pl.pallas_call`` sites are probes of exactly
this function (``tests/test_mosaic_probe.py:30``, ``scripts/perf_micro2.py:84``):
a vectorized dynamic row gather that the TPU toolchain could not lower.  It is
also the ``pick`` of the block-sparse render (``kplane.py:861-863``).

``row_gather`` is the wrapper of the hand-written CUDA kernel
``csrc/row_gather.cu``; ``row_gather_reference`` is its plain PyTorch version,
which the wrapper runs for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import kernels


def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: (R, C) table, (n,) indices -> (n, C)."""
    return tab[idx.to(torch.int64)]


def _check_row_gather_args(tab, idx):
    if tab.dim() != 2 or tab.dtype != torch.float32 or not tab.is_contiguous():
        raise ValueError(f"row_gather: tab must be contiguous float32 (R, C), got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous() \
            or idx.device != tab.device:
        raise ValueError(f"row_gather: idx must be contiguous int32 (n,) on {tab.device}, "
                         f"got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    if tab.numel() >= 2**31 or tab.shape[1] == 0:
        raise ValueError("row_gather: the table must hold fewer than 2^31 values and C >= 1")
    if tab.data_ptr() % 16:
        raise ValueError("row_gather: the table must start on a 16-byte boundary")
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()  # one read-back to the host
        if lo < 0 or hi >= tab.shape[0]:
            raise IndexError(f"row_gather: indices {lo}..{hi} outside [0, {tab.shape[0]})")


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i, :] = tab[idx[i], :]`` for a float32 table and int32 indices.

    Out-of-range indices are refused.  For CPU tensors this runs
    :func:`row_gather_reference`.  For CUDA tensors it launches
    ``nvfi_row_gather_fwd`` (csrc/row_gather.cu) or raises;
    ``row_gather.launches`` counts the launches.
    """
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather: unsupported device {tab.device}")
    _check_row_gather_args(tab, idx)
    if tab.device.type == "cpu":
        return row_gather_reference(tab, idx)
    n, C = idx.shape[0], tab.shape[1]
    out = torch.empty(n, C, dtype=torch.float32, device=tab.device)
    if n == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(tab.device):
        err = lib.nvfi_row_gather_fwd(tab.data_ptr(), idx.data_ptr(), n, C, out.data_ptr(),
                                      kernels.stream_ptr(tab.device))
    kernels.check(err, "row_gather_fwd")
    row_gather.launches += 1
    return out


row_gather.launches = 0

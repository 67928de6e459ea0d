"""Row gather ``out[i, :] = tab[idx[i], :]`` (kernel K5).

The JAX package's only two ``pl.pallas_call`` sites are probes of exactly
this function (``tests/test_mosaic_probe.py:30``, ``scripts/perf_micro2.py:84``):
a vectorized dynamic row gather that the TPU toolchain could not lower.  It is
also the ``pick`` of the block-sparse render (``kplane.py:861-863``), which
``fields/kplane.render_rays`` runs through :func:`pick_rows`: three picks a
chunk (``xyz``, ``t``, ``base_times``).

``row_gather`` and ``pick_rows`` are the wrappers of the hand-written CUDA
kernel ``csrc/row_gather.cu``; ``row_gather_reference`` is its plain PyTorch
version, which the wrappers run for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import kernels

ROW_GATHER_THREADS = 256  # csrc/row_gather.cu kThreads: a thread a float4 (or float) of out


def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: (R, C) table, (n,) indices -> (n, C)."""
    return tab[idx.to(torch.int64)]


def _check_row_gather_args(tab, idx, check_range=True):
    if tab.dim() != 2 or tab.dtype != torch.float32 or not tab.is_contiguous():
        raise ValueError(f"row_gather: tab must be contiguous float32 (R, C), got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous() \
            or idx.device != tab.device:
        raise ValueError(f"row_gather: idx must be contiguous int32 (n,) on {tab.device}, "
                         f"got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    if tab.numel() >= 2**31 or tab.shape[1] == 0 or idx.numel() * tab.shape[1] >= 2**31:
        raise ValueError("row_gather: the table and the output must hold fewer than 2^31 "
                         "values each, and C >= 1")
    if tab.data_ptr() % 16:
        raise ValueError("row_gather: the table must start on a 16-byte boundary")
    if check_range and idx.numel():
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
    out = torch.empty(idx.shape[0], tab.shape[1], dtype=torch.float32, device=tab.device)
    launch_row_gather(tab, idx, out)
    return out


def pick_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 for indices that lie in ``[0, R)`` by construction: the block-sparse
    render's picks, whose indices are a selection among the table's own rows.
    As :func:`row_gather` but without the index-range check, which reads the
    range back to the host: the picks launch with no read-back.  Counted on
    ``row_gather.launches``."""
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pick_rows: unsupported device {tab.device}")
    _check_row_gather_args(tab, idx, check_range=False)
    if tab.device.type == "cpu":
        return row_gather_reference(tab, idx)
    out = torch.empty(idx.shape[0], tab.shape[1], dtype=torch.float32, device=tab.device)
    launch_row_gather(tab, idx, out)
    return out


def launch_row_gather(tab, idx, out):
    """Launch K5 into ``out`` ((n, C) float32, contiguous, on the card) on
    arguments :func:`row_gather` has checked, and count the launch on
    ``row_gather``.  No host read-back: the kernel alone, as a CUDA graph
    captures it."""
    n, C = idx.shape[0], tab.shape[1]
    if n == 0:
        return
    lib = kernels.load()
    with torch.cuda.device(tab.device):
        err = lib.nvfi_row_gather_fwd(tab.data_ptr(), idx.data_ptr(), n, C, out.data_ptr(),
                                      kernels.stream_ptr(tab.device))
    kernels.check(err, "row_gather_fwd")
    row_gather.launches += 1


row_gather.launches = 0

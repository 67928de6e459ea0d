"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``.  Where no card is present that
default raises: the port never drops to the CPU on its own.  Callers that want
the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nvfi_torch: device 'cuda' requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"nvfi_torch runs on 'cuda' or 'cpu', not {dev.type!r}")
    return dev

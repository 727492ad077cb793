"""Device selection.

The store and its backend carry one explicit :class:`torch.device`. The
default is the first CUDA card; a machine without CUDA raises rather than
silently running the path on the CPU. Tests pass ``device="cpu"``, where
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA card (raises when CUDA is unavailable);
    anything else is taken as given (``"cpu"``, ``"cuda:1"``, a
    ``torch.device``). A CUDA device always comes back with its index, so
    it names one card from any thread."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' explicitly to run "
                "the port's plain PyTorch path on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


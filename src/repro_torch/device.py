"""Device selection for the port's entry points.

``Engine``, ``init_params``, ``params_from_numpy`` and the serving CLI
run on the card unless the caller asks for the CPU. A request for CUDA on
a machine without it raises; nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, with a CUDA index filled in
    (the current device) so that it compares equal to a tensor's."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to run the port's plain "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

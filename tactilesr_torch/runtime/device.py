"""Device selection for the port's entry points.

Entry points default to ``"cuda"``; a CUDA request on a machine with no
usable GPU raises instead of quietly running on the CPU (a CPU run would
be a different, much slower program).  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path explicitly"
        )
    return dev

"""The port's checkpoint bundle: a torch ``.pth`` holding
``{"model": state_dict, "epoch": int, "num_devices": int}``.

This is the shape ``tactilesr_tpu/compat/export_torch.py`` writes for the
reference's model-loading paths, with the state_dict in the reference
layout, so an exported JAX checkpoint is also a port checkpoint.  Reading
the JAX package's msgpack ``.ckpt`` files is not supported here.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint_file", "load_checkpoint_file"]


def save_checkpoint_file(path: str, state_dict: dict, epoch: int = 0) -> str:
    """Write a bundle atomically (temp file, then rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    bundle = {
        "model": {k: v.detach().cpu() for k, v in state_dict.items()},
        "epoch": int(epoch),
        "num_devices": 1,  # the port trains and serves on one device
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Read a bundle onto the CPU (tensors only; no pickled code runs).
    A JAX ``.ckpt`` must first be exported with
    ``python -m tactilesr_tpu.compat.export_torch``."""
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(bundle, dict) or "model" not in bundle:
        raise ValueError(f"{path!r} is not a checkpoint bundle (no 'model' entry)")
    return bundle

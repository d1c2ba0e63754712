"""The port's checkpoint bundle: a torch ``.pth`` holding
``{"model": state_dict, "epoch": int, "num_devices": int, ...}``.

This is the shape ``tactilesr_tpu/compat/export_torch.py`` writes for the
reference's model-loading paths, with the state_dict in the reference
layout, so an exported JAX checkpoint is also a port checkpoint.  A training
checkpoint keeps ``"model"`` the same and adds the optimizer, schedule,
metric-storage and hook states beside it, all plain containers of tensors,
numbers and strings, so every bundle loads with ``weights_only=True``.
Reading the JAX package's msgpack ``.ckpt`` files is not supported here.

``CheckpointManager`` is the directory-level part of
``tactilesr_tpu/runtime/checkpoint.py``: ``epoch_{e}.pth`` files, a
``latest.pth`` symlink and ``max_to_keep`` garbage collection.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "CheckpointManager",
    "LATEST_NAME",
    "load_checkpoint_file",
    "load_state_dict_strict_false",
    "save_checkpoint_file",
    "write_bundle",
]

logger = logging.getLogger("tactilesr_torch")

LATEST_NAME = "latest.pth"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def write_bundle(path: str, bundle: Dict[str, Any]) -> str:
    """Write a bundle atomically (temp file, then rename), tensors on the CPU."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(bundle), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint_file(path: str, state_dict: dict, epoch: int = 0, **extra) -> str:
    """Write ``{"model": state_dict, "epoch", "num_devices": 1, **extra}``."""
    return write_bundle(path, {"model": state_dict, "epoch": int(epoch), "num_devices": 1, **extra})


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Read a bundle onto the CPU (tensors only; no pickled code runs).
    A JAX ``.ckpt`` must first be exported with
    ``python -m tactilesr_tpu.compat.export_torch``."""
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(bundle, dict) or "model" not in bundle:
        raise ValueError(f"{path!r} is not a checkpoint bundle (no 'model' entry)")
    return bundle


def load_state_dict_strict_false(module: torch.nn.Module,
                                 state_dict: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Load the keys ``module`` and ``state_dict`` share; returns
    (missing, unexpected).  A key whose shape differs is skipped with a
    warning and counted as unexpected (``torch``'s own strict=False load
    raises on it; the JAX package's ``merge_pytree_strict_false`` skips)."""
    current = module.state_dict()
    missing = sorted(set(current) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(current))
    merged = dict(current)
    for k in set(current) & set(state_dict):
        if tuple(current[k].shape) != tuple(state_dict[k].shape):
            logger.warning("Shape mismatch for %s: checkpoint %s vs model %s; skipping",
                           k, tuple(state_dict[k].shape), tuple(current[k].shape))
            unexpected.append(k)
            continue
        merged[k] = state_dict[k]
    module.load_state_dict(merged, strict=True)
    return missing, sorted(unexpected)


class CheckpointManager:
    """Directory-level manager: save bundles, tag latest, GC old files."""

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        self._saved: List[str] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, file_name: str, bundle: Dict[str, Any]) -> str:
        path = osp.join(self.ckpt_dir, file_name)
        logger.info("Saving checkpoint to %s", path)
        write_bundle(path, bundle)
        latest = osp.join(self.ckpt_dir, LATEST_NAME)
        if osp.lexists(latest):
            os.remove(latest)
        os.symlink(file_name, latest)  # relative: the directory can move
        self._saved.append(file_name)
        if self.max_to_keep is not None and self.max_to_keep > 0:
            while len(self._saved) > self.max_to_keep:
                victim = osp.join(self.ckpt_dir, self._saved.pop(0))
                if osp.exists(victim):
                    os.remove(victim)
        return path

    def latest_path(self) -> Optional[str]:
        p = osp.join(self.ckpt_dir, LATEST_NAME)
        return p if osp.exists(p) else None

    def state_dict(self) -> dict:
        return {"saved": list(self._saved)}

    def load_state_dict(self, state: dict) -> None:
        self._saved = list(state.get("saved", []))

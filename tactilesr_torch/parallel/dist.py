"""Process identity for rank-0 gating of checkpoints and logs (the part of
``tactilesr_tpu/parallel/dist.py`` that one-device training needs).

Without an initialised ``torch.distributed`` process group the process is
rank 0 of a world of 1.  Data-parallel training is not ported yet.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "is_main_process", "check_single_device"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def check_single_device(spec) -> None:
    """The config's ``data_parallel`` knob.  The port trains on one device:
    ``auto`` resolves to it, as do the JAX package's off values (off,
    false, no, none, 0, 1); anything that asks for more devices raises."""
    if spec is None or spec is False or (not isinstance(spec, bool) and spec in (0, 1)):
        return
    if isinstance(spec, str) and spec.strip().lower() in ("auto", "off", "false", "no", "none", "0", "1"):
        return
    raise NotImplementedError(
        f"data_parallel={spec!r}: data-parallel training is not ported (ROADMAP A10); "
        "use auto or off, which train on one device")

"""Misc runtime utilities: environment report, seeding, matmul precision
(the port's copy of ``tactilesr_tpu/runtime/misc.py``)."""

from __future__ import annotations

import os
import platform
import random
import sys

import numpy as np
import torch

__all__ = ["collect_env", "set_random_seed", "apply_matmul_precision", "compute_dtype"]

_MATMUL_PRECISIONS = {"highest": "highest", "high": "high", "default": "high"}
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(config) -> torch.dtype:
    """The ``compute_dtype`` config key as a torch dtype (activations and
    products; parameters stay f32)."""
    name = config.get("compute_dtype", "float32")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}: expected one of {sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def apply_matmul_precision(config) -> None:
    """Apply the ``matmul_precision`` config key to torch's global flags, for
    f32 matmuls and f32 cuDNN convolutions alike (the JAX flag governs both).

    ``highest`` keeps both in full f32; ``high`` and ``default`` allow TF32
    on the card's tensor cores (the JAX package's "default" is one bf16
    MXU pass on a TPU).  Always sets both flags, so consecutive runs in one
    process cannot inherit a previous run's override.  cuDNN's flag is set
    through the legacy ``cudnn.allow_tf32`` attribute only: mixing it with
    the newer ``fp32_precision`` API makes torch's precision getters raise.
    The tPSF physics backward turns TF32 off for itself whatever this says.
    """
    prec = config.get("matmul_precision", "default") or "default"
    if prec not in _MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision={prec!r}: expected one of {sorted(_MATMUL_PRECISIONS)}")
    torch.set_float32_matmul_precision(_MATMUL_PRECISIONS[prec])
    torch.backends.cudnn.allow_tf32 = prec != "highest"


def collect_env() -> str:
    """Human-readable environment report for the training log."""
    rows = [
        ("sys.platform", sys.platform),
        ("Python", sys.version.replace("\n", "")),
        ("numpy", np.__version__),
        ("torch", torch.__version__),
        ("torch CUDA", str(torch.version.cuda)),
        ("CUDA available", str(torch.cuda.is_available())),
        ("hostname", platform.node()),
    ]
    if torch.cuda.is_available():
        rows.append(("GPU", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"))
    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


def set_random_seed(seed: int = -1, deterministic: bool = False) -> int:
    """Seed python, numpy and torch (CPU and every CUDA device) and
    PYTHONHASHSEED; returns the seed used.  ``deterministic=True`` also asks
    cuDNN for deterministic algorithms."""
    if seed < 0:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # seeds the CUDA generators too
    os.environ["PYTHONHASHSEED"] = str(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return seed

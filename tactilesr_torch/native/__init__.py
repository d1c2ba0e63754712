"""Native (C++) host preprocessing of raw tactile blobs, bound with ctypes.

The port's copy of ``tactilesr_tpu/native/``: ``preprocess.cpp`` is
compiled with ``g++ -O3 -shared -fPIC`` at first use into ``_build/``
beside this file, into a library whose name carries a hash of the source
and the flags (an edited source never loads a stale build).  Nothing is
built at import time.  This is host code, not a device kernel: where no
compiler exists, ``available()`` is False and ``data/raw_process.py`` runs
its numpy versions, which compute the same results (tests hold the two
against each other and against the JAX package's).

``calls`` counts the calls of each entry point since the last
``reset_calls``, so that a run can show the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "binarize_depth_native",
    "build_error",
    "calls",
    "extract_contact_seqs_native",
    "reset_calls",
    "resize_bilinear_native",
]

logger = logging.getLogger("tactilesr_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "preprocess.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

calls = {"resize_bilinear": 0, "binarize_depth": 0, "extract_contact_seqs": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""  # why the last build failed ("" if it did not)

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _compile() -> ctypes.CDLL:
    """Compile (if needed) and load the library; raises on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    with open(_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libtsr_preprocess_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SOURCE], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.tsr_resize_bilinear.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int,
                                        ctypes.c_int]
    lib.tsr_resize_bilinear.restype = None
    lib.tsr_binarize_depth.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p]
    lib.tsr_binarize_depth.restype = None
    lib.tsr_extract_contact_seqs.argtypes = [_f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                             _f32p]
    lib.tsr_extract_contact_seqs.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None if the build failed (the
    reason stays in ``build_error``)."""
    global _lib, _tried, build_error
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _compile()
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                build_error = str(exc)
                logger.warning("native preprocessing unavailable, numpy runs instead: %s", exc)
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native preprocessing library did not build: {build_error}")
    return lib


def resize_bilinear_native(src: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize of a 2-D map to ``out_hw`` (torch ``align_corners=False``)."""
    lib = _require()
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(out_hw, np.float32)
    lib.tsr_resize_bilinear(src, src.shape[0], src.shape[1], out, out_hw[0], out_hw[1])
    calls["resize_bilinear"] += 1
    return out


def binarize_depth_native(depth: np.ndarray, depth_pixel: int = 100) -> np.ndarray:
    """``data/raw_process.py::binarize_depth`` in C++."""
    lib = _require()
    depth = np.ascontiguousarray(depth, np.float32)
    out = np.empty((depth_pixel, depth_pixel), np.float32)
    lib.tsr_binarize_depth(depth, depth.shape[0], depth.shape[1], depth_pixel, out)
    calls["binarize_depth"] += 1
    return out


def extract_contact_seqs_native(tactile_lrs: np.ndarray, threshold_scale: float = 0.1,
                                sample_count: int = -1) -> np.ndarray:
    """``data/raw_process.py::extract_contact_seqs`` in C++."""
    lib = _require()
    lrs = np.ascontiguousarray(tactile_lrs, np.float32)
    seqs = lrs.shape[0]
    out = np.empty((seqs, 3, 4, 4), np.float32)
    n = lib.tsr_extract_contact_seqs(lrs, seqs, np.float32(threshold_scale), int(sample_count), out)
    calls["extract_contact_seqs"] += 1
    return np.ascontiguousarray(out[:n])

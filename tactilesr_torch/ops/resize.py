"""Bilinear resize with ``F.interpolate(mode="bilinear", align_corners=False)``
semantics, written as two small matmuls ``W_h @ img @ W_w^T``.

The weight matrices are the JAX package's (``tactilesr_tpu/ops/resize.py``):
torch's ``area_pixel_compute_source_index`` with the source index clamped at
0 and two taps per output pixel.  Keeping the same matrices keeps the port's
labels and model inputs bit-compatible with the reference at every size,
including downsampling, where ``F.interpolate`` and an anti-aliased resize
disagree.  Layout here is NCHW (the trailing two axes are resized).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "bilinear_resize_matrix",
    "resize_bilinear",
    "resize_bilinear_nchw",
    "upsample_bilinear",
]


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix M with (M @ x) == torch bilinear resample of x.

    src = (dst + 0.5) * (in/out) - 0.5, clamped below at 0; the two taps are
    floor(src) and min(floor(src)+1, in-1).
    """
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    w0 = 1.0 - w1
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[dst.astype(np.int64), i0] += w0
    mat[dst.astype(np.int64), i1] += w1
    mat = mat.astype(np.float32)
    mat.setflags(write=False)  # cached and shared: keep it immutable
    return mat


def bilinear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The (out, in) torch-bilinear weight matrix (read-only, cached)."""
    return _resize_matrix_np(in_size, out_size)


_DEVICE_MATRICES: dict = {}


def _matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """The matrix on ``device``, copied there once and kept: a CUDA graph
    cannot capture a host-to-device copy, and replays read the matrix at the
    address the capture saw."""
    key = (in_size, out_size, torch.device(device))
    mat = _DEVICE_MATRICES.get(key)
    if mat is None:
        mat = _DEVICE_MATRICES[key] = torch.from_numpy(_resize_matrix_np(in_size, out_size).copy()).to(device)
    return mat


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize the two trailing axes of a (..., H, W) tensor; f32 math, the
    result in ``x``'s dtype."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    wh = _matrix(h_in, h_out, x.device)
    ww = _matrix(w_in, w_out, x.device)
    y = torch.matmul(wh, x.float())  # (..., h_out, w_in)
    y = torch.matmul(y, ww.t())  # (..., h_out, w_out)
    return y.to(x.dtype)


# the port keeps NCHW throughout, so the two names are one function
resize_bilinear = resize_bilinear_nchw


def upsample_bilinear(x: torch.Tensor, scale_factor: int) -> torch.Tensor:
    """NCHW upsample by an integer factor (torch ``nn.Upsample`` parity)."""
    h, w = x.shape[-2], x.shape[-1]
    return resize_bilinear_nchw(x, (h * scale_factor, w * scale_factor))

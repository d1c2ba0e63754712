"""AdamL2 in one CUDA launch: the optimizer kernel of the captured training
step (``adam_kernel.cu``), its wrapper and its plain PyTorch version.

``adam_l2_update`` steps every tensor of a param group: parameters, their
gradients, Adam's two moments and step counters (torch's
``optimizer.state[p]`` entries ``exp_avg``, ``exp_avg_sq``, ``step``), with
the learning rate a device scalar, in torch's capturable Adam's arithmetic
with coupled L2 weight decay, in one launch of the kernel (built by
``nvcc`` at first use into a library of its own, beside the physics
kernels' one); it takes CUDA tensors only.  ``adam_l2_plain`` is the same
arithmetic in PyTorch ops, on any device, for the tests and the card's
comparisons, not a fallback.  ``launch_counts["adam_l2"]`` counts the
kernel's launches (registered with ``ops/graph.py``, so a captured step's
replays count them).

The kernel walks each tensor's storage, so each parameter, its gradient and
its moments must be dense and share one layout (a channels-last 4-D weight
is as good as a contiguous one); the wrapper raises on anything else rather
than index one of them wrongly.  ``work_list`` is the grid's cover of the
tensors, as the kernel reads it from ``chunk_starts``.
"""

from __future__ import annotations

import bisect
import ctypes
import os
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _HERE, _build_library, launch_counts
from . import kernel_info as _kernel_info

__all__ = [
    "ADAM_CHUNK", "ADAM_MAX_TENSORS", "KERNELS", "adam_l2_plain", "adam_l2_update", "build",
    "chunk_starts", "kernel_info", "work_list",
]

_SOURCE = os.path.join(_HERE, "adam_kernel.cu")
ADAM_CHUNK = 2048  # elements a block takes (adam_kernel.cu's ADAM_CHUNK)
ADAM_MAX_TENSORS = 512  # tensors one launch takes (adam_kernel.cu's ADAM_MAX_TENSORS)
# the kernel's name as the source spells it -> its name for ptxas_info / kernel_info
KERNELS = {"adam_l2_kernel": "adam_l2"}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process loaded (ptxas -v)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the optimizer kernel's library; raises on
    failure, or where the source's chunk or tensor limit is not this
    module's."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            so_path, log = _build_library(_SOURCE, prefix="libadam")
            lib = ctypes.CDLL(so_path)
            lib.adam_l2_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.adam_l2_launch.restype = ctypes.c_int
            lib.adam_l2_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.adam_l2_limits.restype = ctypes.c_int
            lib.adam_kernel_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.adam_kernel_info.restype = ctypes.c_int
            lib.adam_error_string.argtypes = [ctypes.c_int]
            lib.adam_error_string.restype = ctypes.c_char_p
            limits = (ctypes.c_int * 2)()
            lib.adam_l2_limits(limits)
            if tuple(limits) != (ADAM_MAX_TENSORS, ADAM_CHUNK):
                raise RuntimeError(f"adam_kernel.cu takes {tuple(limits)} (tensors, chunk), this "
                                   f"module {(ADAM_MAX_TENSORS, ADAM_CHUNK)}")
            _lib, build_log = lib, log
        return _lib


def kernel_info() -> dict:
    """Occupancy and resources of the kernel on the current CUDA device, as
    ``ops/cuda::kernel_info`` gives the physics kernels'."""
    return _kernel_info(build(), KERNELS, "adam")


def chunk_starts(numels: Sequence[int]) -> List[int]:
    """Prefix sums of the tensors' chunk counts (``ADAM_CHUNK`` elements a
    chunk): chunk c of the grid is chunk c - start[i] of the tensor i with
    start[i] <= c < start[i + 1]; the last entry is the grid's size."""
    starts = [0]
    for n in numels:
        starts.append(starts[-1] + -(-int(n) // ADAM_CHUNK))
    return starts


def work_list(numels: Sequence[int]) -> List[Tuple[int, int, int]]:
    """The grid's (tensor, first element, elements) for each chunk, found as
    the kernel finds them (the last tensor whose start is at most the
    chunk's index, so empty tensors take none)."""
    starts = chunk_starts(numels)
    out = []
    for c in range(starts[-1]):
        i = min(bisect.bisect_right(starts, c), len(numels)) - 1
        off = (c - starts[i]) * ADAM_CHUNK
        out.append((i, off, min(ADAM_CHUNK, int(numels[i]) - off)))
    return out


@torch.no_grad()
def adam_l2_plain(params, grads, exp_avgs, exp_avg_sqs, steps, lr: torch.Tensor, *, b1: float,
                  b2: float, eps: float, weight_decay: float) -> None:
    """The kernel's arithmetic in PyTorch ops, in place, in f32 and in its
    order (torch's capturable Adam with coupled L2): on any device, for the
    tests and the card's comparisons."""
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        if weight_decay != 0:
            g = g.add(p, alpha=weight_decay)
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        s.add_(1)
        step_size = 1 / ((torch.pow(b1, s) - 1) / lr)
        bc2 = torch.sqrt(-(torch.pow(b2, s) - 1))
        p.add_(m / v.sqrt().div_(bc2).add_(eps).div_(step_size))


def _layout(x: torch.Tensor):
    """(size, stride) of each dimension of size > 1 where ``x`` is dense and
    non-overlapping (its elements fill its storage span in some order),
    else None."""
    dims = [(st, sz) for sz, st in zip(x.shape, x.stride()) if sz != 1]
    expect = 1
    for st, sz in sorted(dims):
        if st != expect:
            return None
        expect *= sz
    return tuple((sz, st) for st, sz in dims)


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, ticket) -> None:
    dev = params[0].device
    for name, x in (("lr", lr), ("ticket", ticket)):
        if x.device != dev or x.numel() != 1 or x.dtype != (torch.float32 if name == "lr" else torch.int32):
            raise ValueError(f"{name} must be one {'f32' if name == 'lr' else 'int32'} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    for i, (p, g, m, v, s) in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs, steps)):
        for name, x in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v), ("step", s)):
            if x.device != dev or x.dtype != torch.float32 or x.is_sparse:
                raise ValueError(f"tensor {i}: {name} must be dense f32 on {dev}, got {x.dtype} "
                                 f"on {x.device}")
        if s.numel() != 1:
            raise ValueError(f"tensor {i}: step must hold one value, got {tuple(s.shape)}")
        layout = _layout(p)
        if layout is None:
            raise ValueError(f"tensor {i}: the parameter {tuple(p.shape)} with strides "
                             f"{p.stride()} is not dense")
        for name, x in (("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if x.shape != p.shape or _layout(x) != layout:
                raise ValueError(f"tensor {i}: {name} {tuple(x.shape)} with strides {x.stride()} "
                                 f"does not share the parameter's {tuple(p.shape)} / {p.stride()}")


def adam_l2_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr: torch.Tensor, *, b1: float,
                   b2: float, eps: float, weight_decay: float, ticket: torch.Tensor = None) -> None:
    """One AdamL2 step of every tensor, in place, in one kernel launch on the
    current stream, with nothing read back to the host (so the call can be
    captured): ``params`` and their ``grads``, moments ``exp_avgs`` /
    ``exp_avg_sqs`` and step counters ``steps`` (f32 scalars), at most
    ``ADAM_MAX_TENSORS`` of each, on one CUDA device, at the learning rate
    ``lr`` (an f32 scalar there).  ``ticket`` is an int32 device scalar that
    holds 0, the kernel's counter of finished blocks (a new one if None; give
    one made outside a capture, and one per stream that may run the kernel
    at the same time).  Raises on anything else."""
    lists = (params, grads, exp_avgs, exp_avg_sqs, steps)
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"{[len(x) for x in lists]} params, grads, moments and steps")
    if not params:
        return
    if len(params) > ADAM_MAX_TENSORS:
        raise ValueError(f"{len(params)} tensors: one launch takes at most {ADAM_MAX_TENSORS}")
    dev = params[0].device
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, ticket)
    if dev.type != "cuda":
        raise ValueError(f"the optimizer kernel takes CUDA tensors, got {dev} (adam_l2_plain "
                         "computes the same on any device)")
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = np.array([[t.data_ptr() for t in row] for row in zip(*lists)], dtype=np.int64)
        numels = np.array([p.numel() for p in params], dtype=np.int64)
        starts = np.array(chunk_starts(numels), dtype=np.int32)
        err = lib.adam_l2_launch(ptrs.ctypes.data, numels.ctypes.data, starts.ctypes.data,
                                 len(numels), lr.data_ptr(), ticket.data_ptr(), b1, 1 - b1, b2,
                                 1 - b2, eps, weight_decay, stream)
        if err != 0:
            raise RuntimeError(f"adam_l2 kernel launch failed: {lib.adam_error_string(err).decode()}")
        launch_counts["adam_l2"] += 1

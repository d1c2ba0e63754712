"""CUDA kernels of the port, built with ``nvcc`` at first use and bound
with ``ctypes``.

``tpsf_kernel.cu`` is compiled for ``sm_90a`` into ``_build/`` beside this
file, into a shared library whose name carries a hash of the source (so an
edited source never loads a stale build).  Nothing is built or loaded at
import time: the CPU tests import this module on machines with no ``nvcc``.

``tpsf_physics`` is the kernel's wrapper.  On a CPU tensor it runs the plain
PyTorch version (``ops/psf.py::physics_plain``); on a CUDA tensor it
launches the kernel or raises -- a failed build or launch is never replaced
by the plain version.  ``launch_counts`` counts kernel launches so that a
run can show its main path went through the kernel.

``tpsf_physics_fused`` makes the kernel trainable: a ``torch.autograd.Function``
(the port of ``tactilesr_tpu/ops/pallas/tpsf_kernel.py::get_fused``, a
``jax.custom_vjp``) whose forward is the kernel and whose backward recomputes
the physics through ``physics_plain`` in full f32 and differentiates that, as
the JAX package's ``_bwd`` does.  No backward kernel exists there either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..psf import (
    C_MASK, C_PSF, DEGRADE_SCALE, DISTURBANCE, HR_SIZE, TAXELS, f32_matmul, physics_plain,
)

__all__ = [
    "build",
    "launch_counts",
    "reset_launch_counts",
    "tpsf_physics",
    "tpsf_physics_fused",
    "TPSFPhysicsFn",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "tpsf_kernel.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset
launch_counts = {"tpsf_physics": 0, "tpsf_physics_fused": 0}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process loaded (ptxas -v)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SOURCE, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = os.path.join(BUILD_DIR, f"libtpsf_{tag}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{build_log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.tpsf_physics_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.tpsf_physics_launch.restype = ctypes.c_int
        lib.tpsf_error_string.argtypes = [ctypes.c_int]
        lib.tpsf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(depth: torch.Tensor, abm: torch.Tensor) -> None:
    if depth.ndim != 3 or tuple(depth.shape[1:]) != (HR_SIZE, HR_SIZE):
        raise ValueError(f"depth must be (B, {HR_SIZE}, {HR_SIZE}), got {tuple(depth.shape)}")
    if abm.shape != (depth.shape[0], 3):
        raise ValueError(f"abm must be (B, 3) with B={depth.shape[0]}, got {tuple(abm.shape)}")
    if abm.device != depth.device:
        raise ValueError(f"depth on {depth.device} but abm on {abm.device}")


def tpsf_physics(depth: torch.Tensor, abm: torch.Tensor):
    """depth (B,100,100), abm (B,3) -> (HR (B,100,100) f32, LR (B,4,4) f32).

    CUDA tensors go through the kernel (inputs made contiguous f32); CPU
    tensors through the plain version."""
    _check(depth, abm)
    if not depth.is_cuda:
        return physics_plain(depth, abm)
    lib = build()
    depth = depth.to(torch.float32).contiguous()
    if depth.data_ptr() % 16:  # the kernel reads depth in 128-bit words
        depth = depth.clone()
    abm = abm.to(torch.float32).contiguous()
    b = depth.shape[0]
    hr = torch.empty((b, HR_SIZE, HR_SIZE), dtype=torch.float32, device=depth.device)
    lr = torch.empty((b, TAXELS, TAXELS), dtype=torch.float32, device=depth.device)
    if b == 0:
        return hr, lr
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = lib.tpsf_physics_launch(
            depth.data_ptr(), abm.data_ptr(), hr.data_ptr(), lr.data_ptr(), b,
            C_PSF, C_MASK, DISTURBANCE, DEGRADE_SCALE, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tpsf_physics kernel launch failed: {lib.tpsf_error_string(err).decode()}"
        )
    launch_counts["tpsf_physics"] += 1
    return hr, lr


class TPSFPhysicsFn(torch.autograd.Function):
    """(depth, abm) -> (HR, LR): the kernel forward, a recompute backward.

    The backward runs ``physics_plain`` again on detached copies of the
    saved inputs and differentiates it with TF32 off, whatever the global
    matmul precision (the JAX backward is pinned to f32 HIGHEST the same
    way); the contact fixup's second max stays detached there, as JAX's
    ``stop_gradient``.  CPU tensors take ``physics_plain`` as the forward, so
    the CPU tests run this same backward.
    """

    @staticmethod
    def forward(ctx, depth, abm):
        if depth.is_cuda:
            hr, lr = tpsf_physics(depth, abm)
            if depth.shape[0]:  # tpsf_physics launches nothing for B=0
                launch_counts["tpsf_physics_fused"] += 1
        else:
            hr, lr = physics_plain(depth, abm)
        ctx.save_for_backward(depth, abm)
        ctx.set_materialize_grads(False)
        return hr, lr

    @staticmethod
    def backward(ctx, g_hr, g_lr):
        depth, abm = ctx.saved_tensors
        need_depth, need_abm = ctx.needs_input_grad
        d = depth.detach().requires_grad_(need_depth)
        a = abm.detach().requires_grad_(need_abm)
        with torch.enable_grad(), f32_matmul():
            hr, lr = physics_plain(d, a)
            outs = [(o, g) for o, g in ((hr, g_hr), (lr, g_lr)) if g is not None]
            if not outs:
                return None, None
            wanted = [x for x, n in ((d, need_depth), (a, need_abm)) if n]
            grads = torch.autograd.grad([o for o, _ in outs], wanted, [g for _, g in outs])
        g_depth = grads[0].to(depth.dtype) if need_depth else None
        g_abm = grads[-1].to(abm.dtype) if need_abm else None
        return g_depth, g_abm


def tpsf_physics_fused(depth: torch.Tensor, abm: torch.Tensor):
    """Differentiable ``tpsf_physics``: the same outputs, with gradients for
    depth and abm through the recompute backward."""
    _check(depth, abm)
    return TPSFPhysicsFn.apply(depth, abm)

"""CUDA kernels of the port, built with ``nvcc`` at first use and bound
with ``ctypes``.

``tpsf_kernel.cu`` is compiled for ``sm_90a`` into ``_build/`` beside this
file, into a shared library whose name carries a hash of the source (so an
edited source never loads a stale build).  Nothing is built or loaded at
import time: the CPU tests import this module on machines with no ``nvcc``.

``tpsf_physics`` is the forward kernels' wrapper.  ``precision`` picks the
kernel (``ops/psf.py::resolve_physics_precision``): ``highest`` the f32
kernel, ``default`` the one-pass bf16 tensor-core kernel and ``high`` its
three-pass form, the port of ``tpsf_physics_pallas_raw`` at
``precision=DEFAULT`` and ``HIGH``.  On a CPU tensor it runs the plain
PyTorch version of that precision (``ops/psf.py::physics_plain``); on a
CUDA tensor it launches the kernel or raises -- a failed build or launch
is never replaced by the plain version or by another precision's kernel.
``launch_counts`` counts kernel launches so that a run can show its main
path went through the kernel; they are registered with ``ops/graph.py``,
so a ``CapturedGraph`` that holds launches counts them at each replay, not
at the capture.

``tpsf_physics_bwd`` is the wrapper of the backward kernel in the same
source: the vector-Jacobian product of the physics in f32, recomputed from
(depth, abm) in one launch.  Its plain version is
``ops/psf.py::physics_vjp_plain``, taken for CPU tensors only.

``kernel_info`` reports each kernel's occupancy and resources as the CUDA
runtime sees them, and ``ptxas_info`` the registers, spills and static
shared memory that ptxas printed when it compiled them.

``tpsf_physics_fused`` makes the kernels trainable: a ``torch.autograd.Function``
(the port of ``tactilesr_tpu/ops/pallas/tpsf_kernel.py::get_fused``, a
``jax.custom_vjp``) whose forward is the forward kernel of the chosen
precision and whose backward is the f32 backward kernel at every
precision.  The JAX package's ``_bwd`` differentiates an XLA recompute at
f32 HIGHEST, whatever the forward's precision, inside one jitted program;
eager PyTorch would issue a hundred small ops for that, so here it is one
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from ..graph import register_counters
from ..psf import (
    C_MASK, C_PSF, DEGRADE_SCALE, DISTURBANCE, HR_SIZE, TAXELS, f32_matmul, physics_plain,
    physics_vjp_plain, resolve_physics_precision,
)

__all__ = [
    "build",
    "kernel_info",
    "launch_counts",
    "ptxas_info",
    "reset_launch_counts",
    "tpsf_physics",
    "tpsf_physics_bwd",
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

# kernel name -> launches since the last reset ("tpsf_physics_fused": the
# autograd wrapper's forward launches, of any precision)
launch_counts = {"tpsf_physics": 0, "tpsf_physics_fused": 0, "tpsf_physics_bwd": 0,
                 "tpsf_physics_bf16": 0, "tpsf_physics_bf16x3": 0}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process loaded (ptxas -v)

# kernel names as the C++ source spells them -> their launch-count names, in
# the order of tpsf_kernel_info's ``which``
KERNELS = {"tpsf_physics_kernel": "tpsf_physics", "tpsf_physics_bwd_kernel": "tpsf_physics_bwd",
           "tpsf_physics_bf16_kernel": "tpsf_physics_bf16",
           "tpsf_physics_bf16x3_kernel": "tpsf_physics_bf16x3"}

# physics_precision -> (launch-count name, bf16 passes; 0 for the f32 kernel)
FORWARD_KERNELS = {"highest": ("tpsf_physics", 0), "default": ("tpsf_physics_bf16", 1),
                   "high": ("tpsf_physics_bf16x3", 3)}


register_counters(launch_counts)


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


def _compile(defines: tuple = ()) -> tuple:
    """Compile (if needed) and load the kernel library built with the
    preprocessor ``defines``: (library, nvcc's output).  Raises on failure."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libtpsf_{tag}.so")
    log_path = so_path[:-3] + ".log"
    if os.path.exists(so_path) and os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, _SOURCE], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{log}")
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.tpsf_physics_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.tpsf_physics_launch.restype = ctypes.c_int
    lib.tpsf_physics_bf16_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.tpsf_physics_bf16_launch.restype = ctypes.c_int
    lib.tpsf_physics_bwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.tpsf_physics_bwd_launch.restype = ctypes.c_int
    lib.tpsf_kernel_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.tpsf_kernel_info.restype = ctypes.c_int
    lib.tpsf_error_string.argtypes = [ctypes.c_int]
    lib.tpsf_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            _lib, build_log = _compile()
        return _lib


def kernel_info() -> dict:
    """Per kernel (by launch-count name), on the current CUDA device:
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at the launch's threads and dynamic shared memory), threads per block,
    dynamic and static shared bytes, registers and local (spill) bytes per
    thread.  Builds the library if needed; raises on a CUDA error."""
    lib = build()
    info = {}
    for which, name in enumerate(KERNELS.values()):
        out = (ctypes.c_int * 6)()
        err = lib.tpsf_kernel_info(which, out)
        if err != 0:
            raise RuntimeError(f"tpsf_kernel_info({name}) failed: {lib.tpsf_error_string(err).decode()}")
        info[name] = dict(zip(("blocks_per_sm", "threads", "dynamic_smem", "static_smem",
                               "registers", "local_bytes"), out))
    return info


def ptxas_info(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel from
    the ``-Xptxas -v`` lines in ``log`` (``build_log``), by launch-count
    name; a kernel ptxas did not report is missing."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = next((v for k, v in KERNELS.items() if re.search(rf"\d{k}E", m.group(1))), None)
            continue
        if name is None:
            continue
        entry = info.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem"] = int(m.group(1)) if m else 0
    return info


def _check(depth: torch.Tensor, abm: torch.Tensor) -> None:
    if depth.ndim != 3 or tuple(depth.shape[1:]) != (HR_SIZE, HR_SIZE):
        raise ValueError(f"depth must be (B, {HR_SIZE}, {HR_SIZE}), got {tuple(depth.shape)}")
    if abm.shape != (depth.shape[0], 3):
        raise ValueError(f"abm must be (B, 3) with B={depth.shape[0]}, got {tuple(abm.shape)}")
    if abm.device != depth.device:
        raise ValueError(f"depth on {depth.device} but abm on {abm.device}")


def _f32_aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous f32 whose data is 16-byte aligned: the kernels read these
    tensors in 128-bit words."""
    x = x.to(torch.float32).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def tpsf_physics(depth: torch.Tensor, abm: torch.Tensor, precision="highest"):
    """depth (B,100,100), abm (B,3) -> (HR (B,100,100) f32, LR (B,4,4) f32),
    the products at ``precision`` (highest, high or default).

    CUDA tensors go through that precision's kernel (inputs made contiguous
    f32); CPU tensors through the plain version of the same precision."""
    _check(depth, abm)
    precision = resolve_physics_precision(precision)
    if not depth.is_cuda:
        return physics_plain(depth, abm, precision)
    name, passes = FORWARD_KERNELS[precision]
    lib = build()
    depth = _f32_aligned(depth)
    abm = abm.to(torch.float32).contiguous()
    b = depth.shape[0]
    hr = torch.empty((b, HR_SIZE, HR_SIZE), dtype=torch.float32, device=depth.device)
    lr = torch.empty((b, TAXELS, TAXELS), dtype=torch.float32, device=depth.device)
    if b == 0:
        return hr, lr
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        ptrs = (depth.data_ptr(), abm.data_ptr(), hr.data_ptr(), lr.data_ptr(), b)
        consts = (C_PSF, C_MASK, DISTURBANCE, DEGRADE_SCALE, stream)
        if passes:
            err = lib.tpsf_physics_bf16_launch(*ptrs, passes, *consts)
        else:
            err = lib.tpsf_physics_launch(*ptrs, *consts)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.tpsf_error_string(err).decode()}"
        )
    launch_counts[name] += 1
    return hr, lr


def tpsf_physics_bwd(depth: torch.Tensor, abm: torch.Tensor, g_hr, g_lr,
                     need_depth: bool = True, need_abm: bool = True):
    """The physics' vector-Jacobian product: depth (B,100,100), abm (B,3) and
    the cotangents g_hr (B,100,100) and g_lr (B,4,4), either may be None ->
    (g_depth (B,100,100) f32 or None, g_abm (B,3) f32 or None), each only
    when asked for.

    CUDA tensors go through the backward kernel, which recomputes the
    forward from (depth, abm); CPU tensors through the plain version
    ``physics_vjp_plain`` with TF32 off."""
    _check(depth, abm)
    b = depth.shape[0]
    for name, g, shape in (("g_hr", g_hr, (b, HR_SIZE, HR_SIZE)), ("g_lr", g_lr, (b, TAXELS, TAXELS))):
        if g is not None and (tuple(g.shape) != shape or g.device != depth.device):
            raise ValueError(f"{name} must be {shape} on {depth.device}, got "
                             f"{tuple(g.shape)} on {g.device}")
    if not depth.is_cuda:
        with f32_matmul():
            return physics_vjp_plain(depth, abm, g_hr, g_lr, need_depth, need_abm)
    lib = build()
    depth = _f32_aligned(depth)
    abm = abm.to(torch.float32).contiguous()
    g_lr = None if g_lr is None else g_lr.to(torch.float32).contiguous()
    g_hr = None if g_hr is None else _f32_aligned(g_hr)
    g_abm = torch.empty((b, 3), dtype=torch.float32, device=depth.device) if need_abm else None
    g_depth = torch.empty_like(depth) if need_depth else None
    if b == 0:
        return g_depth, g_abm

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = lib.tpsf_physics_bwd_launch(
            depth.data_ptr(), abm.data_ptr(), ptr(g_lr), ptr(g_hr), ptr(g_abm), ptr(g_depth), b,
            C_PSF, C_MASK, DISTURBANCE, DEGRADE_SCALE, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tpsf_physics_bwd kernel launch failed: {lib.tpsf_error_string(err).decode()}"
        )
    launch_counts["tpsf_physics_bwd"] += 1
    return g_depth, g_abm


class TPSFPhysicsFn(torch.autograd.Function):
    """(depth, abm, precision) -> (HR, LR): the forward kernel of that
    precision, the f32 backward kernel.

    The backward recomputes the physics from the saved (depth, abm) and
    never reads the forward's outputs, in f32 whatever the forward's
    precision or the global matmul precision (JAX's ``_bwd`` is pinned to
    f32 HIGHEST the same way), so for a given cotangent the gradient is the
    same at every precision; the contact fixup's second max passes no
    gradient, as JAX's ``stop_gradient``.  CPU tensors take
    ``physics_plain`` as the forward and ``physics_vjp_plain`` as the
    backward.
    """

    @staticmethod
    def forward(ctx, depth, abm, precision="highest"):
        hr, lr = tpsf_physics(depth, abm, precision)
        if depth.is_cuda and depth.shape[0]:  # tpsf_physics launches nothing for B=0
            launch_counts["tpsf_physics_fused"] += 1
        ctx.save_for_backward(depth, abm)
        ctx.set_materialize_grads(False)
        return hr, lr

    @staticmethod
    def backward(ctx, g_hr, g_lr):
        if g_hr is None and g_lr is None:
            return None, None, None
        depth, abm = ctx.saved_tensors
        need_depth, need_abm = ctx.needs_input_grad[:2]
        g_depth, g_abm = tpsf_physics_bwd(depth, abm, g_hr, g_lr, need_depth, need_abm)
        return (None if g_depth is None else g_depth.to(depth.dtype),
                None if g_abm is None else g_abm.to(abm.dtype), None)


def tpsf_physics_fused(depth: torch.Tensor, abm: torch.Tensor, precision="highest"):
    """Differentiable ``tpsf_physics``: the same outputs at ``precision``,
    with gradients for depth and abm through the f32 backward kernel."""
    _check(depth, abm)
    return TPSFPhysicsFn.apply(depth, abm, precision)

"""Device selection and burn-in utilities.

Entry points default to ``"cuda"``; a CUDA request on a machine with no
usable GPU raises instead of quietly running on the CPU (a CPU run would
be a different, much slower program).  Tests pass ``device="cpu"``.

``device_ops`` picks a torch.profiler trace's device kernels.

``parse_device_memory``, ``select_device_with_most_free_memory`` and
``test_device`` are the port of ``tactilesr_tpu/runtime/device.py`` (itself
the reference's ``utility/tools.py`` GPU tools: a memory scan that picks
the freest GPU, and a timed compute burn-in), reading the CUDA runtime
through ``torch.cuda`` instead of ``nvidia-smi``.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

__all__ = [
    "device_ops",
    "parse_device_memory",
    "resolve_device",
    "select_device_with_most_free_memory",
    "test_device",
]

BURN_IN_N = 4096  # the burn-in's square bf16 matmul, as the JAX package's


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path explicitly"
        )
    return dev


def device_ops(prof):
    """The device-side entries of a torch.profiler trace's ``key_averages``
    (GPU-side user annotations, e.g. "Optimizer.step#Adam.step", span the
    kernels inside them: counting them would count those kernels twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def parse_device_memory() -> List[dict]:
    """One entry per CUDA device: ``index``, ``name``, ``total_memory``,
    ``used_memory`` and ``free_memory`` in bytes (``torch.cuda.mem_get_info``,
    so memory other processes hold counts as used).  ``[]`` without a GPU."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "index": i,
            "name": torch.cuda.get_device_name(i),
            "total_memory": int(total),
            "used_memory": int(total - free),
            "free_memory": int(free),
        })
    return out


def select_device_with_most_free_memory() -> Tuple[int, torch.device, str, int]:
    """(index, device, name, free bytes) of the CUDA device with the most
    free memory; raises as ``resolve_device`` does without a GPU."""
    resolve_device("cuda")
    best = max(parse_device_memory(), key=lambda d: d["free_memory"])
    return best["index"], torch.device("cuda", best["index"]), best["name"], best["free_memory"]


def test_device(device="cuda", test_time: float = 5.0, test_memory_gb: float = 1.0) -> float:
    """Timed bf16 ``BURN_IN_N`` x ``BURN_IN_N`` matmul burn-in on one device;
    returns the achieved TFLOP/s.  ``test_memory_gb`` is the GiB of
    operands held on the device while it runs (at least one matrix).

    On CUDA the matmuls are timed with CUDA events around batches of 8;
    on the CPU (``device="cpu"``) with the host clock."""
    dev = resolve_device(device)
    n = BURN_IN_N
    count = max(1, int(test_memory_gb * 2**30 // (2 * n * n)))
    mats = [torch.ones((n, n), dtype=torch.bfloat16, device=dev) for _ in range(count)]
    out = torch.empty((n, n), dtype=torch.bfloat16, device=dev)
    torch.matmul(mats[0], mats[0], out=out)  # warm
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    iters = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < test_time:
        for k in range(8):
            a = mats[(iters + k) % count]
            torch.matmul(a, a, out=out)
        iters += 8
        if cuda:  # keep the host within a batch of the device
            torch.cuda.synchronize(dev)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    tflops = 2 * n**3 * iters / seconds / 1e12
    print(f"burn-in on {dev}: {iters} matmuls of {n}x{n} bf16 in {seconds:.2f} s "
          f"-> {tflops:.1f} TFLOP/s")
    return tflops

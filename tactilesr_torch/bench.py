"""The physics kernels' timer on one NVIDIA GPU, and the port's work
counts and bounds.

    python -m tactilesr_torch.bench [--batch 1024] [--precision highest|high|default]

times the physics kernel of ``--precision`` through its wrapper
``ops/cuda::tpsf_physics`` against ``physics_plain`` at the same precision
(TF32 off), 3 rounds of 40 calls each in turns (CUDA events), on JAX's
bench inputs, and prints exactly one JSON line on stdout (keys ``metric``,
``value``, ``unit``, ``vs_baseline``, ``device`` with the card's
``nvidia-smi`` name and power limit, and ``extras``, which give the
kernel's share of its bound); diagnostics go to stderr.  ``vs_baseline``
is kernel over plain samples/s on this card.  The run fails if the
kernel's launch count did not rise (a wrapper that ran the plain path),
and on a machine without a card.

The network's throughput is the benchmark's, not this module's:
``python3 perfbench/run.py --workload <cell>``.  The FLOP counts
(``sr_flops_per_frame``, ``cnn_flops_per_frame``), the H100's peaks and
the physics kernels' bounds (``tpsf_bound_ms`` and siblings) live here;
``chip_smoke.py`` and the tests import them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from .runtime.device import resolve_device

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores (no tensor cores)
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores
PEAK_HBM_BPS = 3.35e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


# ------------------------------------------------------------- work counts
def sr_flops_per_frame(scale=10, seqs=1, pattern_layers=6, force_layers=1):
    """Forward conv FLOPs of one frame of TactileSR (2 x MACs; the resizes,
    BN and activations left out): every conv runs at (4 x scale)^2."""
    px = (4 * scale) ** 2

    def conv(cin, cout, k):
        return 2 * cin * cout * k * k * px

    branch = conv(3, 64, 3) + conv(64, 64, 3)
    msrb = conv(64, 64, 3) + conv(64, 64, 5) + conv(128, 128, 3) + conv(128, 128, 5) + conv(256, 64, 1)
    force = conv(3, 64, 3) + force_layers * 2 * conv(64, 64, 3)
    head = conv(128, 128, 3) + conv(128, 1, 3)
    parts = {"pattern branches": seqs * branch, "inputContact": conv(64 * seqs, 64, 3),
             "MSRBs": pattern_layers * msrb, "force branch": force, "head": head}
    return sum(parts.values()), parts


def cnn_flops_per_frame(scale=10, msrb_cnt=6):
    """Forward conv FLOPs of one TactileSRCNN frame (2 x MACs), at (4 x
    scale)^2 pixels."""
    px = (4 * scale) ** 2

    def conv(cin, cout, k):
        return 2 * cin * cout * k * k * px

    msrb = conv(64, 64, 3) + conv(64, 64, 5) + conv(128, 128, 3) + conv(128, 128, 5) + conv(256, 64, 1)
    return conv(3, 64, 3) + 2 * conv(64, 64, 3) + msrb_cnt * msrb + conv(64, 1, 3)


_BAND = sum(min(99, i + 49) - max(0, i - 49) + 1 for i in range(100))  # 7,450 taps of A(beta)
_DEGRADE = 2 * (4 * 100 * 100 + 4 * 4 * 100)  # U.HR.U^T


def _bound(flops, nbytes, peak):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tpsf_bound_ms(b):
    """Least time for B samples: f32 FMA work over the f32 peak vs bytes
    (depth and abm in, HR and LR out, once each) over HBM bandwidth."""
    flops = 2 * 2 * _BAND * 100 + _DEGRADE  # A.D.A^T + U.HR.U^T
    return _bound(b * flops, b * 4 * (100 * 100 + 3 + 100 * 100 + 16), PEAK_F32_FLOPS)


def tpsf_bf16_bound_ms(b, passes):
    """Least time for B samples of a bf16 kernel: the banded products and
    the degradation (``tpsf_bound_ms``'s count) ``passes`` times over the
    bf16 dense peak, against the same bytes as the f32 kernel's."""
    flops = passes * (2 * 2 * _BAND * 100 + _DEGRADE)
    return _bound(b * flops, b * 4 * (100 * 100 + 3 + 100 * 100 + 16), PEAK_BF16_FLOPS)


def fused_bound_ms(b):
    """Least time for the function the wrapper computes, forward and abm
    gradient, at B samples.  Operations: the banded forward once (the
    kernel's count), the three banded products of the abm backward with
    P = A D, M = P A^T (dP = dM A, and dA = dM^T P + dP D^T over the band
    only), and the degradation's backward (to HR, and to m through U H and
    U H^T) at twice its forward; elementwise work is left out.  Over the
    f32 peak, against depth and abm in, HR and LR out, the LR cotangent in
    and the abm gradient out, once each, over HBM bandwidth."""
    flops = (2 * 2 * _BAND * 100 + _DEGRADE) + 3 * 2 * _BAND * 100 + 2 * _DEGRADE
    return _bound(b * flops, b * 4 * (100 * 100 + 3 + 100 * 100 + 16 + 16 + 3), PEAK_F32_FLOPS)


def tpsf_bwd_bound_ms(b):
    """Least time for the backward kernel's function as training calls it
    (LR cotangent, abm gradient) at B samples: the forward's two banded
    products (recomputed from the inputs), the three banded products of the
    abm backward (Q = G0 A and the two correlations with the band of
    dL/dA) and the degradation's backward at twice its forward, over the
    f32 peak, against depth, abm and the LR cotangent in and the abm
    gradient out, once each, over HBM bandwidth."""
    flops = 5 * 2 * _BAND * 100 + 2 * _DEGRADE
    return _bound(b * flops, b * 4 * (100 * 100 + 3 + 16 + 3), PEAK_F32_FLOPS)


# ------------------------------------------------------------ physics
def tpsf_inputs(batch: int, dev: torch.device):
    """The JAX bench's physics inputs: depth U(0, 3), abm columns
    U(0.5, 2.5), U(1, 4), U(1, 5), seed 0."""
    rng = np.random.default_rng(0)
    depth = (rng.random((batch, 100, 100)) * 3).astype(np.float32)
    abm = np.stack([rng.random(batch).astype(np.float32) * 2 + 0.5,
                    rng.random(batch).astype(np.float32) * 3 + 1.0,
                    rng.random(batch).astype(np.float32) * 4 + 1.0], axis=1)
    return torch.from_numpy(depth).to(dev), torch.from_numpy(abm).to(dev)


def require_launch(name: str, fn) -> None:
    """Call ``fn`` once; raise unless kernel ``name``'s launch count rose
    (a wrapper that ran the plain path)."""
    from .ops.cuda import launch_counts

    before = launch_counts[name]
    fn()
    if launch_counts[name] <= before:
        raise RuntimeError(f"{name} was not launched: the wrapper ran its plain version")


def _events_ms(fn, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def bench_tpsf(batch: int = 1024, precision: str = "highest", device="cuda", rounds: int = 3,
               calls: int = 40) -> dict:
    from .ops import cuda as tcuda
    from .ops.psf import f32_matmul, physics_plain, resolve_physics_precision

    precision = resolve_physics_precision(precision)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the bench times the CUDA physics kernels against their plain version: "
                           "it needs the card (the CPU has no kernel to time)")
    name, passes = tcuda.FORWARD_KERNELS[precision]
    depth, abm = tpsf_inputs(batch, dev)

    def kernel():
        return tcuda.tpsf_physics(depth, abm, precision)

    def plain():
        with f32_matmul():
            return physics_plain(depth, abm, precision)

    launches0 = tcuda.launch_counts[name]
    require_launch(name, kernel)
    plain()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for _ in range(rounds):  # in turns: plain, kernel
        ms["plain"].append(_events_ms(plain, calls))
        ms["kernel"].append(_events_ms(kernel, calls))
    k_ms, p_ms = statistics.median(ms["kernel"]), statistics.median(ms["plain"])
    bound, by = tpsf_bound_ms(batch) if passes == 0 else tpsf_bf16_bound_ms(batch, passes)
    log(f"{name} B={batch}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {
        "metric": "tpsf_physics_throughput",
        "value": batch / k_ms * 1e3,
        "unit": "samples/sec",
        "vs_baseline": p_ms / k_ms,
        "device": {"type": "cuda", "name": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line()},
        "extras": {
            "kernel": name,
            "plain_samples_per_sec": batch / p_ms * 1e3,
            "batch": batch,
            "precision": precision,
            "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "kernel_ms_rounds": ms["kernel"],
            "plain_ms_rounds": ms["plain"],
            "bound_ms": bound,
            "bound_by": by,
            "bound_share": bound / k_ms,
            "launches": tcuda.launch_counts[name] - launches0,
            "note": ("vs_baseline is kernel / plain samples/s on this card (physics_plain at the same "
                     "precision, TF32 off); medians of rounds in turns, CUDA events"),
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.bench",
                                description="The tPSF physics kernel against its plain version on one "
                                            "NVIDIA GPU (one JSON line)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--precision", default="highest", choices=("highest", "high", "default"),
                   help="physics precision: the kernel timed")
    p.add_argument("--tile", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.tile is not None:
        p.error("--tile is the Pallas kernel's batch tile; the CUDA kernels have none (one block per sample)")
    from .runtime.logger import setup_logger

    setup_logger("tactilesr_torch", stream=sys.stderr)  # stdout carries the JSON line
    print(json.dumps(bench_tpsf(args.batch, args.precision, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

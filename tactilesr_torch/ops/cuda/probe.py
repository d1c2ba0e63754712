"""Where the time of the tPSF physics kernels goes, phase by phase, on the GPU.

    python -m tactilesr_torch.ops.cuda.probe [--batches 256 8192]

Builds ``tpsf_kernel.cu`` twice more.  With ``-DTPSF_PROBE`` lane 0 of every
warp stamps ``clock64()`` at the end of each phase (most phases end at block
barriers), and the block's SM (``%smid``) and ``%globaltimer`` at its start
and end.  With ``-DTPSF_PROBE_NO_BAND`` the band loops run no step, so that
build's time is that of everything else in the kernel.

For each kernel and batch it prints the three builds' times (CUDA events;
plain against probe is the probe's cost); the mean and median cycles of each
phase over the blocks' warps, how far apart the warps end it, and its share
of the block; the mean block time and the SM clock the two clocks imply;
how many blocks were in flight on average (summed block time over the
kernel's span) against how many fit; and how far apart blocks start on one
SM, as a share of the block time.  The backward runs as training calls it
(LR cotangent, abm gradient).
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..psf import C_MASK, C_PSF, DEGRADE_SCALE, DISTURBANCE
from . import _compile, _f32_aligned, kernel_info, tpsf_physics, tpsf_physics_bwd

PROBE_SLOTS = 16  # tpsf_kernel.cu: PROBE_SLOTS, for each warp of a block
WARPS = 8  # tpsf_kernel.cu: THREADS / 32
PHASES = {
    "tpsf_physics": [
        "depth bulk copy, gpad and U", "max and mask bits", "pass 1: T = A D, T^T stored",
        "pass 2: HR0, second max", "fixup, sum(HR)", "HR bulk store, V = U HR", "LR",
    ],
    "tpsf_physics_bwd": [
        "depth bulk copy, gpad, U, gl", "max, mask bits, GU", "pass 1: T = A D, T^T stored",
        "pass 2: HR0, second max, HR^T", "V and W", "G0^T, dalpha, dm",
        "h2 correlation, pass Q^T", "Q stored, depth copied again", "h1 correlation, dbeta",
    ],
}


def _inputs(b, dev, seed=0):
    """Rectangular contact maps with noise, abm = 0.5 + |N(0, 1)|."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.randint(10, 45, (b, 2), generator=g)
    hi = torch.randint(55, 95, (b, 2), generator=g)
    idx = torch.arange(100)
    rows = (idx >= lo[:, :1]) & (idx < hi[:, :1])
    cols = (idx >= lo[:, 1:]) & (idx < hi[:, 1:])
    depth = (rows[:, :, None] & cols[:, None, :]).float() + 0.05 * torch.randn(b, 100, 100, generator=g)
    abm = 0.5 + torch.randn(b, 3, generator=g).abs()
    return depth.to(dev), abm.to(dev), torch.randn(b, 4, 4, generator=g).to(dev)


def _events_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe(batches=(256, 8192)):
    dev = torch.device("cuda")
    lib, _ = _compile(("TPSF_PROBE",))
    no_band, _ = _compile(("TPSF_PROBE_NO_BAND",))
    lib.tpsf_set_probe.argtypes = [ctypes.c_void_p]
    lib.tpsf_set_probe.restype = ctypes.c_int
    info = kernel_info()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {}
    for b in batches:
        depth, abm, g_lr = _inputs(b, dev, seed=b)
        depth = _f32_aligned(depth)
        hr, lr = torch.empty_like(depth), torch.empty(b, 4, 4, device=dev)
        g_abm = torch.empty(b, 3, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        consts = (C_PSF, C_MASK, DISTURBANCE, DEGRADE_SCALE, stream)
        def fwd(lb):
            return lambda: lb.tpsf_physics_launch(depth.data_ptr(), abm.data_ptr(), hr.data_ptr(),
                                                  lr.data_ptr(), b, *consts)

        def bwd(lb):
            return lambda: lb.tpsf_physics_bwd_launch(depth.data_ptr(), abm.data_ptr(), g_lr.data_ptr(),
                                                      None, g_abm.data_ptr(), None, b, *consts)

        launches = {
            "tpsf_physics": (fwd(lib), lambda: tpsf_physics(depth, abm), fwd(no_band)),
            "tpsf_physics_bwd": (bwd(lib), lambda: tpsf_physics_bwd(depth, abm, None, g_lr, need_depth=False),
                                 bwd(no_band)),
        }
        iters = 200 if b <= 256 else 20
        for name, (probed, plain, rest) in launches.items():
            stamps = torch.zeros(b, WARPS, PROBE_SLOTS, dtype=torch.int64, device=dev)
            err = lib.tpsf_set_probe(None)
            plain_ms = _events_ms(plain, iters)
            probe_ms = _events_ms(probed, iters)
            rest_ms = _events_ms(rest, iters)
            err = err or lib.tpsf_set_probe(stamps.data_ptr())
            err = err or probed()
            torch.cuda.synchronize()
            err = err or lib.tpsf_set_probe(None)
            if err:
                raise RuntimeError(f"probe of {name} failed: {lib.tpsf_error_string(err).decode()}")
            s = stamps.cpu().double()  # (block, warp, slot)
            n = len(PHASES[name])
            per_warp = s[:, :, 1:n + 1] - s[:, :, :n]
            cycles = per_warp.mean((0, 1))
            median = per_warp.flatten(0, 1).median(0).values
            spread = (s[:, :, 1:n + 1].amax(1) - s[:, :, 1:n + 1].amin(1)).mean(0)
            block_cycles = float((s[:, 0, n] - s[:, 0, 0]).mean())
            sm, t0, t1 = s[:, 0, PROBE_SLOTS - 3], s[:, 0, PROBE_SLOTS - 2], s[:, 0, PROBE_SLOTS - 1]
            block_ns = float((t1 - t0).mean())
            span_ns = float(t1.max() - t0.min())
            # how far apart blocks start on one SM, over the block time
            gaps = torch.cat([t0[sm == k].sort().values.diff() for k in sm.unique()])
            gap_share = float(gaps.median()) / block_ns if len(gaps) else float("nan")
            fit = info[name]["blocks_per_sm"] * n_sm
            print(f"{name} B={b}: plain build {plain_ms:.4f} ms, probe build {probe_ms:.4f} ms, "
                  f"without the band loops {rest_ms:.4f} ms (so the band loops take about "
                  f"{plain_ms - rest_ms:.4f} ms); "
                  f"block {block_ns / 1e3:.2f} us = {block_cycles:.0f} cycles "
                  f"(SM clock {block_cycles / block_ns:.3f} GHz); in flight "
                  f"{float((t1 - t0).sum()) / span_ns:.1f} blocks of {fit} that fit, over "
                  f"{span_ns / 1e3:.1f} us; blocks start on an SM a median {gap_share:.3f} of a "
                  "block apart", flush=True)
            print(f"    {'phase (cycles: mean, median; spread of its end over the warps)':<48}", flush=True)
            for phase, c, med, spr in zip(PHASES[name], cycles.tolist(), median.tolist(), spread.tolist()):
                print(f"    {phase:<32} {c:8.0f} {med:8.0f} {spr:8.0f} {c / block_cycles * 100:5.1f}%",
                      flush=True)
            report[(name, b)] = dict(plain_ms=plain_ms, probe_ms=probe_ms, rest_ms=rest_ms, block_ns=block_ns,
                                     start_gap_share=gap_share,
                                     block_cycles=block_cycles, span_ns=span_ns,
                                     phases=dict(zip(PHASES[name], cycles.tolist())))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[256, 8192])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs an NVIDIA GPU")
    probe(tuple(args.batches))


if __name__ == "__main__":
    main()

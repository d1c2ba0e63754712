"""Where the time of the tPSF physics kernels goes, phase by phase, on the GPU.

    python -m tactilesr_torch.ops.cuda.probe [--batches 256 8192] [--baseline PATH]

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
(LR cotangent, abm gradient).  The bf16 forward kernels (``precision``
default and high) have no band loops on the CUDA cores; in their third
build the two tensor-core products run no step instead.

``--baseline PATH`` names another version of ``tpsf_kernel.cu`` (an earlier
commit's, unpacked into a directory that git ignores).  It is built too,
plain and with ``-DTPSF_PROBE``; for each bf16 kernel (one pass and three)
the two versions are then timed in turns (baseline, this, this, baseline;
CUDA events) at each batch, and the baseline's phase table, registers and
blocks per SM are printed beside this version's.  A baseline kernel is read
with this body's phases or, where it stamps one phase more, with those of
the first bf16 design (``BASELINE_BF16_PHASES``).  Last, the one-pass
kernel's HR and LR from both versions are compared bit for bit at B = 5,
256 and 8192.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..psf import C_MASK, C_PSF, DEGRADE_SCALE, DISTURBANCE
from . import _compile, _f32_aligned, build, kernel_info, tpsf_physics, tpsf_physics_bwd

PROBE_SLOTS = 16  # tpsf_kernel.cu: PROBE_SLOTS, for each warp of a block
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
# both bf16 kernels run one body (tpsf_physics_bf16_tiled<PLANES>)
PHASES["tpsf_physics_bf16"] = PHASES["tpsf_physics_bf16x3"] = [
    "depth bulk copy, gpad, U, A tiles", "max, mask bits, D in bf16", "product 1: T = A D, T stored",
    "product 2: HR0, mask bits, 1 reduction", "HR stored, V = U HR (mma)", "LR",
]
# the first bf16 design, which an earlier source's kernels may have
BASELINE_BF16_PHASES = [
    "depth bulk copy, gpad, U, A in bf16", "max, mask bits, D in bf16", "product 1: T = A D",
    "product 2: HR0, second max", "fixup, sum(HR)", "HR bulk store, V = U HR", "LR",
]
# a bf16 kernel's phases by the number of stamps it writes (one more than phases)
BF16_PHASES_BY_STAMPS = {len(p) + 1: p for p in (PHASES["tpsf_physics_bf16"], BASELINE_BF16_PHASES)}
BF16_PASSES = {"tpsf_physics_bf16": 1, "tpsf_physics_bf16x3": 3}
BF16_BYTES = 4 * (100 * 100 + 3 + 100 * 100 + 16)  # a sample's depth and abm in, HR and LR out
PEAK_HBM_BPS = 3.35e12  # H100 SXM


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


def _phase_table(label, phases, lib, probed, plain, rest, iters, b, k_info, n_sm):
    """Times ``plain`` and ``probed`` (and ``rest``), then runs ``probed``
    once with the stamps on and prints the phase table; returns its numbers.
    ``phases`` is the list of phase names, or a dict of such lists by the
    number of stamps a warp writes.  ``k_info`` is the kernel's
    ``kernel_info`` entry (its warps and blocks per SM)."""
    dev = torch.device("cuda")
    fit = k_info["blocks_per_sm"] * n_sm
    stamps = torch.zeros(b, k_info["threads"] // 32, PROBE_SLOTS, dtype=torch.int64, device=dev)
    err = lib.tpsf_set_probe(None)
    plain_ms = _events_ms(plain, iters)
    probe_ms = _events_ms(probed, iters)
    rest_ms = None if rest is None else _events_ms(rest, iters)
    err = err or lib.tpsf_set_probe(stamps.data_ptr())
    err = err or probed()
    torch.cuda.synchronize()
    err = err or lib.tpsf_set_probe(None)
    if err:
        raise RuntimeError(f"probe of {label} failed: {lib.tpsf_error_string(err).decode()}")
    s = stamps.cpu().double()  # (block, warp, slot)
    if isinstance(phases, dict):
        phases = phases[int((s[0, 0, :PROBE_SLOTS - 3] != 0).sum())]
    n = len(phases)
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
    loops = "products" if "bf16" in label else "band loops"
    rest_txt = ("" if rest_ms is None else f"without the {loops} {rest_ms:.4f} ms (so the "
                f"{loops} take about {plain_ms - rest_ms:.4f} ms); ")
    print(f"{label} B={b}: plain build {plain_ms:.4f} ms, probe build {probe_ms:.4f} ms, {rest_txt}"
          f"block {block_ns / 1e3:.2f} us = {block_cycles:.0f} cycles "
          f"(SM clock {block_cycles / block_ns:.3f} GHz); in flight "
          f"{float((t1 - t0).sum()) / span_ns:.1f} blocks of {fit} that fit, over "
          f"{span_ns / 1e3:.1f} us; blocks start on an SM a median {gap_share:.3f} of a "
          "block apart", flush=True)
    print(f"    {'phase (cycles: mean, median; spread of its end over the warps)':<48}", flush=True)
    for phase, c, med, spr in zip(phases, cycles.tolist(), median.tolist(), spread.tolist()):
        print(f"    {phase:<40} {c:8.0f} {med:8.0f} {spr:8.0f} {c / block_cycles * 100:5.1f}%",
              flush=True)
    return dict(plain_ms=plain_ms, probe_ms=probe_ms, rest_ms=rest_ms, block_ns=block_ns,
                start_gap_share=gap_share, block_cycles=block_cycles, span_ns=span_ns,
                phases=dict(zip(phases, cycles.tolist())))


def probe(batches=(256, 8192), baseline=None):
    dev = torch.device("cuda")
    lib, _ = _compile(("TPSF_PROBE",))
    no_band, _ = _compile(("TPSF_PROBE_NO_BAND",))
    libs = [lib]
    if baseline:
        base, _ = _compile((), source=baseline)
        base_probe, _ = _compile(("TPSF_PROBE",), source=baseline)
        libs.append(base_probe)
        base_info = kernel_info(base)
    for lb in libs:
        lb.tpsf_set_probe.argtypes = [ctypes.c_void_p]
        lb.tpsf_set_probe.restype = ctypes.c_int
    info = kernel_info()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if baseline:
        for name in BF16_PASSES:
            for label, k in (("this version", info[name]), ("baseline", base_info[name])):
                print(f"{name}, {label}: {k['registers']} registers, {k['blocks_per_sm']} blocks "
                      f"per SM, {k['dynamic_smem']} B of dynamic shared memory, {k['local_bytes']} B "
                      "local", flush=True)
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

        def bf16(lb, passes):
            return lambda: lb.tpsf_physics_bf16_launch(depth.data_ptr(), abm.data_ptr(), hr.data_ptr(),
                                                       lr.data_ptr(), b, passes, *consts)

        def bwd(lb):
            return lambda: lb.tpsf_physics_bwd_launch(depth.data_ptr(), abm.data_ptr(), g_lr.data_ptr(),
                                                      None, g_abm.data_ptr(), None, b, *consts)

        launches = {
            "tpsf_physics": (fwd(lib), lambda: tpsf_physics(depth, abm), fwd(no_band)),
            "tpsf_physics_bwd": (bwd(lib), lambda: tpsf_physics_bwd(depth, abm, None, g_lr, need_depth=False),
                                 bwd(no_band)),
            "tpsf_physics_bf16": (bf16(lib, 1), lambda: tpsf_physics(depth, abm, "default"), bf16(no_band, 1)),
            "tpsf_physics_bf16x3": (bf16(lib, 3), lambda: tpsf_physics(depth, abm, "high"), bf16(no_band, 3)),
        }
        iters = 200 if b <= 256 else 20
        for name, (probed, plain, rest) in launches.items():
            report[(name, b)] = _phase_table(name, PHASES[name], lib, probed, plain, rest, iters, b,
                                             info[name], n_sm)
        if baseline:
            for name, passes in BF16_PASSES.items():
                ours, theirs = bf16(build(), passes), bf16(base, passes)
                turns = [_events_ms(fn, iters) for fn in (theirs, ours, ours, theirs)]
                bound = b * BF16_BYTES / PEAK_HBM_BPS * 1e3
                print(f"A/B {name} B={b} (baseline, this, this, baseline): "
                      + ", ".join(f"{t:.4f}" for t in turns)
                      + f" ms; byte bound {bound:.4f} ms: this {bound / min(turns[1:3]) * 100:.1f}%, "
                      f"baseline {bound / min(turns[0], turns[3]) * 100:.1f}% of it", flush=True)
                report[(f"{name} A/B", b)] = dict(turns_ms=turns, bound_ms=bound)
                report[(f"{name} baseline", b)] = _phase_table(
                    f"{name} (baseline)", BF16_PHASES_BY_STAMPS, base_probe, bf16(base_probe, passes),
                    theirs, None, iters, b, base_info[name], n_sm)
    if baseline:
        report["tpsf_physics_bf16 bitwise"] = _same_bits(build(), base, (5, 256, 8192))
    return report


def _same_bits(lib, base, batches):
    """Whether the one-pass kernel of ``lib`` and of ``base`` give the same
    HR and LR bits at each of ``batches``; prints each answer."""
    dev = torch.device("cuda")
    same = {}
    for b in batches:
        depth, abm, _ = _inputs(b, dev, seed=7 + b)
        depth = _f32_aligned(depth)
        outs = []
        for lb in (lib, base):
            hr, lr = torch.empty_like(depth), torch.empty(b, 4, 4, device=dev)
            err = lb.tpsf_physics_bf16_launch(depth.data_ptr(), abm.data_ptr(), hr.data_ptr(), lr.data_ptr(),
                                              b, 1, C_PSF, C_MASK, DISTURBANCE, DEGRADE_SCALE,
                                              torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"tpsf_physics_bf16 B={b}: {lb.tpsf_error_string(err).decode()}")
            outs.append((hr, lr))
        torch.cuda.synchronize()
        same[b] = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
        print(f"tpsf_physics_bf16 B={b}: this version's HR and LR "
              f"{'equal' if same[b] else 'differ from'} the baseline's bit for bit", flush=True)
    return same
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[256, 8192])
    ap.add_argument("--baseline", default=None,
                    help="another version of tpsf_kernel.cu to time and probe beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs an NVIDIA GPU")
    probe(tuple(args.batches), args.baseline)


if __name__ == "__main__":
    main()

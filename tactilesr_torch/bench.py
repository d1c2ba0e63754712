"""Benchmark of the port on one NVIDIA GPU: the counterpart of the root
``bench.py`` (which stays the JAX package's).

    python -m tactilesr_torch.bench                    # STSR serving forward
    python -m tactilesr_torch.bench --seqs 7           # MTSR serving forward
    python -m tactilesr_torch.bench --train            # captured STSR train step
    python -m tactilesr_torch.bench --tpsf [--batch 1024] [--precision highest|high|default]

Add ``--device cpu`` for a rehearsal on the CPU (its numbers are host
numbers: no ``mfu``, no device time).  Prints exactly one JSON line on
stdout (keys ``metric``, ``value``, ``unit``, ``extras`` and, for the
network runs, ``mfu``, with the card's ``nvidia-smi`` name and power
limit beside them); diagnostics go to stderr.

The default run folds a seeded full-width STSR (scale 10, 6 MSRB, 1
ResBlock, bf16) with ``fold_inference_params(branch_mode="auto")`` and
times ``tactile_sr_infer``: the best of 3 rounds of 12 pipelined calls
(host clock to a final synchronize) at batches 2048, 4096 and 8192;
then the median of 20 synchronized calls at B = 1, 8 and 64, and the
card's busy time per call there (torch.profiler: the kernels' own device
times summed, ``device_profile``).  Its extras carry the MTSR (S=7)
forward at 4096 (8 calls, 2 rounds) and ``--train``'s samples/s at
B=256.  ``mfu`` is the original graph's conv FLOPs per frame
(``sr_flops_per_frame``: the merged 3x3-in-5x5 kernels' zero taps of the
fused graph are not counted) times frames/s over the H100's dense bf16
peak (989 TFLOP/s at 700 W; the card's power limit stands beside it).

``--train`` builds the port's ``SRTrainer`` with ``scan_epochs=True``
(each step after the warm-up one replay of a captured CUDA graph) on
seeded arrays of 24 steps, runs one warm and one timed epoch at B = 32 and
256, and reports the best samples/s; its ``mfu`` counts a step as three
forwards.  ``--tpsf`` times the physics kernel of ``--precision`` through
its wrapper ``ops/cuda::tpsf_physics`` against ``physics_plain`` at the
same precision (TF32 off), 3 rounds of 40 calls each in turns (CUDA
events); ``vs_baseline`` is kernel over plain samples/s on this card, and
the extras give the kernel's share of its bound.  The run fails if the
kernel's launch count did not rise (a wrapper that ran the plain path).

The bound helpers (``tpsf_bound_ms`` and siblings), the FLOP counts and
``device_profile`` live here; ``chip_smoke.py`` imports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .runtime.device import resolve_device

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores (no tensor cores)
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores
PEAK_HBM_BPS = 3.35e12

# the flagship network (tactileSR_config's widths), and the JAX bench's batches
FLAGSHIP = dict(scale_factor=10, pattern_layers=6, force_layers=1)
THROUGHPUT_BATCHES = {1: (2048, 4096, 8192), 7: (2048, 4096)}
LATENCY_BATCHES = (1, 8, 64)
MTSR_SEQS, MTSR_BATCH = 7, 4096
TRAIN_BATCHES = (32, 256)
TRAIN_EXTRA_BATCH = 256

HOST_LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx|"
                         r"cudaGraphLaunch|cudaMemcpyAsync|cudaMemsetAsync)")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Rounds and calls of each measurement; the defaults are the JAX
    bench's (``chip_smoke.py`` runs a cut plan)."""

    rounds: int = 3
    iters: int = 12
    latency_calls: int = 20
    profile_calls: int = 20
    mtsr_rounds: int = 2
    mtsr_iters: int = 8
    train_steps: int = 24
    tpsf_rounds: int = 3
    tpsf_calls: int = 40


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def require_device(device="cuda") -> torch.device:
    """``resolve_device``, its error saying what to do."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(f"the benchmark measures a CUDA device ({e}); for a rehearsal on the "
                           "CPU pass --device cpu (host numbers, not device ones)") from e


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu", "nvidia_smi": "not measured"}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line()}


# ------------------------------------------------------------- work counts
def sr_flops_per_frame(scale=10, seqs=1, pattern_layers=6, force_layers=1, hw=None):
    """Forward conv FLOPs of one frame of TactileSR (2 x MACs; the resizes,
    BN and activations left out): every conv runs at (4 x scale)^2."""
    px = (hw or 4 * scale) ** 2

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


# ------------------------------------------------------------ profiling
def device_ops(prof):
    """The device-side entries of a torch.profiler trace's ``key_averages``
    (GPU-side user annotations, e.g. "Optimizer.step#Adam.step", span the
    kernels inside them: counting them would count those kernels twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_profile(fn, n=5):
    """One torch.profiler trace of ``n`` calls: the device's busy ms per call
    (the kernels' and copies' own device times summed; None when the trace
    holds no device time), device ops per call, the five largest, and the
    host's launch calls per call (kernel launches, copies, memsets and
    graph launches: a replayed CUDA graph is one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = device_ops(prof)
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU and HOST_LAUNCH.match(e.key))
    return dict(busy_ms=busy if busy > 0 else None,
                kernels=sum(e.count for e in dev) / n,
                host_launches=launches / n,
                top=[(e.key[:60], round(e.self_device_time_total / 1e3 / n, 4)) for e in top])


def op_table(fn, n, dev: torch.device):
    """A torch.profiler trace of ``n`` calls of ``fn`` as a table: (op, ms
    per call, calls per call) by descending time, and the total ms per
    call.  On CUDA the device ops' own device times; on the CPU the host
    ops' self times (a rehearsal: no device time exists there)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    fn()
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        _sync(dev)
    if cuda:
        rows = [(e.key, e.self_device_time_total, e.count) for e in device_ops(prof)]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
    rows = sorted(((k, us / 1e3 / n, c / n) for k, us, c in rows if us > 0), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


# ------------------------------------------------------------ serving
def flagship_model(seqs: int = 1, dtype=torch.float32):
    """A seeded TactileSR at ``FLAGSHIP`` widths for ``seqs`` frames
    (``torch.Generator().manual_seed(0)``), computing in ``dtype``."""
    from .models.tactile_sr import TactileSR

    w = FLAGSHIP
    return TactileSR(scale_factor=w["scale_factor"], seqs_cnt=seqs, axis_cnt=3,
                     pattern_feature_extra_layer_cnt=w["pattern_layers"],
                     force_feature_extra_layer_cnt=w["force_layers"], dtype=dtype,
                     generator=torch.Generator().manual_seed(0))


def build_forward(seqs: int, dev: torch.device, branch_mode: str = "auto"):
    """The fused bf16 serving forward of ``flagship_model(seqs)``; returns
    (forward, input channels)."""
    from .models.inference import fold_inference_params, tactile_sr_infer

    w = FLAGSHIP
    model = flagship_model(seqs, torch.bfloat16)
    t0 = time.perf_counter()
    folded = fold_inference_params(model.state_dict(), seqs_cnt=seqs, pattern_layers=w["pattern_layers"],
                                   force_layers=w["force_layers"], dtype=torch.bfloat16, device=dev,
                                   branch_mode=branch_mode)
    log(f"init+fold (seqs={seqs}): {time.perf_counter() - t0:.1f} s")

    def forward(x):
        return tactile_sr_infer(folded, x, scale_factor=w["scale_factor"], seqs_cnt=seqs,
                                pattern_layers=w["pattern_layers"], force_layers=w["force_layers"],
                                branch_mode=branch_mode)

    return forward, 3 * seqs


def pipelined_fps(forward, x, dev, iters: int, rounds: int) -> float:
    """Best-of-``rounds`` frames/s of ``iters`` calls enqueued back to back,
    host clock to a final synchronize (one warm call first)."""
    batch = x.shape[0]
    forward(x)
    _sync(dev)
    fps = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            forward(x)
        _sync(dev)
        dt = time.perf_counter() - t0
        fps = max(fps, batch * iters / dt)
        log(f"batch {batch}: {batch * iters / dt:,.0f} frames/s ({dt / iters * 1e3:.2f} ms/call)")
    return fps


def _inputs(batch, chans, dev, rng):
    return torch.from_numpy(rng.random((batch, chans, 4, 4)).astype(np.float32)).to(dev)


def bench_serving(seqs: int = 1, device="cuda", plan: Plan = Plan()) -> dict:
    """The default run (``seqs`` 1) or ``--seqs N``: the record printed."""
    dev = require_device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    forward, chans = build_forward(seqs, dev)
    w = FLAGSHIP
    per_frame = sr_flops_per_frame(w["scale_factor"], seqs, w["pattern_layers"], w["force_layers"])[0]

    by_batch = {}
    for batch in THROUGHPUT_BATCHES.get(seqs, THROUGHPUT_BATCHES[7]):
        x = _inputs(batch, chans, dev, rng)
        by_batch[batch] = pipelined_fps(forward, x, dev, plan.iters, plan.rounds)
        del x
    best_batch = max(by_batch, key=by_batch.get)
    best_fps = by_batch[best_batch]

    latency_ms, device_ms = {}, {}
    for batch in LATENCY_BATCHES:
        x = _inputs(batch, chans, dev, rng)
        forward(x)
        _sync(dev)
        ts = []
        for _ in range(plan.latency_calls):
            t0 = time.perf_counter()
            forward(x)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        latency_ms[f"B{batch}"] = statistics.median(ts) * 1e3
        busy = device_profile(lambda: forward(x), plan.profile_calls)["busy_ms"] if cuda else None
        device_ms[f"B{batch}"] = busy if busy is not None else "not measured"
        log(f"latency B={batch}: median {latency_ms[f'B{batch}']:.3f} ms, device {device_ms[f'B{batch}']}")
    log(f"best: batch {best_batch} -> {best_fps:,.0f} frames/s")

    more = {}
    if seqs == 1:
        fwd7, chans7 = build_forward(MTSR_SEQS, dev)
        x7 = _inputs(MTSR_BATCH, chans7, dev, rng)
        more["mtsr_frames_per_sec"] = pipelined_fps(fwd7, x7, dev, plan.mtsr_iters, plan.mtsr_rounds)
        del x7, fwd7
        train = train_sps(TRAIN_EXTRA_BATCH, dev, plan.train_steps)
        more["train_samples_per_sec"] = train["samples_per_sec"]
        more["train_step_ms"] = train["step_ms"]
    return {
        "metric": "sr_inference_throughput" if seqs == 1 else f"mtsr_seqs{seqs}_inference_throughput",
        "value": best_fps,
        "unit": "frames/sec",
        "mfu": per_frame * best_fps / PEAK_BF16_FLOPS if cuda else None,
        "device": device_line(dev),
        "extras": {
            "batch": best_batch,
            "frames_per_sec_by_batch": by_batch,
            "gflop_per_frame": per_frame / 1e9,
            **more,
            "latency": {"end_to_end_ms_median": latency_ms, "device_ms_per_call": device_ms},
            "timing": (f"frames/s: best of {plan.rounds} rounds of {plan.iters} calls enqueued back to "
                       "back, host clock to a synchronize; latency: median of "
                       f"{plan.latency_calls} synchronized calls; device ms: the kernels' own times "
                       f"summed over {plan.profile_calls} calls (torch.profiler)"),
            "note": ("fused bf16 serving forward (BN folded, MSRB 3x3 and 5x5 merged, concat inputs "
                     f"split; branch layout auto), seeded weights; mfu: {per_frame / 1e9:.3f} GFLOP "
                     "of the original graph's convs per frame over the 989 TFLOP/s dense bf16 peak"),
        },
    }


# ------------------------------------------------------------ training
def captured_trainer(batch: int, dev: torch.device, work_dir: str, steps: int = 24):
    """The full-width STSR ``SRTrainer(scan_epochs=True)`` on ``steps``
    steps of seeded arrays (LR (n,3,4,4) U(0,4), HR (n,1,100,100) U(0,50)),
    after one warm epoch: on CUDA its eager warm-up steps and the capture,
    so each later step is one replay of the captured graph."""
    from .config import tactileSR_config
    from .runtime.optim import adam_l2
    from .runtime.schedule import LRWarmupSchedule, StepLR
    from .tasks.sr_task import SRTrainer, build_model

    rng = np.random.default_rng(0)
    cfg = dict(tactileSR_config, train_batch_size=batch, warmup_t=0,
               scale_factor=FLAGSHIP["scale_factor"],
               patternFeatureExtraLayerCnt=FLAGSHIP["pattern_layers"],
               forceFeatureExtraLayerCnt=FLAGSHIP["force_layers"])
    n = batch * steps
    lr = (rng.random((n, 3, 4, 4)) * 4).astype(np.float32)
    hr = (rng.random((n, 1, 100, 100)) * 50).astype(np.float32)
    model = build_model(cfg)
    tr = SRTrainer(
        config=cfg, model=model,
        optimizer=adam_l2(model.parameters(), weight_decay=1e-2),
        lr_schedule=LRWarmupSchedule(StepLR(1e-3, 2, 0.8), by_epoch=True, epoch_len=steps),
        train_arrays={"LR": lr, "HR": hr}, batch_size=batch, max_epochs=2,
        work_dir=work_dir, scan_epochs=True, device=dev,
    )
    if dev.type == "cuda":
        tr.optimizer.make_capturable()
        torch.cuda.reset_peak_memory_stats(dev)
    tr.model.train()
    tr.train_one_epoch_scan()
    return tr


def train_sps(batch: int, dev: torch.device, steps: int = 24) -> dict:
    """Samples/s of the STSR train step (forward, backward, Adam, BN
    update) at ``batch``: ``captured_trainer``'s second epoch, timed on the
    host clock (the epoch ends with its loss fetch)."""
    with tempfile.TemporaryDirectory(prefix="bench_train_") as work:
        tr = captured_trainer(batch, dev, work, steps)
        tr.cur_iter = tr.epoch_len
        t0 = time.perf_counter()
        tr.train_one_epoch_scan()
        dt = (time.perf_counter() - t0) / tr.epoch_len
        bn = [m for m in tr.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        counts = {int(m.num_batches_tracked) for m in bn}
        if counts != {2 * steps} or not all(
                torch.isfinite(m.running_mean).all() and torch.isfinite(m.running_var).all() for m in bn):
            raise RuntimeError(f"BN statistics after 2 epochs of {steps} steps: counters {counts}, "
                               "or a non-finite running statistic")
        out = {"batch": batch, "step_ms": dt * 1e3, "samples_per_sec": batch / dt,
               "captured": tr._graph is not None}
        if dev.type == "cuda":
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"train B={batch}: {dt * 1e3:.2f} ms/step -> {batch / dt:,.0f} samples/s "
        f"({'captured' if out['captured'] else 'uncaptured'}; {out.get('peak_memory_gb', 'n/a')} GB peak)")
    return out


def bench_train(device="cuda", plan: Plan = Plan()) -> dict:
    dev = require_device(device)
    runs = {b: train_sps(b, dev, plan.train_steps) for b in TRAIN_BATCHES}
    best = max(runs.values(), key=lambda r: r["samples_per_sec"])
    per_frame = sr_flops_per_frame(FLAGSHIP["scale_factor"], 1, FLAGSHIP["pattern_layers"],
                                   FLAGSHIP["force_layers"])[0]
    cuda = dev.type == "cuda"
    return {
        "metric": "sr_train_throughput",
        "value": best["samples_per_sec"],
        "unit": "samples/sec",
        "mfu": 3 * per_frame * best["samples_per_sec"] / PEAK_BF16_FLOPS if cuda else None,
        "device": device_line(dev),
        "extras": {
            "batch": best["batch"],
            "by_batch": runs,
            "timing": (f"one warm epoch, then one timed epoch of {plan.train_steps} steps, host clock "
                       "(SRTrainer scan_epochs: each step a replay of one captured CUDA graph)"),
            "note": ("full-width STSR (scale 10, 6 MSRB, bf16) train step: forward, backward, Adam-L2, "
                     "BN update; mfu counts a step as three forwards' conv FLOPs over the 989 "
                     "TFLOP/s dense bf16 peak"),
        },
    }


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


def bench_tpsf(batch: int = 1024, precision: str = "highest", device="cuda", plan: Plan = Plan()) -> dict:
    from .ops import cuda as tcuda
    from .ops.psf import f32_matmul, physics_plain, resolve_physics_precision

    precision = resolve_physics_precision(precision)
    dev = require_device(device)
    if dev.type != "cuda":
        raise RuntimeError("--tpsf times the CUDA physics kernels against their plain version: "
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
    for _ in range(plan.tpsf_rounds):  # in turns: plain, kernel
        ms["plain"].append(_events_ms(plain, plan.tpsf_calls))
        ms["kernel"].append(_events_ms(kernel, plan.tpsf_calls))
    k_ms, p_ms = statistics.median(ms["kernel"]), statistics.median(ms["plain"])
    bound, by = tpsf_bound_ms(batch) if passes == 0 else tpsf_bf16_bound_ms(batch, passes)
    log(f"{name} B={batch}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {
        "metric": "tpsf_physics_throughput",
        "value": batch / k_ms * 1e3,
        "unit": "samples/sec",
        "vs_baseline": p_ms / k_ms,
        "device": device_line(dev),
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


def main(argv=None, plan: Plan = Plan()) -> int:
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.bench",
                                description="Benchmark of the port on one NVIDIA GPU (one JSON line)")
    p.add_argument("--seqs", type=int, default=1, help="frames per sample of the served network")
    p.add_argument("--train", action="store_true", help="the captured STSR train step")
    p.add_argument("--tpsf", action="store_true", help="the tPSF physics kernel against its plain version")
    p.add_argument("--batch", type=int, default=1024, help="--tpsf batch")
    p.add_argument("--precision", default="highest", choices=("highest", "high", "default"),
                   help="--tpsf physics precision")
    p.add_argument("--tile", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.tile is not None:
        p.error("--tile is the Pallas kernel's batch tile; the CUDA kernels have none (one block per sample)")
    from .runtime.logger import setup_logger

    setup_logger("tactilesr_torch", stream=sys.stderr)  # before any trainer: stdout carries the JSON line
    if args.train:
        record = bench_train(args.device, plan)
    elif args.tpsf:
        record = bench_tpsf(args.batch, args.precision, args.device, plan)
    else:
        record = bench_serving(args.seqs, args.device, plan)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

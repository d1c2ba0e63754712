"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--keep-checkpoints DIR]

Phases (any failure exits non-zero and prints no result line):

1. build      -- compile tactilesr_torch/ops/cuda/tpsf_kernel.cu with nvcc;
                 print each kernel's registers, spill bytes, static and
                 dynamic shared memory and resident blocks per SM; the
                 backward must fit 2 blocks per SM, both bf16 forwards 3,
                 and no kernel spill
2. kernel     -- the tPSF physics kernel vs its plain PyTorch version at
                 B in {1, 5, 128, 256, 8192} (TF32 off for the plain version;
                 HR rtol/atol 1e-4, LR rtol 1e-4 / atol 1e-6); the backward
                 kernel vs its plain version ``physics_vjp_plain`` at the same
                 B, with LR and HR cotangents, for abm and depth (rtol 1e-3,
                 atol 1e-6), and with the LR cotangent alone for abm (the
                 training call)
   kernel_precision -- the bf16 forward kernels (``physics_precision``
                 default: one tensor-core pass; high: three) vs the plain
                 version of their precision at the same B, within 1e-3 of the
                 largest |HR| and |LR|, bitwise repeatable; their deviation
                 from the f32 kernel (default within JAX's 1e-2 of max|LR|)
3. training   -- ``generate synthetic`` (3 blobs of 81 taps), then stage 1
                 through its entry (``tasks/tpsf_task.py``) at the recipe's
                 defaults for 2 epochs (7,296 samples, batch 256, bf16 MLP),
                 the last epoch timed on the host clock (samples/s);
                 both forward wrappers' counts must rise by at least the step
                 count and the backward kernel must launch once per step,
                 every loss and the eval metric must be finite, every
                 parameter must move, ``latest.pth`` must exist, the
                 alpha/beta curves must be finite; then the wrapper's
                 gradients (kernel forward, kernel backward) vs autograd
                 through the plain physics at B=256 (rtol 1e-3, atol 1e-6)
   training_captured -- the same recipe with ``--scan_epochs true``: each
                 step after the warm-up a replay of one CUDA graph that holds
                 both physics kernels; the backward kernel must count one
                 launch per step (58) and each forward wrapper at least one;
                 losses against an eager run with capturable Adam at rtol
                 1e-4 (one arithmetic), and against the eager run at rtol
                 4e-3 (its host-side Adam rounds otherwise: 1.36e-3
                 measured)
   training_precision -- the recipe with ``--physics_precision default``,
                 one eager and one captured epoch: the bf16 kernel at least
                 once per step (once per replay), the f32 backward exactly
                 once per step, the f32 forward never; losses finite
4. generation -- ``generate single --sample-cnt 32 --batch 256`` from the
                 checkpoint that training wrote (2,688 train, 384 validation
                 and 384 test samples); the kernel must launch 11 + 2 + 2
                 times and the outputs must be finite and match the plain
                 physics
5. sr         -- STSR through its entry (``tasks/sr_task.py``) at the
                 recipe's defaults (scale 10, 6 MSRB, batch 32, bf16, warmup
                 2000 in auto mode) for 2 epochs (168 steps) on those
                 labels: every loss and eval metric finite, every parameter
                 and BN running statistic moved, every num_batches_tracked
                 equal to the step count; then 2 SRTrainer steps of the
                 full-width f32 STSR at batch 8 on the card and on the CPU
                 (``matmul_precision: highest`` through the recipes'
                 ``apply_matmul_precision``), held against each other
   data_parallel -- 2 gloo ranks on cuda:0 (this script with
                 ``--dp-rank``, started with the ``TACTILESR_*`` variables;
                 NCCL refuses two ranks on one card) through the STSR entry
                 at full width, B=32 (16 rows a rank): 4 f32 steps
                 (``matmul_precision: highest``, cuDNN deterministic)
                 against the same steps in one process (losses rtol 1e-4,
                 state by ``_state_deviation``: BN statistics at atol 1e-5
                 after step 1, at ``_pre_bn_bias_stats_atol`` after step 4;
                 replicas equal bit for bit);
                 ``--scan_epochs true`` refused under gloo (its collectives
                 cannot be captured); a bf16 epoch of 10 steps at the
                 recipe's defaults and a
                 resume of one more (replicas' model and Adam state equal);
                 one tPSF epoch at B=256 (128 rows a rank): in each rank
                 both forward wrappers at least once a step and the
                 backward kernel exactly once a step.  Then a one-rank NCCL
                 group: the f32 STSR at B=32 with ``scan_epochs`` over an
                 explicit one-rank mesh, its all_reduce issued inside the
                 capture and never from the host at a replay, losses equal
                 to the mesh-free captured run's at rtol 1e-6 (a one-rank
                 NCCL sum launches no kernel: ``graft_entry --ranks N`` on N
                 cards holds the replayed collective); then
                 ``SRPredictor`` over [cuda:0, cuda:0] at bucket 1024
                 against one device (f32, TF32 off, rtol 1e-4).  Step times
                 of the gloo ranks and the NCCL replay are printed
   sr_captured -- 5 f32 steps of that STSR at batch 8, captured (the
                 recipes' 3 eager warm-up steps, the capture, 2 replays)
                 against eager with capturable Adam (losses rtol 1e-4,
                 state by ``_state_deviation``) and against the eager loop
                 (losses rtol 1e-4);
                 then the STSR recipe with ``--scan_epochs true`` for 2
                 epochs, with the sr phase's checks
   remat      -- 4 f32 steps with ``remat`` against without, eager and
                 captured (3 warm-up steps, then a replay): BN statistics and
                 counters equal, losses rtol 1e-5
   cnn        -- TactileSRCNN through the STSR entry (``--model_arch
                 TactileSRCNN --scan_epochs true``, full width, bf16) for one
                 epoch, then served by ``SRPredictor(model_arch=...)`` against
                 its own f32 eval forward
   profiler   -- ``ProfilerHook`` over 3 iterations of an eager STSR run: the
                 trace names the CUDA kernels
6. seqs       -- ``generate seqs --sample-cnt 32 --n-contacts 3
                 --n-translations 9`` (864 rows) through the kernel, its test
                 split against the plain physics; one epoch of the full-width
                 MTSR (seqsCnt 7, 21 steps at batch 32) through
                 ``tasks/sr_seqs_task.py``, warm-started from the STSR
                 checkpoint with its trunk bit for bit
   generation_precision -- ``generate single --physics-precision default``
                 (15 bf16 launches, none of the f32 kernel; labels within
                 1e-2 of the f32 labels, the test split within 1e-3 of the
                 plain bf16 physics), ``--use-pallas false`` (no launch, the
                 f32 labels) and ``generate seqs --physics-precision high``
                 (5 three-pass launches; HR within 1e-4 of f32)
   generation_breakdown -- ``generate single`` split into model load, raw
                 load and preprocessing (native C++, then numpy), physics
                 and file writes (host clock); the native path must run
7. serving    -- both trained checkpoints served by SRPredictor (bf16,
                 fused) against their own f32 eval forward; a seeded
                 full-width STSR (perturbed BN stats) served for three
                 requests; fused f32 vs unfused f32; hot swap and refusal
   server     -- the trained STSR behind the HTTP server
                 (``tactilesr_torch/server.py``, the CLI's defaults, a
                 loopback port): 32 concurrent clients x 8 requests of 1-64
                 test rows, each response within the serving_trained rule of
                 the f32 eval forward; JSON rows equal npz rows; /reload 200,
                 then 409 for a 5-MSRB bundle with the old weights serving;
                 429 with Retry-After past a small queue bound, 413 for a
                 request larger than it; frames/s over HTTP, frames per
                 dispatch and p50/p99 latency printed
   serving_mtsr -- a seeded full-width MTSR (S=7, non-zero outputs) in each
                 branch layout (per_seq, dense, grouped, mixed): f32 vs the
                 unfused f32 eval forward, bf16 within 5% of the range;
                 ``auto`` serves ``grouped`` at every bucket; each layout's
                 bf16 forward at buckets 1-1024 (CUDA events: the table that
                 chose ``grouped`` for ``auto``); ``export_program`` of a
                 seeded STSR at bucket 256, bf16 and f32, reloaded and held
                 against the forward
8. times      -- forward and backward kernel and plain times at B=256 and
                 B=8192 (CUDA events), and each kernel's share of its bound;
                 the train step at B=256 split into the
                 physics forward, its kernel backward, the optimizer and the
                 whole step (CUDA events) and the card's busy time in them
                 (torch.profiler; the backward must issue at most 3 device
                 ops); SRPredictor frames/s at bucket 1024; the STSR and MTSR
                 train steps at batch 32 (CUDA events), their device ops,
                 busy time and largest ops (torch.profiler) and model FLOPs
                 utilisation against the bf16 dense peak, and the eval call;
                 then (captured_times) the captured STSR, stage-1 and
                 TactileSRCNN steps (replays, CUDA events) beside the eager
                 ones: ms, device ops, host launch calls, busy share, MFU
                 (the stage-1 step at ``physics_precision`` default too);
                 both bf16 kernels at B=256 and 8192 beside the f32 one,
                 their plain versions and their bounds (bytes, or bf16
                 tensor-core operations)

9. device     -- the memory scan, the freest device and the bf16 matmul
                 burn-in (``runtime/device.py``): TFLOP/s in (0, 105% of
                 the 989 TFLOP/s dense peak]
   bench      -- ``python -m tactilesr_torch.bench --batch 8192`` at each
                 precision, cut to ``BENCH_ROUNDS`` x ``BENCH_CALLS``: keys,
                 the share of the bound in (0, 1.05), and exactly its
                 precision's kernel launched (the launches of that path in
                 the kernel record)
   interchange -- the trained STSR ``.pth`` -> JAX ``.ckpt`` -> ``.pth``
                 (``compat/torch_convert.py``, ``compat/export_torch.py``),
                 bit-equal, and the three files served to the same output
   graft_entry -- ``graft_entry.entry()`` on the card: the flagship bf16
                 forward against the same weights in f32 (``BF16_REL``)

``--keep-checkpoints DIR`` also writes the trained STSR's and CNN's weights
and the STSR test split's LR rows to DIR (off by default).

Each phase prints its seconds.  The second-to-last line is the per-kernel JSON record, the line before it
the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import io
import json
import os
import re
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tactilesr_torch import bench, graft_entry  # noqa: E402
from tactilesr_torch.bench import (  # noqa: E402
    PEAK_BF16_FLOPS,
    cnn_flops_per_frame,
    fused_bound_ms,
    nvidia_smi_line,
    sr_flops_per_frame,
    tpsf_bf16_bound_ms,
    tpsf_bound_ms,
    tpsf_bwd_bound_ms,
)
from tactilesr_torch.config import tactileSeqs_config, tactileSR_config, tPSFNet_config  # noqa: E402
from tactilesr_torch.data import generate  # noqa: E402
from tactilesr_torch.data.datasets import SingleTapSeqsDataset  # noqa: E402
from tactilesr_torch.models.inference import (  # noqa: E402
    BRANCH_MODES,
    fold_inference_params,
    tactile_sr_infer,
)
from tactilesr_torch.models.tactile_sr import TactileSR, TactileSRCNN  # noqa: E402
from tactilesr_torch.models.tpsf_net import TPSFNet  # noqa: E402
from tactilesr_torch.ops import cuda as tcuda  # noqa: E402
from tactilesr_torch.ops.psf import f32_matmul, physics_plain, physics_vjp_plain  # noqa: E402
from tactilesr_torch.compat.export_torch import export_checkpoint_file  # noqa: E402
from tactilesr_torch.compat.torch_convert import convert_checkpoint_file  # noqa: E402
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file, save_checkpoint_file  # noqa: E402
from tactilesr_torch.runtime.device import (  # noqa: E402
    device_ops,
    parse_device_memory,
    select_device_with_most_free_memory,
)
from tactilesr_torch.runtime.device import test_device as burn_in  # noqa: E402
from tactilesr_torch.runtime.hooks import HookBase, ProfilerHook  # noqa: E402
from tactilesr_torch.runtime.misc import apply_matmul_precision  # noqa: E402
from tactilesr_torch.serving import (  # noqa: E402
    DEFAULT_BUCKETS,
    SRPredictor,
    export_program,
)
from tactilesr_torch.runtime.optim import adam_l2  # noqa: E402
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR  # noqa: E402
from tactilesr_torch.runtime.trainer import SCAN_WARMUP_STEPS  # noqa: E402
from tactilesr_torch.server import create_server  # noqa: E402
from tactilesr_torch.tasks import sr_seqs_task, sr_task, tpsf_task  # noqa: E402

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)
KERNEL_BATCHES = (1, 5, 128, 256, 8192)  # 128: a data_parallel rank's rows
MAIN_BATCH = 256  # generate single --batch 256 and the recipe's train batch
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_pallas_kernels.py:45
TRAIN_EPOCHS = 2
# bf16 serving vs the f32 eval forward: bf16 keeps 8 significant bits, and
# rounding compounds through ~25 conv layers (about 2% of the output range
# measured on the CPU); allow 5% of the output range
BF16_REL = 5e-2
# fused f32 vs unfused f32: same function, other conv order/algorithms
F32_RTOL, F32_ATOL_REL = 1e-4, 1e-4

SR_EPOCHS = 2
SR_PARITY_BATCH, SR_PARITY_STEPS = 8, 2
HOST_LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx|"
                         r"cudaGraphLaunch|cudaMemcpyAsync|cudaMemsetAsync)")

def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def physics_inputs(b, dev, seed=0):
    """Rectangular contact maps (as tests/test_pallas_kernels.py) with
    seeded extents, noise on every other map, the last map all-zero;
    abm = 0.5 + |N(0, 1)|."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r0 = torch.randint(10, 45, (b,), generator=g)
    r1 = torch.randint(55, 95, (b,), generator=g)
    c0 = torch.randint(10, 45, (b,), generator=g)
    c1 = torch.randint(55, 95, (b,), generator=g)
    idx = torch.arange(100)
    rows = (idx[None] >= r0[:, None]) & (idx[None] < r1[:, None])
    cols = (idx[None] >= c0[:, None]) & (idx[None] < c1[:, None])
    depth = (rows[:, :, None] & cols[:, None, :]).float()
    # every other map carries sensor-like noise (a few-pixel contact mask)
    depth[::2] += 0.05 * torch.randn(depth[::2].shape, generator=g)
    depth[-1] = 0.0
    abm = 0.5 + torch.randn(b, 3, generator=g).abs()
    return depth.to(dev), abm.to(dev)


def plain_f32(depth, abm):
    with f32_matmul():
        return physics_plain(depth, abm)


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def vjp_plain_f32(depth, abm, g_hr, g_lr, need_depth):
    with f32_matmul():
        return physics_vjp_plain(depth, abm, g_hr, g_lr, need_depth, True)


def cotangents(b, dev, seed):
    """HR and LR cotangents, the HR one at the scale of the LR one's
    pull-back (1e-4 U^T g_lr U)."""
    g = torch.Generator().manual_seed(seed)
    return (1e-4 * torch.randn(b, 100, 100, generator=g)).to(dev), torch.randn(b, 4, 4, generator=g).to(dev)


def phase_build():
    """Build the kernels; their resources from ptxas and the occupancy the
    CUDA runtime gives them.  Returns kernel_info()."""
    t0 = time.perf_counter()
    tcuda.build()
    log(f"[build] tpsf_kernel.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    ptxas = tcuda.ptxas_info(tcuda.build_log)
    info = tcuda.kernel_info()
    for name, k in info.items():
        p = ptxas.get(name)
        check(p is not None, f"ptxas reported nothing for {name}: {ptxas}")
        log(f"[build] {name}: {k['threads']} threads, {p['registers']} registers, spill "
            f"stores/loads {p['spill_stores']}/{p['spill_loads']} B, shared memory "
            f"{p['static_smem']} B static + {k['dynamic_smem']} B dynamic, "
            f"{k['blocks_per_sm']} resident blocks per SM")
        check(p["spill_stores"] == 0 and p["spill_loads"] == 0 and k["local_bytes"] == 0,
              f"{name} spills: ptxas {p}, runtime {k}")
    check(info["tpsf_physics_bwd"]["blocks_per_sm"] >= 2,
          f"the backward fits {info['tpsf_physics_bwd']['blocks_per_sm']} blocks per SM (at least 2)")
    check(info["tpsf_physics_bf16"]["blocks_per_sm"] >= 3,
          f"the bf16 forward fits {info['tpsf_physics_bf16']['blocks_per_sm']} blocks per SM (at least 3)")
    check(info["tpsf_physics_bf16x3"]["blocks_per_sm"] >= 3,
          f"the three-pass bf16 forward fits {info['tpsf_physics_bf16x3']['blocks_per_sm']} blocks per SM "
          "(at least 3)")
    return info


def phase_kernel(dev):
    errs = {}
    for b in KERNEL_BATCHES:
        depth, abm = physics_inputs(b, dev, seed=b)
        hr_p, lr_p = plain_f32(depth, abm)
        hr_k, lr_k = tcuda.tpsf_physics(depth, abm)
        torch.cuda.synchronize()
        torch.testing.assert_close(hr_k, hr_p, **HR_TOL)
        torch.testing.assert_close(lr_k, lr_p, **LR_TOL)
        check(bool(torch.all(hr_k[-1] == 0)) and bool(torch.all(lr_k[-1] == 0)),
              "all-zero depth must give all-zero HR and LR")
        if b == 5:  # a view whose data is not 16-byte aligned takes the same path
            shifted = torch.empty(b * 10000 + 1, device=dev)[1:].view(b, 100, 100)
            shifted.copy_(depth)
            hr_s, lr_s = tcuda.tpsf_physics(shifted, abm)
            check(torch.equal(hr_s, hr_k) and torch.equal(lr_s, lr_k), "misaligned input differs")
        e_hr = float((hr_k - hr_p).abs().max())
        e_lr = float((lr_k - lr_p).abs().max())
        errs[b] = max(e_hr, e_lr)
        log(f"[kernel] B={b}: max|dHR|={e_hr:.3e} max|dLR|={e_lr:.3e} (HR rtol/atol 1e-4, "
            "LR rtol 1e-4 atol 1e-6) ok")
    return errs


def phase_kernel_bwd(dev):
    """The backward kernel against physics_vjp_plain (TF32 off): LR and HR
    cotangents for depth and abm, then the LR cotangent alone for abm."""
    errs = {}
    for b in KERNEL_BATCHES:
        # at B=1 the last (all-zero) map would be the only one: take a contact map
        depth, abm = physics_inputs(b + 1, dev, seed=b) if b == 1 else physics_inputs(b, dev, seed=b)
        depth, abm = depth[:b], abm[:b]
        g_hr, g_lr = cotangents(b, dev, seed=b + 1)
        worst = 0.0
        for hr_ct, need_depth in ((g_hr, True), (None, False)):
            gd_k, ga_k = tcuda.tpsf_physics_bwd(depth, abm, hr_ct, g_lr, need_depth=need_depth)
            gd_p, ga_p = vjp_plain_f32(depth, abm, hr_ct, g_lr, need_depth)
            torch.cuda.synchronize()
            pairs = [("abm", ga_k, ga_p)] + ([("depth", gd_k, gd_p)] if need_depth else [])
            for name, got, want in pairs:
                torch.testing.assert_close(got, want, **GRAD_TOL,
                                           msg=lambda m, n=name: f"B={b} {n} gradient: {m}")
                err = float((got - want).abs().max())
                worst = max(worst, err)
                log(f"[kernel] backward B={b} {'LR+HR' if need_depth else 'LR'} {name}: "
                    f"max|d|={err:.3e} (max |grad| {float(want.abs().max()):.3e}; rtol 1e-3, "
                    "atol 1e-6) ok")
            check(b == 1 or bool(torch.all(ga_k[-1] == 0)), "the all-zero map must get a zero abm gradient")
            check(bool(torch.all(ga_k[0] != 0)), "a contact map got a zero abm gradient")
        errs[b] = worst
    return errs


def _grad_parity(dev, b=MAIN_BATCH):
    """The wrapper's gradients against autograd through the plain physics
    (TF32 off) at the recipe's batch.  The loss reads the forward's LR, so
    the kernel's output feeds the cotangent.  Returns max |d grad|."""
    depth, abm = physics_inputs(b, dev, seed=77)
    g = torch.Generator().manual_seed(78)
    w_hr = torch.randn(b, 100, 100, generator=g).to(dev)
    target = torch.randn(b, 4, 4, generator=g).to(dev) * 1e-3

    def loss(hr, lr):
        return 0.5 * ((lr - target) ** 2).sum() + 1e-6 * (w_hr * hr).sum()

    d_k, a_k = depth.clone().requires_grad_(True), abm.clone().requires_grad_(True)
    loss(*tcuda.tpsf_physics_fused(d_k, a_k)).backward()
    d_p, a_p = depth.clone().requires_grad_(True), abm.clone().requires_grad_(True)
    with f32_matmul():
        loss(*physics_plain(d_p, a_p)).backward()
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("abm", a_k.grad, a_p.grad), ("depth", d_k.grad, d_p.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL,
                                   msg=lambda m, n=name: f"{n} gradient, kernel vs plain: {m}")
        errs[name] = float((got - want).abs().max())
        log(f"[training] B={b} {name} gradient: kernel fwd + kernel bwd vs plain autograd "
            f"max|d|={errs[name]:.3e} (max |grad| {float(want.abs().max()):.3e}; rtol 1e-3, "
            "atol 1e-6) ok")
    return max(errs.values())


class EpochClock(HookBase):
    """Host clock around each training epoch, the card synced at both ends.
    Registered last, so an epoch's eval and checkpoint fall inside it."""

    priority = 10

    def __init__(self):
        self.seconds = []

    def before_epoch(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def after_epoch(self):
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - self._t0)


def phase_training(work, dev):
    raw = os.path.join(work, "raw")
    generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "I", "P",
                   "--taps-per-blob", "81", "--seed", "0"])
    save_dir = os.path.join(work, "tpsf_train")
    argv = ["--dataset_dir", raw, "--save_dir", save_dir, "--epochs", str(TRAIN_EPOCHS),
            "--inference_test", "false"]
    init = tpsf_task.build_model(tPSFNet_config).state_dict()  # the entry's seeded init

    clock = EpochClock()
    tcuda.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = tpsf_task._cli(argv, hooks=[clock])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tcuda.launch_counts)

    cfg = trainer.config
    recipe = {k: cfg[k] for k in ("train_batch_size", "sample_cnt", "lr", "lr_scheduler_step_size",
                                  "lr_scheduler_gamma", "weight_decay", "compute_dtype",
                                  "test_batch_size", "device", "use_pallas_physics")}
    check(recipe == {k: tPSFNet_config[k] for k in recipe}, f"not the recipe's defaults: {recipe}")
    check(trainer.model.dtype == torch.bfloat16, "the MLP does not compute in bf16")
    check((trainer.n_train, trainer.epoch_len) == (7296, 29),
          f"expected 7,296 train samples in 29 steps, got {trainer.n_train} in {trainer.epoch_len}")
    steps = trainer.step
    check(steps == TRAIN_EPOCHS * trainer.epoch_len, f"{steps} optimizer steps")
    for name in ("tpsf_physics", "tpsf_physics_fused"):
        check(launches[name] >= steps,
              f"{name} launched {launches[name]} times in {steps} training steps: {launches}")
    check(launches["tpsf_physics_bwd"] == steps,
          f"tpsf_physics_bwd launched {launches['tpsf_physics_bwd']} times in {steps} steps")
    losses = trainer.metric_storage["total_loss"]
    check(len(losses) == steps and np.isfinite(losses.global_sum),
          f"losses: {len(losses)} logged, global sum {losses.global_sum}")
    eval_mse = trainer.metric_storage["Eval Metric"].latest
    check(np.isfinite(eval_mse), f"eval mse_loss_ave {eval_mse}")
    trained = trainer.model.state_dict()
    for k, v in init.items():
        moved = (trained[k].cpu() - v).abs()
        check(float(moved.max()) > 0, f"parameter {k} did not move")
        log(f"[training] {k}: max|moved| {float(moved.max()):.3e}, "
            f"{float((moved > 0).float().mean()) * 100:.2f}% of elements moved")
    ckpt = os.path.join(save_dir, "checkpoints", "latest.pth")
    check(os.path.exists(ckpt), f"{ckpt} missing")
    check(load_checkpoint_file(ckpt)["epoch"] == TRAIN_EPOCHS - 1, "latest.pth is not the last epoch")

    hook = tpsf_task.InferenceHookTPSF(None, None, scale_num=cfg["scale_num"])
    for name in ("I", "P"):
        lr_s, depth_s = SingleTapSeqsDataset(os.path.join(raw, f"{name}.npy"),
                                             [cfg["inference_index"]], cfg["sample_cnt"]).stacked()
        force, alpha, beta = hook._curves({"LR": lr_s, "depth": depth_s}, trainer.model)
        check(all(np.isfinite(x).all() for x in (force, alpha, beta)), f"{name} curves not finite")
        log(f"[training] {name} alpha/beta curves over {len(force)} presses: alpha "
            f"{alpha.min():.4g}..{alpha.max():.4g}, beta {beta.min():.4g}..{beta.max():.4g} ok")

    check(len(clock.seconds) == TRAIN_EPOCHS, f"epoch clock read {clock.seconds}")
    epoch_s = clock.seconds[-1]
    log(f"[training] {TRAIN_EPOCHS} epochs x {trainer.epoch_len} steps at B={cfg['train_batch_size']} "
        f"in {wall:.2f} s (entry wall clock, data preparation included); mean loss "
        f"{losses.global_avg:.6g}, last {losses.latest:.6g}; eval mse_loss_ave {eval_mse:.6g}; "
        f"launches {launches}")
    log(f"[training] epoch seconds {clock.seconds}; the last: {trainer.n_train} samples in "
        f"{trainer.epoch_len} steps, {epoch_s:.4f} s = {trainer.n_train / epoch_s:.1f} samples/s "
        "(host clock, card synced at both ends, the epoch's checkpoint included)")
    grad_err = _grad_parity(dev)
    return trainer, raw, ckpt, launches, grad_err, trainer.n_train / epoch_s


GEN_SPLITS = {"train": 2688, "validation": 384, "test": 384}  # SINGLE_SPLITS x 3 blobs x 32


def _plain_physics_check(ckpt, dev, lr, depth, hr, deg=None):
    """HR (and LR_degrade) of a generated split against the plain physics
    on the card, TF32 off."""
    ref = TPSFNet(use_kernel=False)
    ref.load_state_dict(load_checkpoint_file(ckpt)["model"])
    ref = ref.to(dev).eval()
    with torch.no_grad(), f32_matmul():
        hr_r, deg_r, _, _ = ref(torch.from_numpy(lr).to(dev), torch.from_numpy(depth).to(dev),
                                return_psf=False)
    torch.testing.assert_close(torch.from_numpy(hr), hr_r.cpu(), **HR_TOL)
    if deg is not None:
        torch.testing.assert_close(torch.from_numpy(deg), deg_r.cpu(), **LR_TOL)


def phase_generation(work, dev, raw, ckpt):
    out_dir = os.path.join(work, "SRdataset")
    tcuda.reset_launch_counts()
    generate._cli(["single", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir", out_dir,
                   "--sample-cnt", str(tPSFNet_config["sample_cnt"]), "--batch", str(MAIN_BATCH)])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    for name in ("tpsf_physics", "tpsf_physics_fused"):
        check(launches[name] > 0, f"generate single launched no {name}: {launches}")
    want = sum(-(-n // MAIN_BATCH) for n in GEN_SPLITS.values())
    check(launches["tpsf_physics"] == want, f"{launches['tpsf_physics']} launches, expected {want}")

    for split, n_want in GEN_SPLITS.items():
        with np.load(os.path.join(out_dir, f"SRdataset_{split}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        n = arrays["LR"].shape[0]
        check(n == n_want, f"split {split} has {n} samples, expected {n_want}")
        check(arrays["HR"].shape == (n, 1, 100, 100), f"{split} HR shape {arrays['HR'].shape}")
        for k, v in arrays.items():
            check(np.isfinite(v).all(), f"{split}/{k} has non-finite values")
    log(f"[generation] {GEN_SPLITS} samples, tpsf_physics launches={launches['tpsf_physics']}")

    # the test split again through the plain physics on the card
    with np.load(os.path.join(out_dir, "SRdataset_test.npz")) as z:
        lr, depth, hr, deg = z["LR"], z["depth"], z["HR"], z["LR_degrade"]
    _plain_physics_check(ckpt, dev, lr, depth, hr, deg)
    log("[generation] test split matches the plain physics (HR 1e-4, LR 1e-6) ok")
    return launches, lr, out_dir


# --------------------------------------------------------- the bf16 physics (physics_precision)
# bf16 kernels vs the plain version of their precision, of the largest |HR|
# and |LR|: both round T = A D to bf16 as the next product's operand after
# f32 sums taken in other orders, so an element on a rounding boundary can
# round to neighbouring bf16 values
PHYS_BF16_REL = 1e-3
# physics_precision default vs f32, of the largest |LR|: the JAX package's
# envelope (tests/test_pallas_kernels.py:66-75)
PHYS_BF16_F32_ENVELOPE = 1e-2
BF16_KERNELS = {"default": "tpsf_physics_bf16", "high": "tpsf_physics_bf16x3"}
BF16_PASSES = {"default": 1, "high": 3}
# 1, 5, 256 and 8192 as in KERNEL_BATCHES, and 397, which is not a whole
# number of waves
PHYS_BF16_BATCHES = (1, 5, 256, 397, 8192)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def edge_maps(dev, seed=0):
    """Contact maps at the kernel's edges: contacts on rows and columns 0
    and 99 (and the four corners) over noise, then maps where every pixel is
    in contact (the second max is 0, so HR and LR are exactly zero), then
    an ordinary map; returns depth, abm and the all-contact maps' indices."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    depth = 0.3 * torch.rand(8, 100, 100, generator=g)
    depth[0, [0, -1], :] = 1.0
    depth[1, :, [0, -1]] = 1.0
    depth[2, [0, 0, -1, -1], [0, -1, 0, -1]] = 1.0
    depth[3, [0, -1], :] = 1.0
    depth[3, :, [0, -1]] = 1.0
    depth[4] = 0.7
    depth[5] = 2.0
    depth[6] = 0.7 + 4e-4 * torch.rand(100, 100, generator=g)
    depth[7] = 0.0
    depth[7, 20:70, 30:80] = 1.0
    abm = 0.5 + torch.randn(8, 3, generator=g).abs()
    return depth.to(dev), abm.to(dev), [4, 5, 6]


def phase_kernel_precision(dev):
    """Each bf16 kernel against the plain version of its precision (TF32
    off) at B in PHYS_BF16_BATCHES and on the edge maps, within
    PHYS_BF16_REL, bitwise repeatable, the all-zero and all-contact maps
    zero; its deviation from the f32 kernel (``default`` within
    PHYS_BF16_F32_ENVELOPE of max|LR|).  Returns the max abs errors and the
    deviations at B=8192."""
    errs, devs = {}, {}
    for prec, name in BF16_KERNELS.items():
        depth, abm, all_contact = edge_maps(dev)
        with f32_matmul():
            hr_p, lr_p = physics_plain(depth, abm, prec)
        hr_k, lr_k = tcuda.tpsf_physics(depth, abm, prec)
        torch.cuda.synchronize()
        e_hr, e_lr = _rel(hr_k, hr_p), _rel(lr_k, lr_p)
        check(max(e_hr, e_lr) < PHYS_BF16_REL,
              f"{name} edge maps vs its plain version: HR {e_hr:.3e}, LR {e_lr:.3e} (limit {PHYS_BF16_REL})")
        check(bool(torch.all(hr_k[all_contact] == 0)) and bool(torch.all(lr_k[all_contact] == 0)),
              f"{name}: all-contact maps must give all-zero HR and LR")
        errs[name] = max(float((hr_k - hr_p).abs().max()), float((lr_k - lr_p).abs().max()))
        log(f"[kernel_precision] {name} edge maps (border rows and columns, all-contact): vs plain "
            f"{prec} HR {e_hr:.3e} LR {e_lr:.3e} of the largest; all-contact maps zero ok")
        for b in PHYS_BF16_BATCHES:
            # at B=1 the last (all-zero) map would be the only one: take a contact map
            depth, abm = physics_inputs(b + 1, dev, seed=b) if b == 1 else physics_inputs(b, dev, seed=b)
            depth, abm = depth[:b].contiguous(), abm[:b].contiguous()
            with f32_matmul():
                hr_p, lr_p = physics_plain(depth, abm, prec)
            hr_k, lr_k = tcuda.tpsf_physics(depth, abm, prec)
            hr_f, lr_f = tcuda.tpsf_physics(depth, abm)
            hr_2, lr_2 = tcuda.tpsf_physics(depth, abm, prec)
            torch.cuda.synchronize()
            e_hr, e_lr = _rel(hr_k, hr_p), _rel(lr_k, lr_p)
            d_hr, d_lr = _rel(hr_k, hr_f), _rel(lr_k, lr_f)
            check(max(e_hr, e_lr) < PHYS_BF16_REL,
                  f"{name} B={b} vs its plain version: HR {e_hr:.3e}, LR {e_lr:.3e} (limit {PHYS_BF16_REL})")
            check(torch.equal(hr_2, hr_k) and torch.equal(lr_2, lr_k), f"{name} B={b} not repeatable")
            check(b == 1 or (bool(torch.all(hr_k[-1] == 0)) and bool(torch.all(lr_k[-1] == 0))),
                  "all-zero depth must give all-zero HR and LR")
            check(prec != "default" or d_lr < PHYS_BF16_F32_ENVELOPE,
                  f"{name} B={b} LR {d_lr:.3e} of max|LR| from f32 (envelope {PHYS_BF16_F32_ENVELOPE})")
            errs[name] = max(errs.get(name, 0.0), float((hr_k - hr_p).abs().max()),
                             float((lr_k - lr_p).abs().max()))
            devs[name] = dict(hr=d_hr, lr=d_lr)
            log(f"[kernel_precision] {name} B={b}: vs plain {prec} HR {e_hr:.3e} LR {e_lr:.3e} of "
                f"the largest (limit {PHYS_BF16_REL}); vs the f32 kernel HR {d_hr:.3e} LR {d_lr:.3e}; "
                "repeatable ok")
    return errs, devs


def phase_training_precision(work, raw):
    """Stage 1 through its entry with ``--physics_precision default`` at the
    recipe's defaults, one eager epoch and one captured (``--scan_epochs
    true``): the bf16 kernel at least once per step, the f32 backward
    exactly once, the f32 forward never; the graph holds one bf16 launch
    per replay; losses and the eval metric finite.  Returns
    {mode: (trainer, launches, samples/s)}."""
    runs = {}
    for mode, extra in (("eager", []), ("captured", ["--scan_epochs", "true"])):
        argv = ["--dataset_dir", raw, "--save_dir", os.path.join(work, f"tpsf_default_{mode}"),
                "--epochs", "1", "--inference_test", "false", "--physics_precision", "default", *extra]
        clock = EpochClock()
        tcuda.reset_launch_counts()
        trainer = tpsf_task._cli(argv, hooks=[clock])
        torch.cuda.synchronize()
        launches = dict(tcuda.launch_counts)
        steps = trainer.step
        check(trainer.model.physics_precision == "default" and trainer.model.use_kernel == "auto",
              f"the model runs {trainer.model.physics_precision} / {trainer.model.use_kernel}")
        check(steps == trainer.epoch_len == 29, f"{steps} steps in an epoch of {trainer.epoch_len}")
        check(launches["tpsf_physics_bf16"] >= steps and launches["tpsf_physics_fused"] >= steps,
              f"{launches} in {steps} {mode} steps")
        check(launches["tpsf_physics_bwd"] == steps, f"tpsf_physics_bwd: {launches} in {steps} steps")
        check(launches["tpsf_physics"] == 0 and launches["tpsf_physics_bf16x3"] == 0,
              f"another precision's kernel ran: {launches}")
        if mode == "captured":
            per = trainer._graph.per_replay if trainer._graph is not None else {}
            check(per.get("tpsf_physics_bf16") == 1 and per.get("tpsf_physics_bwd") == 1,
                  f"the stage-1 graph records {per}")
        losses = trainer.metric_storage["total_loss"]
        check(len(losses) == steps and np.isfinite(_losses(trainer)).all(),
              f"{mode} losses: {len(losses)} logged, {_losses(trainer)}")
        eval_mse = trainer.metric_storage["Eval Metric"].latest
        check(np.isfinite(eval_mse), f"eval mse_loss_ave {eval_mse}")
        sps = trainer.n_train / clock.seconds[-1]
        log(f"[training_precision] {mode}: {steps} steps at physics_precision default, launches "
            f"{launches}; losses finite (mean {losses.global_avg:.6g}, last {losses.latest:.6g}), "
            f"eval mse {eval_mse:.6g}; epoch {clock.seconds[-1]:.3f} s = {sps:.1f} samples/s ok")
        runs[mode] = (trainer, launches, sps)
    return runs


def _split_arrays(out_dir, split, suffix=""):
    with np.load(os.path.join(out_dir, f"SRdataset_{split}{suffix}.npz")) as z:
        return {k: z[k] for k in z.files}


def phase_generation_precision(work, dev, raw, ckpt, f32_dir, f32_seqs_dir):
    """``generate single --physics-precision default`` (15 launches of the
    bf16 kernel, none of the f32 one; labels within PHYS_BF16_F32_ENVELOPE of the
    f32 labels, the test split within PHYS_BF16_REL of the plain bf16 physics),
    ``--use-pallas false`` (no kernel launch, the f32 labels) and
    ``generate seqs --physics-precision high`` (5 launches of the
    three-pass kernel).  Returns {path: launches} and the deviations."""
    base = ["--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--sample-cnt",
            str(tPSFNet_config["sample_cnt"]), "--batch", str(MAIN_BATCH)]
    want = sum(-(-n // MAIN_BATCH) for n in GEN_SPLITS.values())
    by_path, devs = {}, {}
    for path, argv, kernel, n_launch in (
        ("generation_precision", ["single", "--physics-precision", "default"], "tpsf_physics_bf16", want),
        ("generation_precision_off", ["single", "--physics-precision", "default", "--use-pallas",
                                      "false"], None, 0),
        ("generation_seqs_high", ["seqs", "--physics-precision", "high", "--n-contacts", "3",
                                  "--n-translations", "9"], "tpsf_physics_bf16x3", 5),
    ):
        out_dir = os.path.join(work, path)
        tcuda.reset_launch_counts()
        generate._cli(argv + base + ["--out-dir", out_dir])
        torch.cuda.synchronize()
        launches = by_path[path] = dict(tcuda.launch_counts)
        others = {k: n for k, n in launches.items() if k not in (kernel, "tpsf_physics_fused") and n}
        check(not others, f"{path} launched {others}")
        check(kernel is None or launches[kernel] == launches["tpsf_physics_fused"] == n_launch,
              f"{path}: {launches}, expected {n_launch} of {kernel}")
        check(kernel is not None or not any(launches.values()), f"{path} launched {launches}")
        splits = (("train", "_32"), ("validation", "_32"), ("test", "_32")) if argv[0] == "seqs" else \
            tuple((s, "") for s in GEN_SPLITS)
        worst = dict(hr=0.0, lr=0.0)
        for split, suffix in splits:
            got = _split_arrays(out_dir, split, suffix)
            ref = _split_arrays(f32_seqs_dir if argv[0] == "seqs" else f32_dir, split, suffix)
            check(sorted(got) == sorted(ref), f"{path}/{split} keys {sorted(got)}")
            check(np.array_equal(got["LR"], ref["LR"]) and np.array_equal(got["depth"], ref["depth"]),
                  f"{path}/{split}: the inputs differ from the f32 run's")
            for k in got:
                check(np.isfinite(got[k]).all(), f"{path}/{split}/{k} has non-finite values")
            hr_t, hr_r = torch.from_numpy(got["HR"]), torch.from_numpy(ref["HR"])
            if kernel is None:  # --use-pallas false: the f32 physics
                torch.testing.assert_close(hr_t, hr_r, **HR_TOL)
                torch.testing.assert_close(torch.from_numpy(got["LR_degrade"]),
                                           torch.from_numpy(ref["LR_degrade"]), **LR_TOL)
                continue
            worst["hr"] = max(worst["hr"], _rel(hr_t, hr_r))
            if "LR_degrade" in got:
                worst["lr"] = max(worst["lr"], _rel(torch.from_numpy(got["LR_degrade"]),
                                                    torch.from_numpy(ref["LR_degrade"])))
        envelope = PHYS_BF16_F32_ENVELOPE if kernel == "tpsf_physics_bf16" else 1e-4
        check(max(worst.values()) < envelope, f"{path} labels {worst} from f32 (limit {envelope})")
        devs[path] = worst
        if kernel == "tpsf_physics_bf16":  # the test split against the plain bf16 physics
            z = _split_arrays(out_dir, "test")
            model = generate.load_tpsf(ckpt, physics_precision="default", device=dev, use_pallas="false")
            with torch.no_grad(), f32_matmul():
                lr_in = torch.from_numpy(z["LR"]).to(dev)
                ab = torch.nn.functional.softplus(model.MLP_layer(lr_in).float())
                hr_p, lr_p = physics_plain(torch.from_numpy(z["depth"][:, 0]).to(dev), ab, "default")
            e = (_rel(torch.from_numpy(z["HR"][:, 0]), hr_p.cpu()),
                 _rel(torch.from_numpy(z["LR_degrade"][:, 0]), lr_p.cpu()))
            check(max(e) < PHYS_BF16_REL, f"{path} test split vs the plain bf16 physics: {e}")
            devs[path]["vs_plain"] = e
        log(f"[generation_precision] {path}: launches {launches}; labels vs the f32 run's: "
            f"{worst if kernel else 'equal at HR 1e-4, LR 1e-6'} ok")
    return by_path, devs


def phase_generation_breakdown(work, raw, ckpt):
    """``generate single`` (f32 and bf16) split into loading the model, raw
    load and preprocessing, the physics (copies included) and writing the
    splits (host clock): the native preprocessing (it must have run: its
    call counts rise) and the numpy one (``TACTILESR_NATIVE=0``)."""
    from tactilesr_torch import native

    check(native.available(), f"the native preprocessing did not build: {native.build_error}")
    out = {}
    for name, env, prec in (("native", "1", "highest"), ("numpy", "0", "highest"),
                            ("native_default", "1", "default"), ("native_again", "1", "highest")):
        os.environ["TACTILESR_NATIVE"] = env
        native.reset_calls()
        timings = {}
        t0 = time.perf_counter()
        generate.generate_single_srdataset(ckpt, raw, os.path.join(work, f"breakdown_{name}"),
                                           sample_cnt=tPSFNet_config["sample_cnt"], batch=MAIN_BATCH,
                                           physics_precision=prec, timings=timings)
        torch.cuda.synchronize()
        timings["wall"] = time.perf_counter() - t0
        calls = dict(native.calls)
        check((env == "1") == (calls["binarize_depth"] > 0 and calls["extract_contact_seqs"] > 0),
              f"{name}: native calls {calls}")
        out[name] = dict(timings, native_calls=calls)
        log(f"[generation_breakdown] {name} ({prec}): " + ", ".join(
            f"{k} {v:.4f} s" for k, v in timings.items()) + f"; native calls {calls}")
    os.environ["TACTILESR_NATIVE"] = "1"
    return out


def phase_times_precision(dev):
    """Both bf16 kernels at B=256 and 8192 beside the f32 kernel in the
    same phase (CUDA events, alternating), their plain versions and their
    bounds."""
    out = {}
    for prec, name in BF16_KERNELS.items():
        out[name] = {}
        for b in (MAIN_BATCH, 8192):
            depth, abm = physics_inputs(b, dev, seed=100 + b)
            iters = 200 if b <= 256 else 20
            k1 = cuda_ms(lambda: tcuda.tpsf_physics(depth, abm, prec), iters)
            f_ms = cuda_ms(lambda: tcuda.tpsf_physics(depth, abm), iters)
            k2 = cuda_ms(lambda: tcuda.tpsf_physics(depth, abm, prec), iters)

            def plain():
                with f32_matmul():
                    return physics_plain(depth, abm, prec)

            p_ms = cuda_ms(plain, max(5, iters // 4))
            bound, by = tpsf_bf16_bound_ms(b, BF16_PASSES[prec])
            k_ms = min(k1, k2)
            out[name][b] = dict(ms=k_ms, ms_runs=[k1, k2], f32_kernel_ms=f_ms, plain_ms=p_ms,
                                bound_ms=bound, bound_by=by, bound_share=bound / k_ms)
            log(f"[times] {name} B={b}: kernel {k1:.4f} / {k2:.4f} ms ({b / k_ms * 1e3:.0f} samples/s), "
                f"the f32 kernel between them {f_ms:.4f} ms, plain {prec} (TF32 off) {p_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), {bound / k_ms * 100:.1f}% of the bound")
    return out


class CapturableAdam(HookBase):
    """Makes an eager run's Adam capturable before it trains, so that it
    does the captured step's arithmetic (the eager loop's own Adam is
    host-side)."""

    def before_train(self):
        self.trainer.optimizer.make_capturable()


class StartState(HookBase):
    """The model's state when training starts; with ``trunk`` (an STSR
    state_dict) it also holds the warm-started trunk against it, bit for
    bit."""

    def __init__(self, trunk=None):
        self.trunk = trunk
        self.state = None
        self.trunk_mismatch = None

    def before_train(self):
        self.state = {k: v.detach().cpu().clone() for k, v in self.trainer.model.state_dict().items()}
        if self.trunk is not None:
            self.trunk_mismatch = [k for k, v in self.trunk.items() if not torch.equal(self.state[k], v)]


def _check_sr_run(name, trainer, start, steps):
    """Losses and eval metrics finite, every parameter moved, every BN
    running statistic off its init, every num_batches_tracked = steps."""
    losses = trainer.metric_storage["total_loss"]
    check(trainer.step == steps, f"{name}: {trainer.step} optimizer steps, expected {steps}")
    check(len(losses) == steps and np.isfinite(losses.global_sum),
          f"{name} losses: {len(losses)} logged, global sum {losses.global_sum}")
    evals = {k: trainer.metric_storage[k].latest for k in ("test_loss", "test_PSNR", "test_SSIM")}
    check(all(np.isfinite(v) for v in evals.values()), f"{name} eval {evals}")
    end = trainer.model.state_dict()
    n_param = n_bn = 0
    least = float("inf")
    for k, v in start.items():
        now = end[k].detach().cpu()
        if k.endswith("num_batches_tracked"):
            check(int(now) - int(v) == steps, f"{name}: {k} = {int(now)} after {steps} steps from {int(v)}")
        elif k.endswith(("running_mean", "running_var")):
            n_bn += 1
            init = 0.0 if k.endswith("mean") else 1.0
            check(bool((now != init).any()) and not torch.equal(now, v), f"{name}: {k} did not move")
        else:
            n_param += 1
            moved = float((now - v).abs().max())
            least = min(least, moved)
            check(moved > 0, f"{name}: parameter {k} did not move")
    log(f"[{name}] {steps} steps: every one of {n_param} parameters moved (the least by "
        f"{least:.3e}), {n_bn} BN running statistics moved, num_batches_tracked = steps; mean loss "
        f"{losses.global_avg:.6g}, last {losses.latest:.6g}; eval {evals}")


def phase_sr_training(work, sr_dir):
    """STSR through its entry at the recipe's defaults on the generated labels."""
    save_dir = os.path.join(work, "stsr")
    argv = ["--train_dataset_dir", os.path.join(sr_dir, "SRdataset_train.npz"),
            "--test_dataset_dir", os.path.join(sr_dir, "SRdataset_test.npz"),
            "--save_dir", save_dir, "--epochs", str(SR_EPOCHS), "--inference_test", "false"]
    clock, start = EpochClock(), StartState()
    t0 = time.perf_counter()
    trainer = sr_task._cli(argv, hooks=[clock, start])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = trainer.config
    keys = ("train_batch_size", "test_batch_size", "lr", "weight_decay", "warmup_t", "warmup_mode",
            "warmup_init_lr", "warmup_factor", "lr_scheduler_step_size", "lr_scheduler_gamma",
            "compute_dtype", "scale_factor", "seqsCnt", "patternFeatureExtraLayerCnt",
            "forceFeatureExtraLayerCnt", "head_init", "device", "random_seed")
    recipe = {k: cfg[k] for k in keys}
    check(recipe == {k: tactileSR_config[k] for k in keys}, f"not the recipe's defaults: {recipe}")
    check(trainer.model.dtype == torch.bfloat16, "the STSR does not compute in bf16")
    check((trainer.n_train, trainer.epoch_len) == (GEN_SPLITS["train"], 84),
          f"expected 2,688 train samples in 84 steps, got {trainer.n_train} in {trainer.epoch_len}")
    _check_sr_run("sr", trainer, start.state, SR_EPOCHS * trainer.epoch_len)
    ckpt = os.path.join(save_dir, "checkpoints", "latest.pth")
    check(load_checkpoint_file(ckpt)["epoch"] == SR_EPOCHS - 1, "latest.pth is not the last epoch")
    check(len(clock.seconds) == SR_EPOCHS, f"epoch clock read {clock.seconds}")
    sps = trainer.n_train / clock.seconds[-1]
    log(f"[sr] STSR {SR_EPOCHS} epochs x {trainer.epoch_len} steps at B={cfg['train_batch_size']} "
        f"in {wall:.2f} s (entry wall clock, data preparation included); epoch seconds "
        f"{clock.seconds}; the last: {sps:.1f} samples/s (host clock, card synced at both ends, "
        "the epoch's eval and checkpoint included)")
    return trainer, ckpt, sps


def _state_deviation(got, want, lr, steps, stats_atol):
    """Max deviations of two SR training states (BN statistics, parameters
    and the pre-BN conv biases apart).  BN statistics at ``stats_atol``;
    every parameter element within 2 x lr x steps, and all but 1% of the
    parameters' elements (the pre-BN conv biases aside) within 1e-5.  In
    f32 the gradients through the BatchNorm chain carry rounding of the size
    of BN's output gradient, and Adam turns an element whose true gradient
    lies under it into a step of about lr of the rounding's sign; the
    pre-BN conv biases have a true gradient of 0, so all their elements are
    such elements."""
    dev = {"stats": 0.0, "params": 0.0, "pre_bn_bias": 0.0, "elements_over_1e-5": 0}
    n_elements, worst = 0, []
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (got[k] - v).abs()
        if k.endswith(("running_mean", "running_var")):
            check(float(d.max()) <= stats_atol, f"{k}: max|d| {float(d.max()):.3e} > {stats_atol}")
            dev["stats"] = max(dev["stats"], float(d.max()))
            continue
        check(float(d.max()) <= 2 * lr * steps, f"{k}: max|d| {float(d.max()):.3e} > 2 lr steps")
        if re.search(r"conv_[35]_[12]\.0\.bias$", k):
            dev["pre_bn_bias"] = max(dev["pre_bn_bias"], float(d.max()))
            continue
        over = int((d > 1e-5).sum())
        n_elements += d.numel()
        dev["params"] = max(dev["params"], float(d.max()))
        dev["elements_over_1e-5"] += over
        if over:
            worst.append((over, d.numel(), k))
    dev["parameter_elements"] = n_elements
    dev["most_over_1e-5"] = sorted(worst, reverse=True)[:4]
    check(dev["elements_over_1e-5"] <= 0.01 * n_elements,
          f"{dev['elements_over_1e-5']} of {n_elements} parameter elements beyond 1e-5: {worst}")
    return dev


def _sr_trainer(cfg, model, arrays, work_dir, device, max_epochs, epoch_len, **kw):
    """An SRTrainer at the recipe's optimizer and schedule (no warmup) over
    ``arrays`` at the config's batch."""
    return sr_task.SRTrainer(
        config=cfg, model=model,
        optimizer=adam_l2(model.parameters(), weight_decay=cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], cfg["lr_scheduler_step_size"],
                                            cfg["lr_scheduler_gamma"]),
                                     by_epoch=True, epoch_len=epoch_len),
        train_arrays=arrays, batch_size=cfg["train_batch_size"], max_epochs=max_epochs,
        work_dir=work_dir, seed=0, device=device, **kw)


def phase_sr_parity(work, sr_dir, devices=("cuda", "cpu")):
    """2 SRTrainer steps of the full-width f32 STSR at batch 8 from one
    seeded init on the same 8 generated samples, on the card and on the CPU
    (``matmul_precision: highest`` through ``apply_matmul_precision``, which
    turns TF32 off for convolutions and matmuls): losses at rtol 1e-4; after step 1 the
    BN running statistics at atol 1e-5, after step 2 at 5e-4 (they then
    read weights that parted as ``_state_deviation`` says); parameters per
    element (``_state_deviation``)."""
    cfg = dict(tactileSR_config, compute_dtype="float32", warmup_t=0, train_batch_size=SR_PARITY_BATCH,
               matmul_precision="highest")
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        arrays = {"LR": z["LR"][:SR_PARITY_BATCH], "HR": z["HR"][:SR_PARITY_BATCH]}
    init = sr_task.build_model(cfg).state_dict()
    apply_matmul_precision(cfg)  # the recipe's "highest": f32 convolutions and matmuls
    check(not torch.backends.cudnn.allow_tf32, "matmul_precision highest left cuDNN in TF32")
    runs = {}
    for device in devices:
        model = sr_task.build_model(cfg)
        model.load_state_dict(init)
        snaps = []

        class _Snap(HookBase):
            def after_iter(self):
                snaps.append({k: v.detach().cpu().clone()
                              for k, v in self.trainer.model.state_dict().items()})

        t0 = time.perf_counter()
        t = _sr_trainer(cfg, model, arrays, os.path.join(work, f"sr_parity_{device}"), device,
                        max_epochs=SR_PARITY_STEPS, epoch_len=1)
        t.register_hooks([_Snap()])
        t.train(auto_resume=False)
        runs[device] = (t.metric_storage["total_loss"].state_dict()["values"], snaps)
        log(f"[sr] parity: {SR_PARITY_STEPS} f32 steps at B={SR_PARITY_BATCH} on {device} in "
            f"{time.perf_counter() - t0:.2f} s")
    (loss_g, snap_g), (loss_c, snap_c) = (runs[d] for d in devices)
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    lr = cfg["lr"]
    first = _state_deviation(snap_g[0], snap_c[0], lr, 1, stats_atol=1e-5)
    last = _state_deviation(snap_g[-1], snap_c[-1], lr, SR_PARITY_STEPS, stats_atol=5e-4)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    log(f"[sr] card vs CPU, full-width f32 STSR, {SR_PARITY_STEPS} steps at B={SR_PARITY_BATCH}: "
        f"losses {loss_g} vs {loss_c} (max rel {loss_err:.3e}, rtol 1e-4); after step 1 {first}; "
        f"after step {SR_PARITY_STEPS} {last} (stats atol 1e-5 then 5e-4; parameters within "
        "2 lr steps, at most 1% of their elements beyond 1e-5) ok")
    return dict(loss_rel=loss_err, step1=first, last=last)


# the data_parallel phase: 2 gloo ranks share cuda:0 (NCCL refuses two ranks
# on one card), each rank a subprocess of this script (``--dp-rank SPEC``)
DP_RANKS = 2
DP_BATCH = 32  # the recipe's global batch: 16 rows a rank
DP_F32_STEPS = 4
DP_BF16_ROWS = 320  # 10 steps an epoch
DP_NCCL_STEPS = SCAN_WARMUP_STEPS + 5  # warm-up, the capture, then replays
DP_BUCKET = 1024
DP_TIMEOUT_S = 600


class StepClock(HookBase):
    """Host ms of each iteration, the card synced at its end."""

    priority = 10

    def __init__(self):
        self.ms = []

    def before_iter(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def after_iter(self):
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self._t0) * 1e3)


class StepStates(HookBase):
    """The model's state (on the CPU) after each iteration."""

    def __init__(self):
        self.states = []

    def after_iter(self):
        self.states.append({k: v.detach().cpu().clone()
                            for k, v in self.trainer.model.state_dict().items()})


def _pre_bn_bias_stats_atol(lr, steps, momentum=0.1):
    """How far BN running means may part after ``steps`` steps of two runs
    whose parameters part as ``_state_deviation`` allows: the conv bias in
    front of a BN (true gradient 0) may differ by 2 lr (k - 1) when step k
    reads it, and the running mean takes the batch mean at weight
    momentum, decaying by (1 - momentum) a step."""
    return sum(momentum * (1 - momentum) ** (steps - k) * 2 * lr * (k - 1)
               for k in range(1, steps + 1))


def _median_step_ms(clock):
    """The median of an eager run's step times, its first two (cuDNN's
    algorithm search) left out."""
    return float(np.median(clock.ms[2:])) if len(clock.ms) > 2 else None


def dp_rank(spec_path):
    """One gloo rank of the data_parallel phase (run as ``chip_smoke.py
    --dp-rank SPEC`` with the ``TACTILESR_*`` variables): the f32 steps,
    the bf16 epoch and its resume, the tPSF epoch; prints one RESULT line."""
    from tactilesr_torch.parallel import all_gather_object, init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    rank = init_distributed()
    check(torch.distributed.get_backend() == "gloo" and torch.distributed.get_world_size() == DP_RANKS,
          f"rank {rank}: {torch.distributed.get_backend()} world {torch.distributed.get_world_size()}")
    out = {"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device())),
           "seconds": {}}

    t0 = time.perf_counter()
    clock, snaps = StepClock(), StepStates()
    t = sr_task._cli(spec["f32_argv"], hooks=[clock, snaps])
    check(t.mesh is not None and t.mesh.size == DP_RANKS and t.step == DP_F32_STEPS,
          f"f32 run: mesh {t.mesh}, {t.step} steps")
    torch.save({"after_1": snaps.states[0], "last": snaps.states[-1]},
               os.path.join(spec["dir"], f"f32_rank{rank}.pt"))
    out["f32"] = {"losses": _losses(t)[:-1] if rank == 0 else [], "step_ms": clock.ms}
    out["seconds"]["f32"] = time.perf_counter() - t0
    try:  # gloo's collectives cannot be captured: scan_epochs must refuse, not run uncaptured
        sr_task._cli(spec["f32_argv"] + ["--scan_epochs", "true", "--save_dir",
                                         os.path.join(spec["dir"], "scan_gloo")])
        check(False, "scan_epochs under gloo on CUDA ran")
    except RuntimeError as e:
        check("gloo" in str(e), f"scan_epochs under gloo raised {e!r}")

    t0 = time.perf_counter()
    clock = StepClock()
    t = sr_task._cli(spec["bf16_argv"], hooks=[clock])
    check(t.model.dtype == torch.bfloat16 and t.step == t.epoch_len, f"bf16 run: {t.step} steps")
    t = sr_task.main(t.config, max_epochs=2, auto_resume=True)
    check(t.start_iter == t.epoch_len and t.step == 2 * t.epoch_len,
          f"resume: from {t.start_iter}, {t.step} steps")
    digests = all_gather_object(t.state_digest())
    check(len(set(digests)) == 1, f"the replicas differ after the resume: {digests}")
    losses = t.metric_storage["total_loss"] if rank == 0 else None
    if rank == 0:
        check(len(losses) == 2 * t.epoch_len and np.isfinite(losses.global_sum),
              f"bf16 losses: {len(losses)} logged, global sum {losses.global_sum}")
    out["bf16"] = {"steps": t.step, "step_ms": _median_step_ms(clock),
                   "mean_loss": losses.global_avg if rank == 0 else None,
                   "eval": {k: t.metric_storage[k].latest for k in ("test_loss", "test_PSNR")}}
    out["seconds"]["bf16"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tcuda.reset_launch_counts()
    t = tpsf_task._cli(spec["tpsf_argv"])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    steps = t.step
    check(t.mesh.size == DP_RANKS and (t.n_train, t.epoch_len) == (7296, 29),
          f"tPSF: mesh {t.mesh}, {t.n_train} samples in {t.epoch_len} steps")
    for name in ("tpsf_physics", "tpsf_physics_fused"):
        check(launches[name] >= steps, f"rank {rank}: {name} {launches[name]} in {steps} steps")
    check(launches["tpsf_physics_bwd"] == steps,
          f"rank {rank}: tpsf_physics_bwd {launches['tpsf_physics_bwd']} in {steps} steps")
    if rank == 0:
        check(np.isfinite(t.metric_storage["total_loss"].global_sum), "tPSF losses not finite")
    out["tpsf"] = {"steps": steps, "launches": launches,
                   "rows_per_rank": t.batch_size // t.mesh.size}
    out["seconds"]["tpsf"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)


def _run_ranks(spec_path):
    """Start the gloo ranks, wait for every one; any rank's failure raises."""
    from tactilesr_torch.parallel import rank_results, spawn_local_ranks

    procs = spawn_local_ranks([sys.executable, os.path.abspath(__file__), "--dp-rank", spec_path],
                              DP_RANKS, backend="gloo")
    return rank_results(procs, DP_TIMEOUT_S)


class _CountAllReduce:
    """``torch.distributed.all_reduce`` counted by whether the current
    stream is capturing a CUDA graph."""

    def __init__(self):
        self.calls = {"eager": 0, "captured": 0}
        self._orig = torch.distributed.all_reduce

    def __call__(self, *args, **kwargs):
        self.calls["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return self._orig(*args, **kwargs)


def _nccl_one_rank(work, dev, sr_dir):
    """The full-width f32 STSR at B=32 with ``scan_epochs`` for one epoch
    (warm-up, capture, replays), over an explicit one-rank mesh in a
    one-rank NCCL group and without a mesh: losses at rtol 1e-6 (B=32, all
    rows valid: the mesh step's scaling by 32 and the one-rank sum are
    exact); the all_reduce issued in the capture and never from the host at
    a replay; each graph's replay time and device ops."""
    import socket

    from tactilesr_torch.parallel import make_mesh
    from tactilesr_torch.parallel.dist import DIST_TIMEOUT

    cfg = dict(tactileSR_config, compute_dtype="float32", warmup_t=0, train_batch_size=DP_BATCH,
               matmul_precision="highest")
    n = DP_BATCH * DP_NCCL_STEPS
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        arrays = {"LR": z["LR"][:n], "HR": z["HR"][:n]}
    init = sr_task.build_model(cfg).state_dict()
    apply_matmul_precision(cfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=1, rank=0, timeout=DIST_TIMEOUT)
    counter = _CountAllReduce()
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.distributed.all_reduce = counter
        for name, mesh in (("nccl_mesh", make_mesh()), ("no_mesh", None)):
            model = sr_task.build_model(cfg)
            model.load_state_dict(init)
            t = _sr_trainer(cfg, model, arrays, os.path.join(work, f"dp_{name}"), dev, max_epochs=1,
                            epoch_len=DP_NCCL_STEPS, scan_epochs=True, mesh=mesh)
            t.train(auto_resume=False)
            check(t._graph is not None and t.step == DP_NCCL_STEPS, f"{name}: no graph replayed")
            runs[name] = t
        calls = dict(counter.calls)
        torch.distributed.all_reduce = counter._orig
        times = {name: captured_step_times(t, iters=4) for name, t in runs.items()}
        names = {name: _replay_op_names(t) for name, t in runs.items()}
    finally:
        torch.distributed.all_reduce = counter._orig
        torch.backends.cudnn.deterministic = prev
        torch.distributed.destroy_process_group()
    mesh_t, plain_t = runs["nccl_mesh"], runs["no_mesh"]
    check(mesh_t.mesh.size == 1 and plain_t.mesh is None, "the meshes")
    # 3 eager warm-up steps and one capture call the collective; the replays
    # (and the mesh-free run) never do from the host
    check(calls == {"eager": SCAN_WARMUP_STEPS, "captured": 1},
          f"all_reduce calls {calls}: expected {SCAN_WARMUP_STEPS} eager and 1 in the capture")
    np.testing.assert_allclose(_losses(mesh_t), _losses(plain_t), rtol=1e-6)
    # NCCL's one-rank in-place sum may enqueue no device work at all
    nccl_ops = {name: sorted(k for k in ops if "nccl" in k.lower()) for name, ops in names.items()}
    log(f"[data_parallel] one-rank NCCL group, full-width f32 STSR at B={DP_BATCH}, scan_epochs "
        f"{DP_NCCL_STEPS} steps ({SCAN_WARMUP_STEPS} warm-up, the capture, replays): all_reduce "
        f"calls {calls}; losses {_losses(mesh_t)} vs no mesh {_losses(plain_t)} (rtol 1e-6) ok; "
        f"per replay: " + "; ".join(
            f"{name} {r['step_ms']:.4f} ms, {r['step_profile']['kernels']:.0f} device ops, NCCL "
            f"ops {nccl_ops[name]}, largest {r['step_profile']['top'][:2]}"
            for name, r in times.items()))
    return {name: {"step_ms": r["step_ms"], "device_ops": r["step_profile"]["kernels"],
                   "nccl_ops": nccl_ops[name]}
            for name, r in times.items()} | {"all_reduce_calls": calls}


def _replay_op_names(t):
    """The names of the device ops of one replay of ``t``'s captured step
    (torch.profiler), the step counter put back after it."""
    from torch.profiler import ProfilerActivity, profile

    t._scan.k.zero_()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t._graph.replay()
        torch.cuda.synchronize()
    t._scan.k.zero_()
    return {e.key for e in device_ops(prof)}


def _two_device_predictor(dev, stsr_ckpt, sr_dir):
    """SRPredictor over a two-device mesh (cuda:0 twice) at bucket 1024
    against the one-device predictor, f32 with TF32 off: rtol 1e-4."""
    from tactilesr_torch.parallel import make_mesh

    with np.load(os.path.join(sr_dir, "SRdataset_test.npz")) as z:
        lr = np.resize(z["LR"][:, :3], (DP_BUCKET, 3, 4, 4)).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(compute_dtype="float32", buckets=(DP_BUCKET,))
        two = SRPredictor(stsr_ckpt, mesh=make_mesh([dev, dev]), **kw)
        one = SRPredictor(stsr_ckpt, device=dev, **kw)
        check(two.buckets == (DP_BUCKET,) and len(two._replicas) == 2, "two replicas")
        got, want = two.predict(lr), one.predict(lr)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    log(f"[data_parallel] SRPredictor over [{dev}, {dev}] at bucket {DP_BUCKET} (two shards of "
        f"{DP_BUCKET // 2}), f32: max|d| {err:.3e} of max {float(np.abs(want).max()):.4g} against "
        "one device ok")
    return err


def phase_data_parallel(work, dev, sr_dir, raw, stsr_ckpt):
    """Data-parallel training and serving on the card (see the module
    docstring): 2 gloo ranks at full width against one process, the physics
    kernels per rank, a captured epoch over a one-rank NCCL group, a
    two-replica predictor.  Returns the tPSF launches (both ranks) and the
    readings."""
    d = os.path.join(work, "dp")
    os.makedirs(d)
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        lr, hr = z["LR"], z["HR"]
    paths = {}
    for name, rows in (("f32", DP_BATCH * DP_F32_STEPS), ("bf16", DP_BF16_ROWS)):
        paths[name] = os.path.join(d, f"train_{name}.npz")
        np.savez(paths[name], LR=lr[:rows], HR=hr[:rows])
    test = os.path.join(sr_dir, "SRdataset_test.npz")

    def sr_argv(name, save_dir, *extra):
        return ["--train_dataset_dir", paths[name], "--test_dataset_dir", test, "--save_dir",
                save_dir, "--epochs", "1", "--inference_test", "false", *extra]

    f32 = ("--compute_dtype", "float32", "--matmul_precision", "highest", "--warmup_t", "0",
           "--deterministic", "true")
    spec = {"dir": d, "f32_argv": sr_argv("f32", os.path.join(d, "f32"), *f32),
            "bf16_argv": sr_argv("bf16", os.path.join(d, "bf16")),
            "tpsf_argv": ["--dataset_dir", raw, "--save_dir", os.path.join(d, "tpsf"), "--epochs", "1",
                          "--inference_test", "false"]}
    spec_path = os.path.join(d, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    # the same f32 steps in this process first, then the ranks
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    clock, snaps = StepClock(), StepStates()
    try:
        one = sr_task._cli(sr_argv("f32", os.path.join(d, "f32_one"), *f32), hooks=[clock, snaps])
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags
    check(one.mesh is None and one.step == DP_F32_STEPS, "the one-process run")
    t0 = time.perf_counter()
    res = _run_ranks(spec_path)
    ranks_s = time.perf_counter() - t0

    states = [torch.load(os.path.join(d, f"f32_rank{r}.pt")) for r in range(DP_RANKS)]
    for which in ("after_1", "last"):
        for k, v in states[0][which].items():
            check(torch.equal(v, states[1][which][k]), f"the replicas differ ({which}): {k}")
    losses, want = res[0]["f32"]["losses"], _losses(one)[:-1]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    lr = one.config["lr"]
    stats_atol = _pre_bn_bias_stats_atol(lr, DP_F32_STEPS)
    f32_dev = {"after_1": _state_deviation(states[0]["after_1"], snaps.states[0], lr, 1,
                                           stats_atol=1e-5),
               "last": _state_deviation(states[0]["last"], snaps.states[-1], lr, DP_F32_STEPS,
                                        stats_atol=stats_atol)}
    launches = {k: sum(r["tpsf"]["launches"][k] for r in res.values()) for k in res[0]["tpsf"]["launches"]}
    step_ms = {"gloo_f32": float(np.median(res[0]["f32"]["step_ms"][1:])),
               "one_process_f32": float(np.median(clock.ms[1:])),
               "gloo_bf16": res[0]["bf16"]["step_ms"]}
    log(f"[data_parallel] {DP_RANKS} gloo ranks on {res[0]['device']} and {res[1]['device']}, full-width "
        f"STSR at B={DP_BATCH} ({DP_BATCH // DP_RANKS} rows a rank), {ranks_s:.1f} s for the ranks: "
        f"f32 losses {losses} vs one process {want} (rtol 1e-4); after step 1 and step "
        f"{DP_F32_STEPS} {f32_dev} (stats atol 1e-5, then {stats_atol:.3g}); replicas equal bit "
        f"for bit; bf16 epoch and resume "
        f"({res[0]['bf16']['steps']} steps, mean loss {res[0]['bf16']['mean_loss']:.6g}, eval "
        f"{res[0]['bf16']['eval']}), replicas' model and Adam state equal; tPSF epoch at B=256 "
        f"({res[0]['tpsf']['rows_per_rank']} rows a rank, {res[0]['tpsf']['steps']} steps) launches per "
        f"rank {[r['tpsf']['launches'] for r in res.values()]}; rank 0's seconds {res[0]['seconds']}")
    nccl = _nccl_one_rank(work, dev, sr_dir)
    pred_err = _two_device_predictor(dev, stsr_ckpt, sr_dir)
    step_ms.update({k: v["step_ms"] for k, v in nccl.items() if k != "all_reduce_calls"})
    log(f"[data_parallel] step ms (health readings, not targets): gloo ranks and one process host "
        f"clock per eager step, synced; NCCL and no-mesh replays CUDA events: {json.dumps(step_ms)}")
    return launches, dict(step_ms=step_ms, f32_state=f32_dev, predictor_max_abs=pred_err,
                          all_reduce_calls=nccl["all_reduce_calls"])


# captured-vs-eager f32 runs: the scan path's warm-up steps, the capture,
# then replays (2 for the parity check, 1 for remat)
SCAN_PARITY_STEPS = SCAN_WARMUP_STEPS + 2
REMAT_STEPS = SCAN_WARMUP_STEPS + 1
# captured vs eager bf16 stage-1 losses over 58 steps: the captured step runs
# capturable Adam (bias corrections on the device in f32), the eager loop the
# host-side form (in double), and the losses part by that rounding: 1.36e-3
# measured on an H100 80GB HBM3 at 700 W; the limit is about 3x that
STAGE1_CAPTURED_RTOL = 4e-3
CNN_EPOCHS = 1


def _sr_argv(work_dir, sr_dir, epochs, *extra):
    return ["--train_dataset_dir", os.path.join(sr_dir, "SRdataset_train.npz"),
            "--test_dataset_dir", os.path.join(sr_dir, "SRdataset_test.npz"),
            "--save_dir", work_dir, "--epochs", str(epochs), "--inference_test", "false", *extra]


def _losses(t):
    """The run's per-step losses its metric storage keeps (the last 20)
    and their mean over every step."""
    buf = t.metric_storage["total_loss"]
    return buf.state_dict()["values"] + [buf.global_avg]


def _max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _f32_sr_runs(work, dev, sr_dir, steps, variants):
    """``steps`` SRTrainer steps of the full-width f32 STSR at B=8 on the
    first 8 x steps generated samples (one epoch), one run per entry of
    ``variants`` (name -> trainer keywords, and ``hooks``), all from one
    seeded init, with ``matmul_precision: highest`` and cuDNN's
    deterministic algorithms.  A scan-mode run warms up as the recipes do
    (``SCAN_WARMUP_STEPS`` eager steps), then captures and replays the rest.

    Deterministic, because these runs are compared with each other: cuDNN's
    default convolution backward sums in an order that varies from run to
    run, and Adam turns that rounding, on elements whose true gradient lies
    under it (the pre-BN conv biases), into steps of about lr that the BN
    running means then carry."""
    cfg = dict(tactileSR_config, compute_dtype="float32", warmup_t=0,
               train_batch_size=SR_PARITY_BATCH, matmul_precision="highest")
    n = SR_PARITY_BATCH * steps
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        arrays = {"LR": z["LR"][:n], "HR": z["HR"][:n]}
    init = sr_task.build_model(cfg).state_dict()
    apply_matmul_precision(cfg)
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, kw in variants.items():
            kw = dict(kw)
            hooks = kw.pop("hooks", [])
            model = sr_task.build_model(cfg)
            model.load_state_dict(init)
            t = _sr_trainer(cfg, model, arrays, os.path.join(work, f"f32_{name}"), dev,
                            max_epochs=1, epoch_len=steps, **kw)
            t.register_hooks(hooks)
            t.train(auto_resume=False)
            check(t.step == steps, f"{name}: {t.step} steps")
            check(not kw.get("scan_epochs") or (t._graph is not None and steps > SCAN_WARMUP_STEPS),
                  f"{name}: no graph was captured and replayed")
            runs[name] = t
    finally:
        torch.backends.cudnn.deterministic = prev
    return cfg, runs


def _cpu_state(t):
    return {k: v.detach().cpu() for k, v in t.model.state_dict().items()}


def phase_sr_captured(work, dev, sr_dir):
    """(a) 5 f32 steps of the full-width STSR at B=8 from one init, cuDNN
    deterministic, captured (the recipes' 3 eager warm-up steps, the
    capture, two replays) against the eager loop with capturable Adam,
    which does the captured step's arithmetic: losses at rtol 1e-4, the
    state after step 5 by ``_state_deviation`` (BN statistics at atol
    5e-4); and against the
    eager loop as the recipes run it (host-side Adam): losses at rtol 1e-4.
    (b) the STSR recipe through its entry with ``--scan_epochs true`` for 2
    epochs (168 steps, bf16): ``_check_sr_run``'s checks."""
    cfg, runs = _f32_sr_runs(work, dev, sr_dir, SCAN_PARITY_STEPS, {
        "eager": {}, "eager_capturable": {"hooks": [CapturableAdam()]},
        "captured": {"scan_epochs": True}})
    eager, same, capt = runs["eager"], runs["eager_capturable"], runs["captured"]
    np.testing.assert_allclose(_losses(capt), _losses(same), rtol=1e-4)
    dev = _state_deviation(_cpu_state(capt), _cpu_state(same), cfg["lr"], SCAN_PARITY_STEPS,
                           stats_atol=5e-4)
    np.testing.assert_allclose(_losses(capt), _losses(eager), rtol=1e-4)
    rel, rel_same = _max_rel(_losses(capt), _losses(eager)), _max_rel(_losses(capt), _losses(same))
    log(f"[sr_captured] captured vs eager with capturable Adam, full-width f32 STSR, "
        f"{SCAN_PARITY_STEPS} steps at B={SR_PARITY_BATCH}, cuDNN deterministic: losses {_losses(capt)} vs {_losses(same)} "
        f"(max rel {rel_same:.3e}, rtol 1e-4); after step {SCAN_PARITY_STEPS} {dev} (stats atol 5e-4; "
        "parameters within 2 lr steps, at most 1% of their elements beyond 1e-5); vs the eager loop "
        f"(host-side Adam): losses {_losses(eager)} (max rel {rel:.3e}, rtol 1e-4) ok")

    clock, start = EpochClock(), StartState()
    t0 = time.perf_counter()
    trainer = sr_task._cli(_sr_argv(os.path.join(work, "stsr_captured"), sr_dir, SR_EPOCHS,
                                    "--scan_epochs", "true"), hooks=[clock, start])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(trainer.scan_epochs and trainer._graph is not None, "the STSR recipe captured no graph")
    check(trainer.model.dtype == torch.bfloat16, "the STSR does not compute in bf16")
    _check_sr_run("sr_captured", trainer, start.state, SR_EPOCHS * trainer.epoch_len)
    sps = trainer.n_train / clock.seconds[-1]
    log(f"[sr_captured] STSR recipe, --scan_epochs true: {SR_EPOCHS} epochs x {trainer.epoch_len} "
        f"steps in {wall:.2f} s (entry wall clock); epoch seconds {clock.seconds}; the last: "
        f"{sps:.1f} samples/s (host clock, card synced at both ends, eval and checkpoint included)")
    return trainer, dict(loss_rel=rel, loss_rel_capturable=rel_same, state=dev,
                         epoch_samples_per_s=sps)


def phase_training_captured(work, raw, eager):
    """Stage 1 through its entry with ``--scan_epochs true`` at the recipe's
    defaults for 2 epochs (58 steps): the graph holds both physics kernels,
    the backward kernel counts exactly one launch per step and each forward
    wrapper at least one.  The losses (the last 20 steps' and the mean over
    all 58) against those of an eager run with capturable Adam, which does
    the captured step's arithmetic, at rtol 1e-4; and against the eager
    run's (``eager``, the training phase) at ``STAGE1_CAPTURED_RTOL``."""
    save_dir = os.path.join(work, "tpsf_captured")
    argv = ["--dataset_dir", raw, "--save_dir", save_dir, "--epochs", str(TRAIN_EPOCHS),
            "--inference_test", "false", "--scan_epochs", "true"]
    clock = EpochClock()
    tcuda.reset_launch_counts()
    trainer = tpsf_task._cli(argv, hooks=[clock])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    steps = trainer.step
    check(steps == TRAIN_EPOCHS * trainer.epoch_len, f"{steps} optimizer steps")
    check(trainer._graph is not None and trainer._graph.per_replay.get("tpsf_physics_bwd") == 1,
          f"the stage-1 graph records {trainer._graph and trainer._graph.per_replay} kernel launches")
    check(launches["tpsf_physics_bwd"] == steps,
          f"tpsf_physics_bwd launched {launches['tpsf_physics_bwd']} times in {steps} captured steps")
    for name in ("tpsf_physics", "tpsf_physics_fused"):
        check(launches[name] >= steps, f"{name} launched {launches[name]} times in {steps} steps")
    got, want = _losses(trainer), _losses(eager)
    check(len(trainer.metric_storage["total_loss"]) == len(eager.metric_storage["total_loss"]) == steps
          and np.isfinite(got).all(), f"{len(trainer.metric_storage['total_loss'])} captured losses")
    same = tpsf_task._cli(["--dataset_dir", raw, "--save_dir", os.path.join(work, "tpsf_capturable"),
                           "--epochs", str(TRAIN_EPOCHS), "--inference_test", "false"],
                          hooks=[CapturableAdam()])
    rel_same = _max_rel(got, _losses(same))
    check(rel_same <= 1e-4, f"captured vs eager (capturable Adam) stage-1 losses: max rel {rel_same:.3e}")
    rel = _max_rel(got, want)
    check(rel <= STAGE1_CAPTURED_RTOL,
          f"captured vs eager stage-1 losses: max rel {rel:.3e} > {STAGE1_CAPTURED_RTOL}")
    sps = trainer.n_train / clock.seconds[-1]
    log(f"[training_captured] {steps} captured steps (graph launches per replay "
        f"{trainer._graph.per_replay}); launches {launches}; losses vs an eager run with capturable "
        f"Adam max rel {rel_same:.3e} (rtol 1e-4), vs the eager run max rel {rel:.3e} (rtol "
        f"{STAGE1_CAPTURED_RTOL}); epoch seconds {clock.seconds}, the last {sps:.1f} samples/s ok")
    return trainer, launches, dict(loss_rel=rel, loss_rel_capturable=rel_same, epoch_samples_per_s=sps)


def phase_remat(work, dev, sr_dir):
    """4 f32 steps of the full-width STSR at B=8 with ``remat`` against
    without, eager and captured (3 warm-up steps, the capture, a replay),
    cuDNN deterministic: the BN statistics and
    num_batches_tracked equal (atol 1e-6 on the statistics; the undone
    recompute leaves them bit for bit), the losses at rtol 1e-5."""
    out = {}
    _, runs = _f32_sr_runs(work, dev, sr_dir, REMAT_STEPS, {
        "eager": {}, "eager_remat": {"remat": True},
        "captured": {"scan_epochs": True}, "captured_remat": {"scan_epochs": True, "remat": True}})
    for mode in ("eager", "captured"):
        plain, remat = _cpu_state(runs[mode]), _cpu_state(runs[f"{mode}_remat"])
        np.testing.assert_allclose(_losses(runs[f"{mode}_remat"]), _losses(runs[mode]), rtol=1e-5)
        worst = 0.0
        for k, v in plain.items():
            if k.endswith("num_batches_tracked"):
                check(int(remat[k]) == int(v) == REMAT_STEPS,
                      f"{mode} remat: {k} {int(remat[k])} vs {int(v)}")
            elif k.endswith(("running_mean", "running_var")):
                worst = max(worst, float((remat[k] - v).abs().max()))
        check(worst <= 1e-6, f"{mode} remat: BN statistics max|d| {worst:.3e}")
        out[mode] = dict(stats_max_abs=worst, loss_rel=_max_rel(_losses(runs[f"{mode}_remat"]),
                                                                 _losses(runs[mode])))
        log(f"[remat] {mode}: {REMAT_STEPS} f32 steps with remat vs without: BN statistics max|d| "
            f"{worst:.3e}, num_batches_tracked equal, losses max rel {out[mode]['loss_rel']:.3e} "
            "(rtol 1e-5) ok")
    return out


def phase_cnn(work, dev, sr_dir):
    """TactileSRCNN through the STSR entry (``--model_arch TactileSRCNN
    --scan_epochs true``, the recipe's defaults: scale 10, 6 MSRB, B=32,
    bf16) for CNN_EPOCHS epochs, captured; then its ``latest.pth`` served
    by ``SRPredictor(model_arch="TactileSRCNN")``, bf16 and fused, against
    its own f32 eval forward at ``phase_serving_trained``'s rule, and fused
    f32 against unfused f32 at F32_RTOL."""
    clock, start = EpochClock(), StartState()
    trainer = sr_task._cli(_sr_argv(os.path.join(work, "cnn"), sr_dir, CNN_EPOCHS,
                                    "--model_arch", "TactileSRCNN", "--scan_epochs", "true"),
                           hooks=[clock, start])
    torch.cuda.synchronize()
    check(isinstance(trainer.model, TactileSRCNN) and len(trainer.model.msrb_layer) == 6,
          f"not the full-width CNN: {type(trainer.model).__name__}")
    check(trainer.model.dtype == torch.bfloat16 and trainer._graph is not None,
          "the CNN did not train captured in bf16")
    _check_sr_run("cnn", trainer, start.state, CNN_EPOCHS * trainer.epoch_len)
    ckpt = os.path.join(work, "cnn", "checkpoints", "latest.pth")

    apply_matmul_precision({"matmul_precision": "highest"})
    with np.load(os.path.join(sr_dir, "SRdataset_test.npz")) as z:
        lr = np.ascontiguousarray(z["LR"][:, :3])
    x = torch.from_numpy(lr)

    def model(dtype):
        m = TactileSRCNN(dtype=dtype)
        m.load_state_dict(load_checkpoint_file(ckpt)["model"], strict=True)
        return m

    sr = SRPredictor(ckpt, model_arch="TactileSRCNN").predict(lr)
    check(sr.shape == (lr.shape[0], 1, 40, 40) and np.isfinite(sr).all(), f"CNN served {sr.shape}")
    ref = _unfused_f32(model(torch.float32), x, dev).cpu().numpy()
    own = _unfused_f32(model(torch.bfloat16), x, dev).cpu().numpy()
    fused32 = SRPredictor(ckpt, model_arch="TactileSRCNN", compute_dtype="float32").predict(lr)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(fused32, ref, rtol=F32_RTOL, atol=F32_ATOL_REL * max(scale, 1e-12))
    err, own_err = float(np.abs(sr - ref).max()), float(np.abs(own - ref).max())
    limit = max(BF16_REL * scale, 2 * own_err)
    served = dict(frames=lr.shape[0], ref_max=scale, bf16_max_abs=err, own_bf16_max_abs=own_err,
                  fused_f32_max_abs=float(np.abs(fused32 - ref).max()))
    log(f"[cnn] trained TactileSRCNN served, {lr.shape[0]} test frames: fused f32 vs unfused f32 "
        f"max|d|={served['fused_f32_max_abs']:.3e} (rtol {F32_RTOL}, atol {F32_ATOL_REL} x ref max) ok; "
        f"served bf16 vs f32 eval max|d|={err:.4g}, the model's own bf16 eval forward {own_err:.4g}, "
        f"ref max {scale:.4g}; limit {limit:.4g} = max({BF16_REL} x ref max, 2 x its own)")
    check(err <= limit, f"CNN: bf16 max|d|={err:.4g} > {limit:.4g}")
    return trainer, dict(served=served, epoch_samples_per_s=trainer.n_train / clock.seconds[-1])


def phase_profiler(work, dev, sr_dir):
    """ProfilerHook over iterations 1-3 of an eager run of the full-width
    STSR (B=8, 5 steps, bf16): the Chrome trace it writes holds the card's
    kernels by name."""
    cfg = dict(tactileSR_config, warmup_t=0, train_batch_size=SR_PARITY_BATCH)
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        arrays = {"LR": z["LR"][:5 * SR_PARITY_BATCH], "HR": z["HR"][:5 * SR_PARITY_BATCH]}
    model = sr_task.build_model(cfg)
    t = _sr_trainer(cfg, model, arrays, os.path.join(work, "profiled"), dev, max_epochs=1,
                    epoch_len=5)
    hook = ProfilerHook(os.path.join(work, "trace"), start_iter=1, num_iters=3)
    t.register_hooks([hook])
    t.train(auto_resume=False)
    check(hook.trace_path is not None and os.path.exists(hook.trace_path), "no trace written")
    with open(hook.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, "the trace names no CUDA kernel")
    check(any("cudnn" in k or "conv" in k.lower() for k in kernels), "the trace holds no convolution")
    log(f"[profiler] ProfilerHook trace of iterations 1-3: {len(events)} events, {len(kernels)} CUDA "
        f"kernels ({len(set(kernels))} names), e.g. {sorted(set(kernels))[:2]} ok")
    return len(kernels)


def phase_generation_seqs(work, dev, raw, ckpt):
    out_dir = os.path.join(work, "SeqsDataset")
    tcuda.reset_launch_counts()
    generate._cli(["seqs", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir", out_dir,
                   "--sample-cnt", str(tPSFNet_config["sample_cnt"]), "--n-contacts", "3",
                   "--n-translations", "9", "--batch", str(MAIN_BATCH)])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    check(launches["tpsf_physics"] > 0, f"generate seqs launched no tpsf_physics: {launches}")
    sizes = {}
    for split, n_want in (("train", 672), ("validation", 96), ("test", 96)):
        with np.load(os.path.join(out_dir, f"SRdataset_{split}_32.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        n = sizes[split] = arrays["LR"].shape[0]
        check(n == n_want, f"seqs split {split} has {n} rows, expected {n_want}")
        check(arrays["LR"].shape == (n, 21, 4, 4) and arrays["HR"].shape == (n, 1, 100, 100),
              f"seqs {split} shapes {arrays['LR'].shape} {arrays['HR'].shape}")
        for k, v in arrays.items():
            check(np.isfinite(v).all(), f"seqs {split}/{k} has non-finite values")
    with np.load(os.path.join(out_dir, "SRdataset_test_32.npz")) as z:
        # the HR comes from the 30-degree frame, the first 3 channels
        _plain_physics_check(ckpt, dev, np.ascontiguousarray(z["LR"][:, :3]), z["depth"], z["HR"])
    log(f"[seqs] generate seqs: {sizes} rows, tpsf_physics launches={launches['tpsf_physics']}; "
        "the test split's HR matches the plain physics (rtol/atol 1e-4) ok")
    return launches, out_dir


def phase_mtsr_training(work, seqs_dir, stsr_ckpt):
    """One epoch of the full-width MTSR through its entry, warm-started
    from the STSR checkpoint; the trunk it starts from is the checkpoint's."""
    save_dir = os.path.join(work, "mtsr")
    argv = ["--train_dataset_dir", os.path.join(seqs_dir, "SRdataset_train_32.npz"),
            "--test_dataset_dir", os.path.join(seqs_dir, "SRdataset_test_32.npz"),
            "--save_dir", save_dir, "--epochs", "1", "--inference_test", "false",
            "--load_checkpoint_dir", stsr_ckpt]
    trunk = {k: v for k, v in load_checkpoint_file(stsr_ckpt)["model"].items()
             if k.startswith(sr_task.TRUNK_PREFIXES)}
    clock, start = EpochClock(), StartState(trunk)
    trainer = sr_seqs_task._cli(argv, hooks=[clock, start])
    torch.cuda.synchronize()
    cfg = trainer.config
    check((cfg["seqsCnt"], cfg["lr"], trainer.model.dtype) ==
          (tactileSeqs_config["seqsCnt"], tactileSeqs_config["lr"], torch.bfloat16),
          f"not the seqs recipe: {cfg['seqsCnt']} {cfg['lr']} {trainer.model.dtype}")
    check(trainer.lr_schedule.warmup_t == 0, "the seqs recipe got a warmup")
    check(trainer.epoch_len == 21, f"{trainer.epoch_len} MTSR steps per epoch, expected 21")
    check(len(trunk) > 0 and start.trunk_mismatch == [],
          f"the MTSR trunk differs from the STSR checkpoint in {start.trunk_mismatch}")
    log(f"[seqs] the MTSR started from the STSR trunk bit for bit ({len(trunk)} tensors)")
    # the transferred num_batches_tracked start at the STSR's count
    _check_sr_run("seqs", trainer, start.state, trainer.epoch_len)
    sps = trainer.n_train / clock.seconds[-1]
    log(f"[seqs] MTSR epoch: {trainer.n_train} rows in {trainer.epoch_len} steps, "
        f"{clock.seconds[-1]:.4f} s = {sps:.1f} samples/s (host clock, card synced at both ends)")
    return trainer, os.path.join(save_dir, "checkpoints", "latest.pth"), sps


def _trained_model(ckpt, seqs_cnt, dtype=torch.float32):
    model = TactileSR(scale_factor=10, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=6,
                      force_feature_extra_layer_cnt=1, dtype=dtype)
    model.load_state_dict(load_checkpoint_file(ckpt)["model"], strict=True)
    return model


def _argmax_at(d):
    """The (row, channel, y, x) of the largest |d|."""
    return [int(i) for i in np.unravel_index(np.argmax(np.abs(d)), d.shape)]


def phase_serving_trained(dev, stsr_ckpt, sr_dir, mtsr_ckpt, seqs_dir):
    """Both trained checkpoints through SRPredictor (bf16, fused, the default
    buckets) on their test splits, against their own f32 eval forward.  The
    fold must be exact (fused f32 vs unfused f32 at F32_RTOL), and the
    served bf16 output within BF16_REL of the output range, or, where the
    model's own bf16 eval forward already strays further (BatchNorm
    subtracting running means much larger than the spread, so bf16's
    relative rounding of the conv output is magnified), within twice that
    stray.  f32 here means no TF32 (``matmul_precision: highest``)."""
    apply_matmul_precision({"matmul_precision": "highest"})
    out = {}
    for name, ckpt, path, seqs_cnt in (
            ("STSR", stsr_ckpt, os.path.join(sr_dir, "SRdataset_test.npz"), 1),
            ("MTSR", mtsr_ckpt, os.path.join(seqs_dir, "SRdataset_test_32.npz"), 7)):
        with np.load(path) as z:
            lr = np.ascontiguousarray(z["LR"][:, :3 * seqs_cnt])
        x = torch.from_numpy(lr)
        sr = SRPredictor(ckpt, seqs_cnt=seqs_cnt).predict(lr)
        check(sr.shape == (lr.shape[0], 1, 40, 40) and np.isfinite(sr).all(), f"{name}: {sr.shape}")
        ref = _unfused_f32(_trained_model(ckpt, seqs_cnt), x, dev).cpu().numpy()
        own = _unfused_f32(_trained_model(ckpt, seqs_cnt, torch.bfloat16), x, dev).cpu().numpy()
        fused32 = SRPredictor(ckpt, seqs_cnt=seqs_cnt, compute_dtype="float32").predict(lr)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(fused32, ref, rtol=F32_RTOL, atol=F32_ATOL_REL * max(scale, 1e-12))
        err, own_err = float(np.abs(sr - ref).max()), float(np.abs(own - ref).max())
        rms = float(np.sqrt(np.mean((sr - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)), 1e-12))
        if scale == 0:  # the last ReLU closed at every pixel: served, the zeros must stay zeros
            log(f"[serving] trained {name}: its f32 eval forward is all zero (under the running "
                "statistics every pre-activation of the last ReLU is negative); the served "
                "output must be zero too")
        limit = max(BF16_REL * scale, 2 * own_err)
        out[name] = dict(frames=lr.shape[0], ref_max=scale, bf16_max_abs=err, bf16_rel_rms=rms,
                         own_bf16_max_abs=own_err, bf16_at=_argmax_at(sr - ref),
                         own_bf16_at=_argmax_at(own - ref),
                         fused_f32_max_abs=float(np.abs(fused32 - ref).max()))
        log(f"[serving] trained {name} ({os.path.basename(os.path.dirname(os.path.dirname(ckpt)))}"
            f"/latest.pth), {lr.shape[0]} test frames: fused f32 vs unfused f32 max|d|="
            f"{out[name]['fused_f32_max_abs']:.3e} (rtol {F32_RTOL}, atol {F32_ATOL_REL} x ref max) ok; "
            f"served bf16 vs f32 eval max|d|={err:.4g} (relative RMS {rms:.3e}), the model's own "
            f"bf16 eval forward {own_err:.4g}, ref max {scale:.4g}; limit {limit:.4g} = max({BF16_REL} "
            "x ref max, 2 x its own)")
        check(err <= limit, f"trained {name}: bf16 max|d|={err:.4g} > {limit:.4g}")
    return out


def _stsr(seed, pattern_layers=6, seqs_cnt=1):
    """Seeded full-width TactileSR (STSR, or MTSR for ``seqs_cnt`` > 1) with
    BN running stats drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    m = TactileSR(scale_factor=10, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=pattern_layers,
                  force_feature_extra_layer_cnt=1, generator=g)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.3 * torch.randn(mod.num_features, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.num_features, generator=g))
    return m


def _unfused_f32(model, x, dev, chunk=256):
    """The eval forward of ``model`` over ``x`` in chunks (f32 when the
    caller applied ``matmul_precision: highest``)."""
    check(not torch.backends.cudnn.allow_tf32, "an f32 reference with cuDNN in TF32")
    model = model.to(dev).eval()
    with torch.no_grad():
        return torch.cat([model(x[i:i + chunk].to(dev)) for i in range(0, x.shape[0], chunk)])


def phase_serving(work, dev, test_lr, n_big=1500):
    apply_matmul_precision({"matmul_precision": "highest"})  # the f32 references below
    model = _stsr(seed=11)
    ckpt = save_checkpoint_file(os.path.join(work, "stsr_a.pth"), model.state_dict())
    ckpt_b = save_checkpoint_file(os.path.join(work, "stsr_b.pth"), _stsr(seed=12).state_dict())
    ckpt_5 = save_checkpoint_file(os.path.join(work, "stsr_5.pth"),
                                  _stsr(seed=13, pattern_layers=5).state_dict())

    pred = SRPredictor(ckpt)  # the defaults: fused, bf16, buckets (1, 8, 64, 256, 1024), cuda
    pred.warmup()
    g = torch.Generator().manual_seed(5)
    requests = {
        "test split": test_lr.astype(np.float32),
        "one frame": (torch.rand(1, 3, 4, 4, generator=g) * 4).numpy(),
        "big request": (torch.rand(n_big, 3, 4, 4, generator=g) * 4).numpy(),
    }
    worst = 0.0
    for name, lr in requests.items():
        sr = pred.predict(lr)
        check(sr.shape == (lr.shape[0], 1, 40, 40), f"{name}: shape {sr.shape}")
        check(np.isfinite(sr).all(), f"{name}: non-finite output")
        ref = _unfused_f32(model, torch.from_numpy(lr), dev).cpu().numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(sr - ref).max())
        worst = max(worst, err / max(scale, 1e-12))
        check(scale > 0, f"{name}: the reference output is all zero")
        check(err <= BF16_REL * scale, f"{name}: bf16 max|d|={err:.4g} > {BF16_REL}*{scale:.4g}")
        log(f"[serving] {name}: {lr.shape[0]} frames, bf16 vs f32 eval max|d|={err:.4g} "
            f"(ref max {scale:.4g}, limit {BF16_REL} x ref max) ok")

    # fused f32 graph vs the unfused f32 eval forward
    x = torch.from_numpy(requests["big request"][:256]).to(dev)
    folded = fold_inference_params(model.state_dict(), dtype=torch.float32, device=dev)
    fused = tactile_sr_infer(folded, x)
    ref = _unfused_f32(model, x, dev)
    atol = F32_ATOL_REL * float(ref.abs().max())
    torch.testing.assert_close(fused, ref, rtol=F32_RTOL, atol=atol)
    log(f"[serving] fused f32 vs unfused f32: max|d|={float((fused - ref).abs().max()):.3e} "
        f"(rtol {F32_RTOL}, atol {atol:.3e}) ok")

    # hot swap to a second seed; a 5-MSRB bundle is refused, old weights serve
    probe = requests["test split"]
    before = pred.predict(probe)
    pred.reload_checkpoint(ckpt_b)
    swapped = pred.predict(probe)
    check(not np.allclose(swapped, before), "reload_checkpoint did not change the output")
    try:
        pred.reload_checkpoint(ckpt_5)
    except (KeyError, ValueError) as e:
        log(f"[serving] pattern_layers=5 bundle refused: {type(e).__name__}")
    else:
        raise AssertionError("a pattern_layers=5 bundle was accepted by a 6-MSRB predictor")
    check(np.array_equal(pred.predict(probe), swapped), "refused reload changed the weights")
    log("[serving] hot swap ok; refusal keeps the old weights serving")
    return pred


SERVER_CLIENTS, SERVER_REQUESTS, SERVER_MAX_FRAMES = 32, 8, 64
SERVER_F32_CLIENTS, SERVER_F32_REQUESTS = 16, 4


def _http(url, body=None, ctype="application/x-npz"):
    """(status, body, headers) of one request; an HTTP error status is
    returned, not raised."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _sr_of(body):
    with np.load(io.BytesIO(body)) as z:
        return z["SR"]


def _plans(rng, n_rows, clients, requests):
    """Each client's requests: row indices of 1-SERVER_MAX_FRAMES rows."""
    return [[rng.choice(n_rows, int(rng.integers(1, SERVER_MAX_FRAMES + 1)), replace=False)
             for _ in range(requests)] for _ in range(clients)]


def _clients(base, pool, plans):
    """One thread per plan sends its requests to /predict in turn: every
    (row indices, SR rows) answered, and the wall clock of the whole."""
    def client(plan):
        got = []
        for idx in plan:
            status, body, _ = _http(base + "/predict", _npz(LR=pool[idx]))
            check(status == 200, f"/predict answered {status}: {body[:200]!r}")
            got.append((idx, _sr_of(body)))
        return got

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(plans)) as ex:
        results = [r for f in [ex.submit(client, plan) for plan in plans] for r in f.result()]
    return results, time.perf_counter() - t0


def _serve(ckpt, **kw):
    """``create_server(ckpt, port=0, **kw)`` serving from a thread: the
    server, the thread and the base URL."""
    srv = create_server(ckpt, port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, "http://%s:%d" % srv.server_address


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    srv.batcher.shutdown()
    thread.join(10)
    check(not thread.is_alive(), "the server thread did not stop")


def phase_server(work, dev, stsr_ckpt, sr_dir):
    """The trained full-width STSR (the sr phase's ``latest.pth``) behind
    ``tactilesr_torch.server`` on a loopback port, at the predictor's and
    the CLI's defaults (bf16, fused, buckets 1-1024, linger 2 ms, 8192
    queued frames, 10 s deadline).  SERVER_CLIENTS threads send
    SERVER_REQUESTS requests each of 1-SERVER_MAX_FRAMES test-split rows
    (seeded); every response must lie within ``phase_serving_trained``'s
    limit of the f32 eval forward on its rows; the JSON route must return
    the npz route's rows; /reload to a second seeded bundle gives 200, a
    5-MSRB one 409 with the old weights serving; a burst past a small
    ``max_queue_frames`` gets 429 with Retry-After, an oversized request
    413.  HTTP frames/s, frames per dispatch and latency percentiles are
    health readings.  Then a shorter pass in f32 (SERVER_F32_CLIENTS
    clients): every response within F32_RTOL of the f32 eval forward on its
    rows, so that a fault in how the batcher orders or slices coalesced
    rows fails at f32's tolerance, not only at bf16's."""
    apply_matmul_precision({"matmul_precision": "highest"})
    with np.load(os.path.join(sr_dir, "SRdataset_test.npz")) as z:
        pool = np.ascontiguousarray(z["LR"][:, :3])
    x = torch.from_numpy(pool)
    ref = _unfused_f32(_trained_model(stsr_ckpt, 1), x, dev).cpu().numpy()
    own = _unfused_f32(_trained_model(stsr_ckpt, 1, torch.bfloat16), x, dev).cpu().numpy()
    scale, own_err = float(np.abs(ref).max()), float(np.abs(own - ref).max())
    limit = max(BF16_REL * scale, 2 * own_err)
    ckpt_b = save_checkpoint_file(os.path.join(work, "server_b.pth"), _stsr(seed=31).state_dict())
    ckpt_5 = save_checkpoint_file(os.path.join(work, "server_5.pth"),
                                  _stsr(seed=32, pattern_layers=5).state_dict())

    srv, thread, base = _serve(stsr_ckpt, max_queue_frames=8192, deadline_ms=10_000.0)
    out = {}
    try:
        status, body, _ = _http(base + "/healthz")
        health = json.loads(body)
        check(status == 200 and health["buckets"] == list(DEFAULT_BUCKETS) and health["fused"]
              and health["branch_mode"] == "per_seq", f"/healthz: {status} {health}")
        rng = np.random.default_rng(17)
        stats0 = json.loads(_http(base + "/stats")[1])
        results, wall = _clients(base, pool, _plans(rng, len(pool), SERVER_CLIENTS, SERVER_REQUESTS))
        stats = json.loads(_http(base + "/stats")[1])
        frames = sum(len(idx) for idx, _ in results)
        worst = max(float(np.abs(sr - ref[idx]).max()) for idx, sr in results)
        check(all(sr.shape == (len(idx),) + ref.shape[1:] and np.isfinite(sr).all() for idx, sr in results),
              "a response of the wrong shape or not finite")
        check(worst <= limit, f"served over HTTP: max|d|={worst:.4g} > {limit:.4g}")
        batches = stats["batches"] - stats0["batches"]
        out = dict(requests=len(results), frames=frames, seconds=wall, frames_per_s=frames / wall,
                   dispatches=batches, frames_per_dispatch=frames / batches,
                   avg_frames_per_dispatch=stats["avg_frames_per_dispatch"],
                   latency_ms=stats["latency_ms"], max_coalesced_requests=stats["max_coalesced_requests"],
                   max_abs=worst, limit=limit, ref_max=scale, own_bf16_max_abs=own_err)
        log(f"[server] {SERVER_CLIENTS} clients x {SERVER_REQUESTS} requests, {frames} frames in "
            f"{wall:.3f} s: {frames / wall:.1f} frames/s over HTTP (host clock), {batches} dispatches "
            f"({frames / batches:.2f} frames each; /stats avg_frames_per_dispatch "
            f"{stats['avg_frames_per_dispatch']}, up to {stats['max_coalesced_requests']} requests "
            f"coalesced), latency p50/p95/p99 {stats['latency_ms']['p50']}/{stats['latency_ms']['p95']}/"
            f"{stats['latency_ms']['p99']} ms; bf16 vs f32 eval max|d|={worst:.4g}, limit {limit:.4g} = "
            f"max({BF16_REL} x ref max {scale:.4g}, 2 x the model's own bf16 stray {own_err:.4g}) ok")

        rows = pool[:5]
        _, body, _ = _http(base + "/predict", _npz(LR=rows))
        status, jbody, _ = _http(base + "/predict", json.dumps({"lr": rows.tolist()}).encode(),
                                 "application/json")
        check(status == 200 and np.array_equal(np.asarray(json.loads(jbody)["sr"], np.float32), _sr_of(body)),
              "the JSON route's rows differ from the npz route's")

        def reload(path):
            return _http(base + "/reload", json.dumps({"checkpoint": path}).encode(), "application/json")

        status, _, _ = reload(ckpt_b)
        swapped = _sr_of(_http(base + "/predict", _npz(LR=rows))[1])
        check(status == 200 and not np.allclose(swapped, _sr_of(body)), f"/reload answered {status}")
        status, rbody, _ = reload(ckpt_5)
        check(status == 409 and json.loads(rbody)["serving"] == "previous weights",
              f"a 5-MSRB bundle: /reload answered {status}")
        check(np.array_equal(_sr_of(_http(base + "/predict", _npz(LR=rows))[1]), swapped),
              "a refused reload changed the weights")
        check(json.loads(_http(base + "/healthz")[1])["checkpoint"] == ckpt_b, "/healthz checkpoint")

        b = srv.batcher
        real = b.predictor.predict

        def held(arr):  # keep the worker busy long enough for the burst to queue
            time.sleep(0.25)
            return real(arr)

        b.max_queue_frames, b.predictor.predict = 64, held
        try:
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                burst = list(ex.map(lambda _: _http(base + "/predict", _npz(LR=pool[:40])), range(8)))
            codes = sorted(c for c, _, _ in burst)
            retry = [h.get("Retry-After") for c, _, h in burst if c == 429]
            check(429 in codes and all(r is not None and int(r) >= 1 for r in retry),
                  f"a burst past max_queue_frames=64: {codes}, Retry-After {retry}")
            status, _, headers = _http(base + "/predict", _npz(LR=pool[:65]))
            check(status == 413 and headers.get("Retry-After") is None, f"an oversized request: {status}")
        finally:
            b.max_queue_frames, b.predictor.predict = 8192, real
        out.update(burst_codes=codes)
        log(f"[server] JSON rows == npz rows; /reload 200 then 409 (old weights serve); burst of 8 x 40 "
            f"frames at max_queue_frames=64: {codes} (Retry-After {retry}); 65 frames: 413")
    finally:
        _stop(srv, thread)

    srv, thread, base = _serve(stsr_ckpt, compute_dtype="float32", deadline_ms=10_000.0)
    try:
        results, _ = _clients(base, pool, _plans(np.random.default_rng(18), len(pool),
                                                 SERVER_F32_CLIENTS, SERVER_F32_REQUESTS))
        stats = json.loads(_http(base + "/stats")[1])
    finally:
        _stop(srv, thread)
    for idx, sr in results:
        np.testing.assert_allclose(sr, ref[idx], rtol=F32_RTOL, atol=F32_ATOL_REL * scale)
    check(stats["max_coalesced_requests"] > 1, f"f32 pass: no request was coalesced: {stats}")
    f32_err = max(float(np.abs(sr - ref[idx]).max()) for idx, sr in results)
    out.update(f32=dict(requests=len(results), frames=sum(len(idx) for idx, _ in results),
                        dispatches=stats["batches"], max_coalesced_requests=stats["max_coalesced_requests"],
                        max_abs=f32_err))
    log(f"[server] f32: {SERVER_F32_CLIENTS} clients x {SERVER_F32_REQUESTS} requests "
        f"({out['f32']['frames']} frames, {stats['batches']} dispatches, up to "
        f"{stats['max_coalesced_requests']} requests coalesced): every response within rtol {F32_RTOL} / "
        f"atol {F32_ATOL_REL} x ref max of the f32 eval forward on its rows, max|d|={f32_err:.3e} ok")
    return out


MTSR_SEQS = 7
MTSR_TIMED = {1: 50, 8: 50, 64: 20, 256: 8, 1024: 3}  # bucket: timed forwards a round


def phase_serving_mtsr(work, dev):
    """A seeded full-width MTSR (S=7, 6 MSRB, BN statistics from the seed)
    served in every branch layout: f32 against the unfused f32 eval forward
    at F32_RTOL, bf16 within BF16_REL of the range; ``auto`` serves
    ``grouped`` at every bucket (its rows equal that pinned layout's); each
    layout's bf16 device forward timed at every default bucket (CUDA
    events, two rounds in turns), with the smallest bucket from which
    ``grouped`` is no slower than ``per_seq`` (1 keeps ``auto`` as it is);
    then ``export_program`` of a seeded STSR at bucket 256, bf16 and f32,
    reloaded and held against the forward."""
    apply_matmul_precision({"matmul_precision": "highest"})
    model = _stsr(seed=41, seqs_cnt=MTSR_SEQS)
    ckpt = save_checkpoint_file(os.path.join(work, "mtsr_seeded.pth"), model.state_dict())
    g = torch.Generator().manual_seed(43)
    lr = (torch.rand(DEFAULT_BUCKETS[-1] + 300, 3 * MTSR_SEQS, 4, 4, generator=g) * 4).numpy()
    probe = lr[:300]  # 256 + 44 (padded to 64): both sides of any crossover
    ref = _unfused_f32(model, torch.from_numpy(probe), dev).cpu().numpy()
    scale = float(np.abs(ref).max())
    check(scale > 0 and np.count_nonzero(ref) > ref.size // 10, "the seeded MTSR's output is zero")
    bf16 = {}
    errs = {}
    for mode in BRANCH_MODES:
        f32 = SRPredictor(ckpt, seqs_cnt=MTSR_SEQS, compute_dtype="float32", branch_mode=mode)
        got = f32.predict(probe)
        np.testing.assert_allclose(got, ref, rtol=F32_RTOL, atol=F32_ATOL_REL * scale)
        bf16[mode] = SRPredictor(ckpt, seqs_cnt=MTSR_SEQS, branch_mode=mode)
        bf16[mode].warmup()
        served = bf16[mode].predict(probe)
        err = float(np.abs(served - ref).max())
        check(served.shape == ref.shape and err <= BF16_REL * scale,
              f"MTSR {mode} bf16: max|d|={err:.4g} > {BF16_REL} x {scale:.4g}")
        errs[mode] = dict(f32_max_abs=float(np.abs(got - ref).max()), bf16_max_abs=err)
    log(f"[serving_mtsr] seeded MTSR (S={MTSR_SEQS}, 6 MSRB), {len(probe)} frames, ref max {scale:.4g}: "
        f"every layout f32 vs unfused f32 within rtol {F32_RTOL} / atol {F32_ATOL_REL} x ref max, bf16 "
        f"within {BF16_REL} x ref max: {errs}")

    auto = SRPredictor(ckpt, seqs_cnt=MTSR_SEQS)
    check(auto.branch_mode == "grouped", f"auto resolved to {auto.branch_mode}")
    for b in DEFAULT_BUCKETS:
        check(np.array_equal(auto.predict(lr[:b]), bf16["grouped"].predict(lr[:b])),
              f"auto at bucket {b} != grouped's rows")
    log("[serving_mtsr] auto served every bucket in grouped")

    times = {mode: {b: [] for b in DEFAULT_BUCKETS} for mode in BRANCH_MODES}
    for rnd in (BRANCH_MODES, BRANCH_MODES[::-1]):
        for b in DEFAULT_BUCKETS:
            x = torch.from_numpy(lr[:b]).to(dev)
            for mode in rnd:
                pred = bf16[mode]
                w = pred._weights
                times[mode][b].append(cuda_ms(lambda: pred._forward(w, x), MTSR_TIMED[b], warmup=2))
    best = {mode: {b: min(t) for b, t in row.items()} for mode, row in times.items()}
    measured = next((b for b in DEFAULT_BUCKETS
                     if all(best["grouped"][c] <= best["per_seq"][c] for c in DEFAULT_BUCKETS if c >= b)),
                    None)
    for mode in BRANCH_MODES:
        log(f"[serving_mtsr] {mode:8s} bf16 forward ms at buckets {list(DEFAULT_BUCKETS)}: "
            + ", ".join(f"{best[mode][b]:.4f} ({'/'.join(f'{t:.4f}' for t in times[mode][b])})"
                        for b in DEFAULT_BUCKETS))
    log(f"[serving_mtsr] smallest bucket from which grouped is no slower than per_seq at every larger "
        f"one: {measured} (auto serves grouped at every bucket); fastest layout per bucket: "
        f"{ {b: min(BRANCH_MODES, key=lambda m: best[m][b]) for b in DEFAULT_BUCKETS} }")

    stsr = _stsr(seed=44)
    sckpt = save_checkpoint_file(os.path.join(work, "export_stsr.pth"), stsr.state_dict())
    x = torch.from_numpy(lr[:256, :3]).to(dev)
    exported = {}
    for dtype in ("bfloat16", "float32"):
        path = export_program(sckpt, os.path.join(work, f"stsr_{dtype}.pt2"), batch=256,
                              compute_dtype=dtype)
        program = torch.export.load(path)
        got = program.module()(x)
        shapes = [tuple(c.shape) for c in program.constants.values()]
        check(shapes == [(got.shape[-1], 4)], f"the exported program's constants: {shapes} (the resize "
              "matrix only)")
        pred = SRPredictor(sckpt, compute_dtype=dtype, buckets=(256,))
        want = pred._forward(pred._weights, x)
        span = float(want.abs().max())
        err = float((got - want).abs().max())
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_ATOL_REL * span)
        check(err <= BF16_REL * span, f"exported {dtype}: max|d|={err:.4g} > {BF16_REL} x {span:.4g}")
        exported[dtype] = dict(max_abs=err, ref_max=span, bytes=os.path.getsize(path))
    log(f"[serving_mtsr] export_program of the seeded STSR at bucket 256, reloaded on the card: "
        f"{exported}")
    return dict(errors=errs, ms=best, ms_runs=times, measured_crossover=measured, exported=exported)


def _eager_step(t):
    """One step of trainer ``t`` through its eager step function, on a
    fixed batch (the first of a seeded epoch)."""
    from tactilesr_torch.data.loader import epoch_batches

    idx, mask = next(epoch_batches(t.n_train, t.batch_size, True, np.random.default_rng(0)))
    weights = mask.reshape(t.grad_accum, -1).sum(axis=1)
    idx_t, mask_t = t._to_device(idx), t._to_device(mask)
    lr_now = t.lr
    return lambda: t._step(idx_t, mask_t, lr_now, weights, weights)  # no mesh: this rank's rows are all


def phase_train_times(trainer):
    """The train step at the recipe's batch on the trained model: the
    wrapper's forward (the kernel), its backward (the backward kernel),
    forward and backward together and the plain version of that, the
    optimizer, the whole step (CUDA events), and the device's busy time in
    the step, the backward and the optimizer (torch.profiler)."""
    dev, b = trainer.device, MAIN_BATCH
    depth, abm = physics_inputs(b, dev, seed=300)
    a = abm.clone().requires_grad_(True)
    g_lr = torch.randn(b, 4, 4, generator=torch.Generator().manual_seed(301)).to(dev)
    t = {"forward_ms": cuda_ms(lambda: tcuda.tpsf_physics_fused(depth, a), 200)}
    _hr, lr = tcuda.tpsf_physics_fused(depth, a)
    t["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(lr, a, g_lr, retain_graph=True), 100)
    t["ms"] = cuda_ms(lambda: torch.autograd.grad(tcuda.tpsf_physics_fused(depth, a)[1], a, g_lr), 100)

    def plain_fwd_bwd():
        with f32_matmul():
            return torch.autograd.grad(physics_plain(depth, a)[1], a, g_lr)

    t["plain_ms"] = cuda_ms(plain_fwd_bwd, 50)
    t["bound_ms"], t["bound_by"] = fused_bound_ms(b)

    step, lr_now = _eager_step(trainer), trainer.lr
    t["step_ms"] = cuda_ms(step, 50)
    t["optimizer_ms"] = cuda_ms(lambda: trainer.optimizer.step(lr_now), 100)
    log(f"[times] train step B={b} (bf16 MLP): whole step {t['step_ms']:.4f} ms; physics forward "
        f"(kernel) {t['forward_ms']:.4f} ms, kernel backward {t['backward_ms']:.4f} ms, "
        f"forward+backward {t['ms']:.4f} ms (plain, TF32 off: {t['plain_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms, {t['bound_by']}); Adam {t['optimizer_ms']:.4f} ms")
    for name, fn, ms in (
        ("whole step", step, t["step_ms"]),
        ("kernel backward", lambda: torch.autograd.grad(lr, a, g_lr, retain_graph=True),
         t["backward_ms"]),
        ("optimizer", lambda: trainer.optimizer.step(lr_now), t["optimizer_ms"]),
    ):
        prof = device_profile(fn)
        t[name.replace(" ", "_") + "_profile"] = prof
        busy = prof["busy_ms"]
        share = "not measured" if busy is None else f"{busy:.4f} ms = {busy / ms * 100:.1f}% of {ms:.4f} ms"
        log(f"[times] {name} under torch.profiler: {prof['kernels']:.0f} device ops per call, "
            f"device busy {share}; largest: {prof['top']}")
    ops = t["kernel_backward_profile"]["kernels"]
    check(ops <= 3, f"the kernel backward issued {ops} device ops per call (at most 3)")
    return t


def phase_times(dev, pred):
    times, bwd_times = {}, {}
    for b in (MAIN_BATCH, 8192):
        depth, abm = physics_inputs(b, dev, seed=100 + b)
        iters = 200 if b <= 256 else 20
        k_ms = cuda_ms(lambda: tcuda.tpsf_physics(depth, abm), iters)
        p_ms = cuda_ms(lambda: plain_f32(depth, abm), max(5, iters // 4))
        bound, by = tpsf_bound_ms(b)
        times[b] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, bound_share=bound / k_ms)
        log(f"[times] tpsf_physics B={b}: kernel {k_ms:.4f} ms ({b / k_ms * 1e3:.0f} samples/s), "
            f"plain (TF32 off) {p_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / k_ms * 100:.1f}% of the bound")
        g_lr = cotangents(b, dev, seed=200 + b)[1]  # the training call: LR cotangent, abm only
        k_ms = cuda_ms(lambda: tcuda.tpsf_physics_bwd(depth, abm, None, g_lr, need_depth=False), iters)
        p_ms = cuda_ms(lambda: vjp_plain_f32(depth, abm, None, g_lr, False), max(5, iters // 4))
        bound, by = tpsf_bwd_bound_ms(b)
        bwd_times[b] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, bound_share=bound / k_ms)
        log(f"[times] tpsf_physics_bwd B={b} (LR cotangent, abm): kernel {k_ms:.4f} ms, plain "
            f"physics_vjp_plain (TF32 off) {p_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / k_ms * 100:.1f}% of the bound")

    # SRPredictor at bucket 1024: host clock around predict (H2D, compute, D2H)
    lr = (torch.rand(1024, 3, 4, 4, generator=torch.Generator().manual_seed(9)) * 4).numpy()
    pred.predict(lr)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict(lr)
        runs.append(time.perf_counter() - t0)
    runs.sort()
    x = torch.from_numpy(lr).to(dev)
    dev_ms = cuda_ms(lambda: pred._forward(pred._weights, x), 10)
    log(f"[times] SRPredictor bf16 fused, bucket 1024: median {1024 / runs[2]:.1f} frames/s "
        f"(predict() host clock, 5 runs, min {1024 / runs[-1]:.1f} max {1024 / runs[0]:.1f}); "
        f"device forward {dev_ms:.3f} ms = {1024 / dev_ms * 1e3:.1f} frames/s")
    return times, bwd_times


def phase_sr_times(runs):
    """For each (name, trainer, test split, seqs) in ``runs``: the train step
    at the recipe's batch (CUDA events), its device ops, busy time and
    largest ops (torch.profiler), its model FLOPs utilisation (conv FLOPs
    over the bf16 dense peak), and the eval call over the test split."""
    out = {}
    for name, t, path, seqs in runs:
        b = t.batch_size
        per_frame, parts = sr_flops_per_frame(seqs=seqs)
        log(f"[times] {name} forward conv FLOPs per frame: {per_frame / 1e9:.3f} G = "
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items()))
        step = _eager_step(t)
        ms = cuda_ms(step, 20)
        prof = device_profile(step)
        flops = 3 * per_frame * b  # forward and backward (twice the forward)
        bound = flops / PEAK_BF16_FLOPS * 1e3
        with np.load(path) as z:
            arrays = {"LR": z["LR"], "HR": z["HR"]}
        eval_ms = cuda_ms(sr_task.build_eval_fn(t, arrays), 3, warmup=1)
        busy = prof["busy_ms"]
        share = "not measured" if busy is None else f"{busy:.4f} ms = {busy / ms * 100:.1f}% of the step"
        out[name] = dict(batch=b, step_ms=ms, step_tflop=flops / 1e12, bound_ms=bound, mfu=bound / ms,
                         step_profile=prof, eval_ms=eval_ms, eval_rows=int(arrays["LR"].shape[0]))
        log(f"[times] {name} train step B={b} (bf16): {ms:.4f} ms (CUDA events, 20 steps); "
            f"{prof['kernels']:.0f} device ops per step, device busy {share}; largest: {prof['top']}; "
            f"{flops / 1e12:.4f} TFLOP of convs per step, bound {bound:.4f} ms at the bf16 dense "
            f"peak, MFU {bound / ms * 100:.2f}%; eval of {arrays['LR'].shape[0]} test rows "
            f"{eval_ms:.3f} ms")
    log("[times] sr " + json.dumps(out))
    return out


def step_times(step, iters=20):
    """ms per call of ``step`` (CUDA events) and one torch.profiler trace
    of it (device ops, busy ms, host launch calls)."""
    ms = cuda_ms(step, iters)
    return dict(step_ms=ms, step_profile=device_profile(step))


def captured_step_times(t, iters=20):
    """The captured step of a scan-mode trainer: ms per replay (CUDA events
    over ``iters`` replays) and one torch.profiler trace of replays.  The
    step counter goes back to the epoch's first row before each run of
    replays (at most 8 + ``iters`` of them, within the epoch), so they
    train on the last epoch's rows."""
    check(t._graph is not None and iters + 3 <= t.epoch_len, "no graph, or an epoch too short")

    def replay():
        t._graph.replay()

    t._scan.k.zero_()
    ms = cuda_ms(replay, iters)
    t._scan.k.zero_()
    prof = device_profile(replay)
    t._scan.k.zero_()
    return dict(step_ms=ms, step_profile=prof)


def _share(prof, ms):
    busy = prof["busy_ms"]
    return "not measured" if busy is None else f"{busy:.4f} ms = {busy / ms * 100:.1f}%"


def phase_captured_times(runs):
    """For each (name, eager trainer or None, captured trainer, conv FLOPs
    per step or None) in ``runs``: the eager step and the captured step at
    the recipe's batch, each with its ms (CUDA events), device ops, host
    launch calls and busy share (torch.profiler), and MFU where the step's
    work is convolutions (over the bf16 dense peak)."""
    out = {}
    for name, eager, capt, flops in runs:
        row = {"captured": captured_step_times(capt)}
        if eager is not None:
            row["eager"] = step_times(_eager_step(eager))
        for mode, r in row.items():
            prof, ms = r["step_profile"], r["step_ms"]
            if flops:
                r["mfu"] = flops / PEAK_BF16_FLOPS * 1e3 / ms
            log(f"[times] {name} {mode} step B={capt.batch_size}: {ms:.4f} ms (CUDA events); "
                f"{prof['kernels']:.0f} device ops, {prof['host_launches']:.0f} host launch calls per "
                f"step; device busy {_share(prof, ms)}"
                + (f"; MFU {r['mfu'] * 100:.2f}%" if flops else "") + f"; largest: {prof['top'][:3]}")
        out[name] = row
    log("[times] captured " + json.dumps(out))
    return out


BURN_IN_S = 3.0
BENCH_ROUNDS, BENCH_CALLS = 1, 10  # the bench's timed loop, cut
BENCH_TPSF_BATCH = 8192
BENCH_KEYS = {"metric", "value", "unit", "extras", "device"}


def phase_device(dev):
    """The device utilities: the memory scan, the freest device and the
    bf16 matmul burn-in, whose TFLOP/s must be above 0 and at most 105% of
    the bf16 dense peak."""
    mem = parse_device_memory()
    check(len(mem) == torch.cuda.device_count() and all(m["free_memory"] > 0 for m in mem),
          f"parse_device_memory: {mem}")
    index, _, name, free = select_device_with_most_free_memory()
    check(name == torch.cuda.get_device_name(index), f"selected {index}: {name}")
    tflops = burn_in(dev, test_time=BURN_IN_S)
    check(0 < tflops <= 1.05 * PEAK_BF16_FLOPS / 1e12,
          f"burn-in {tflops:.1f} TFLOP/s outside (0, {1.05 * PEAK_BF16_FLOPS / 1e12:.0f}]")
    log(f"[device] {mem}; freest: {index} ({name}, {free / 1e9:.1f} GB free); burn-in "
        f"{tflops:.1f} TFLOP/s bf16 ({tflops * 1e12 / PEAK_BF16_FLOPS * 100:.1f}% of the dense peak)")
    return tflops


def phase_bench(dev):
    """``python -m tactilesr_torch.bench --batch 8192``'s run at each
    precision, at ``BENCH_ROUNDS`` x ``BENCH_CALLS``.  Each record goes
    through JSON as the CLI prints it and must carry its keys, a positive
    value and a share of the bound in (0, 1.05), with exactly its own
    kernel launched (counted from 0 per precision: that path's launches)."""
    out, launches = {}, {}
    for prec, (name, _) in tcuda.FORWARD_KERNELS.items():
        tcuda.reset_launch_counts()
        rec = json.loads(json.dumps(bench.bench_tpsf(BENCH_TPSF_BATCH, prec, dev, BENCH_ROUNDS,
                                                     BENCH_CALLS)))
        counts = launches[f"bench_tpsf_{prec}"] = dict(tcuda.launch_counts)
        want = 1 + BENCH_ROUNDS * BENCH_CALLS  # the launch check, then the timed calls
        check(counts[name] == want and sum(counts.values()) == want,
              f"bench --precision {prec}: launches {counts}, want {want} of {name} alone")
        check(BENCH_KEYS <= set(rec) and rec["value"] > 0 and 0 < rec["extras"]["bound_share"] < 1.05,
              f"bench --precision {prec}: {rec}")
        out[f"tpsf_{prec}"] = rec
        log(f"[bench] tpsf {prec}: " + json.dumps(rec))
    return out, launches


def phase_interchange(work, stsr_ckpt, sr_dir):
    """The trained STSR ``.pth`` -> JAX ``.ckpt`` (``compat.torch_convert``)
    -> ``.pth`` (``compat.export_torch``): every parameter and running
    statistic bit-equal (``num_batches_tracked`` comes back 0: JAX keeps no
    such counter), the ``.ckpt`` read directly the same, and all three files
    served on the card to the same output."""
    d = os.path.join(work, "interchange")
    ckpt = convert_checkpoint_file(stsr_ckpt, os.path.join(d, "stsr.ckpt"), arch="tactileSR")
    back = export_checkpoint_file(ckpt, os.path.join(d, "stsr_back.pth"), arch="tactileSR")
    orig = load_checkpoint_file(stsr_ckpt)["model"]
    for path in (back, ckpt):
        got = load_checkpoint_file(path)["model"]
        check(set(got) == set(orig), f"{path}: keys differ")
        for k, v in orig.items():
            want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
            check(torch.equal(got[k], want), f"{path}: {k} differs")
    with np.load(os.path.join(sr_dir, "SRdataset_test.npz")) as z:
        lr = np.ascontiguousarray(z["LR"][:256, :3])
    served = [SRPredictor(p, buckets=(256,)).predict(lr) for p in (stsr_ckpt, ckpt, back)]
    check(all(np.array_equal(served[0], s) for s in served[1:]), "served outputs differ")
    log(f"[interchange] .pth -> .ckpt ({os.path.getsize(ckpt)} B) -> .pth: {len(orig)} tensors "
        f"bit-equal; {lr.shape[0]} rows served equal from all three (max {float(served[0].max()):.4f})")
    return len(orig)


def phase_graft_entry(dev):
    """``graft_entry.entry()``: the flagship bf16 STSR and its example batch
    on the card; the forward finite, (32, 1, 40, 40), and within
    ``BF16_REL`` of the output range of the same weights' f32 forward."""
    model, x = graft_entry.entry()
    check(x.is_cuda and next(model.parameters()).is_cuda, "entry() is not on the card")
    ref = graft_entry.flagship_model(dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = model(x)
        want = ref.to(dev).eval()(x)
    check(out.shape == (32, 1, 40, 40) and torch.isfinite(out).all(), f"entry forward {out.shape}")
    span = float(want.abs().max())
    err = float((out - want).abs().max())
    check(err <= BF16_REL * max(span, 1e-12), f"entry bf16 vs f32: {err:.4g} > {BF16_REL} x {span:.4g}")
    log(f"[graft_entry] forward {tuple(out.shape)} {out.dtype}; bf16 vs f32 max|d| {err:.4g} of "
        f"range {span:.4g}")
    return dict(max_abs=err, ref_max=span)


class PhaseClock:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {self.seconds[name]:.1f} s")
        return result


def keep_checkpoints(dest, stsr_ckpt, cnn_ckpt, sr_dir):
    """Write the trained STSR's and TactileSRCNN's weights (each
    ``latest.pth``'s model state_dict, in a bundle of its own: the optimizer
    state would not fit what a chip run brings back) and the LR rows of the
    STSR test split to ``dest``."""
    os.makedirs(dest, exist_ok=True)
    for name, ckpt in (("stsr", stsr_ckpt), ("cnn", cnn_ckpt)):
        bundle = load_checkpoint_file(ckpt)
        save_checkpoint_file(os.path.join(dest, f"{name}_latest.pth"), bundle["model"],
                             epoch=bundle["epoch"])
    with np.load(os.path.join(sr_dir, "SRdataset_test.npz")) as z:
        np.savez(os.path.join(dest, "sr_test_lr.npz"), LR=z["LR"])
    log(f"[keep] trained STSR and CNN weights and the STSR test split written to {dest}: "
        f"{sorted(os.listdir(dest))}")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU")
    p.add_argument("--keep-checkpoints", metavar="DIR", default=None,
                   help="also write the trained STSR's and CNN's weights and the STSR test split to DIR")
    p.add_argument("--dp-rank", metavar="SPEC", default=None,
                   help="run one rank of the data_parallel phase (started by that phase)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.dp_rank:
        dp_rank(args.dp_rank)
        return 0
    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()})")
    t_all = time.perf_counter()
    phase = PhaseClock()
    info = phase("build", phase_build)
    errs = phase("kernel", phase_kernel, dev)
    bwd_errs = phase("kernel_bwd", phase_kernel_bwd, dev)
    prec_errs, prec_devs = phase("kernel_precision", phase_kernel_precision, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        trainer, raw, ckpt, train_launches, grad_err, epoch_sps = phase("training", phase_training,
                                                                         work, dev)
        tpsf_capt, capt_launches, tpsf_capt_info = phase("training_captured", phase_training_captured,
                                                         work, raw, trainer)
        prec_runs = phase("training_precision", phase_training_precision, work, raw)
        # the recipe allowed TF32 for f32 matmuls (matmul_precision "default");
        # stage 2 runs in a process of its own, at torch's default
        torch.set_float32_matmul_precision("highest")
        gen_launches, test_lr, sr_dir = phase("generation", phase_generation, work, dev, raw, ckpt)
        stsr, stsr_ckpt, stsr_sps = phase("sr", phase_sr_training, work, sr_dir)
        dp_launches, dp_info = phase("data_parallel", phase_data_parallel, work, dev, sr_dir, raw,
                                     stsr_ckpt)
        parity = phase("sr_parity", phase_sr_parity, work, sr_dir)
        stsr_capt, sr_capt_info = phase("sr_captured", phase_sr_captured, work, dev, sr_dir)
        remat = phase("remat", phase_remat, work, dev, sr_dir)
        cnn, cnn_info = phase("cnn", phase_cnn, work, dev, sr_dir)
        if args.keep_checkpoints:
            keep_checkpoints(args.keep_checkpoints, stsr_ckpt,
                             os.path.join(work, "cnn", "checkpoints", "latest.pth"), sr_dir)
        n_trace_kernels = phase("profiler", phase_profiler, work, dev, sr_dir)
        torch.set_float32_matmul_precision("highest")
        seqs_launches, seqs_dir = phase("generation_seqs", phase_generation_seqs, work, dev, raw, ckpt)
        gen_prec_launches, gen_prec_devs = phase("generation_precision", phase_generation_precision,
                                                 work, dev, raw, ckpt, sr_dir, seqs_dir)
        breakdown = phase("generation_breakdown", phase_generation_breakdown, work, raw, ckpt)
        mtsr, mtsr_ckpt, mtsr_sps = phase("seqs", phase_mtsr_training, work, seqs_dir, stsr_ckpt)
        served = phase("serving_trained", phase_serving_trained, dev, stsr_ckpt, sr_dir, mtsr_ckpt,
                       seqs_dir)
        pred = phase("serving", phase_serving, work, dev, test_lr)
        server = phase("server", phase_server, work, dev, stsr_ckpt, sr_dir)
        mtsr_served = phase("serving_mtsr", phase_serving_mtsr, work, dev)
        times, bwd_times = phase("times", phase_times, dev, pred)
        prec_times = phase("times_precision", phase_times_precision, dev)
        train_t = phase("train_times", phase_train_times, trainer)
        sr_t = phase("sr_times", phase_sr_times, [
            ("STSR", stsr, os.path.join(sr_dir, "SRdataset_test.npz"), 1),
            ("MTSR", mtsr, os.path.join(seqs_dir, "SRdataset_test_32.npz"), 7)])
        capt_t = phase("captured_times", phase_captured_times, [
            ("STSR", None, stsr_capt, 3 * sr_flops_per_frame()[0] * stsr_capt.batch_size),
            ("stage 1", None, tpsf_capt, None),
            ("stage 1 default", prec_runs["eager"][0], prec_runs["captured"][0], None),
            ("TactileSRCNN", cnn, cnn, 3 * cnn_flops_per_frame() * cnn.batch_size)])
        burn_tflops = phase("device", phase_device, dev)
        bench_recs, bench_launches = phase("bench", phase_bench, dev)
        n_interchanged = phase("interchange", phase_interchange, work, stsr_ckpt, sr_dir)
        entry_dev = phase("graft_entry", phase_graft_entry, dev)
    log(f"[times] SR epochs: STSR {stsr_sps:.1f} samples/s, MTSR {mtsr_sps:.1f} samples/s; "
        f"STSR step {sr_t['STSR']['step_ms']:.4f} ms (MFU {sr_t['STSR']['mfu'] * 100:.2f}%), "
        f"MTSR step {sr_t['MTSR']['step_ms']:.4f} ms (MFU {sr_t['MTSR']['mfu'] * 100:.2f}%); "
        f"card vs CPU loss rel {parity['loss_rel']:.3e}; trained serving {served}")
    log(f"[times] data_parallel {json.dumps(dp_info)}")
    log(f"[times] captured: STSR step {capt_t['STSR']['captured']['step_ms']:.4f} ms (eager "
        f"{sr_t['STSR']['step_ms']:.4f}), stage 1 {capt_t['stage 1']['captured']['step_ms']:.4f} ms "
        f"(eager {train_t['step_ms']:.4f}), TactileSRCNN {capt_t['TactileSRCNN']['captured']['step_ms']:.4f} "
        f"ms (eager {capt_t['TactileSRCNN']['eager']['step_ms']:.4f}); captured vs eager losses: STSR f32 "
        f"{sr_capt_info['loss_rel']:.3e}, stage 1 {tpsf_capt_info['loss_rel']:.3e}; remat {remat}; CNN "
        f"{cnn_info}; {n_trace_kernels} kernels in the profiler trace")
    log(f"[times] serving: server {json.dumps(server)}; MTSR branch layouts "
        f"{json.dumps({k: mtsr_served[k] for k in ('ms', 'measured_crossover')})}")
    log(f"[times] entries: burn-in {burn_tflops:.1f} TFLOP/s; bench "
        + json.dumps({k: r["value"] for k, r in bench_recs.items()})
        + "; interchange "
        f"{n_interchanged} tensors bit-equal; graft entry {json.dumps(entry_dev)}")
    smi = nvidia_smi_line()
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s: {phase.seconds}")
    by_path = {"training": train_launches, "training_captured": capt_launches,
               "training_precision": prec_runs["eager"][1],
               "training_precision_captured": prec_runs["captured"][1],
               "generation": gen_launches, "generation_seqs": seqs_launches, **gen_prec_launches,
               **bench_launches, "data_parallel": dp_launches}
    main_t = times[MAIN_BATCH]
    record = {"kernels": [
        {
            "name": "tpsf_physics",
            "route": "cuda",
            "source": "tactilesr_torch/ops/cuda/tpsf_kernel.cu",
            "replaces": "tactilesr_tpu/ops/pallas/tpsf_kernel.py:162",
            "launches": sum(p["tpsf_physics"] for p in by_path.values()),
            "launches_by_path": {k: p["tpsf_physics"] for k, p in by_path.items()},
            "max_abs_err": max(errs.values()),
            "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": None,
            "bound_share": main_t["bound_share"],
            "blocks_per_sm": info["tpsf_physics"]["blocks_per_sm"],
            "batch": MAIN_BATCH,
            "at_b8192": times[8192],
        },
        {
            "name": "tpsf_physics_bwd",
            "route": "cuda",
            "source": "tactilesr_torch/ops/cuda/tpsf_kernel.cu",
            "replaces": "tactilesr_tpu/ops/pallas/tpsf_kernel.py:207",
            "launches": sum(p["tpsf_physics_bwd"] for p in by_path.values()),
            "launches_by_path": {k: p["tpsf_physics_bwd"] for k, p in by_path.items()},
            "max_abs_err": max(bwd_errs.values()),
            "ms": bwd_times[MAIN_BATCH]["ms"],
            "plain_ms": bwd_times[MAIN_BATCH]["plain_ms"],
            "bound_ms": bwd_times[MAIN_BATCH]["bound_ms"],
            "bound_by": bwd_times[MAIN_BATCH]["bound_by"],
            "library_ms": None,
            "bound_share": bwd_times[MAIN_BATCH]["bound_share"],
            "blocks_per_sm": info["tpsf_physics_bwd"]["blocks_per_sm"],
            "batch": MAIN_BATCH,
            "at_b8192": bwd_times[8192],
        },
        {
            "name": "tpsf_physics_fused",
            "route": "cuda forward + cuda backward",
            "source": "tactilesr_torch/ops/cuda/__init__.py",
            "replaces": "tactilesr_tpu/ops/pallas/tpsf_kernel.py:190",
            "launches": sum(p["tpsf_physics_fused"] for p in by_path.values()),
            "launches_by_path": {k: p["tpsf_physics_fused"] for k, p in by_path.items()},
            "max_abs_err": grad_err,
            "ms": train_t["ms"],
            "plain_ms": train_t["plain_ms"],
            "bound_ms": train_t["bound_ms"],
            "bound_by": train_t["bound_by"],
            "library_ms": None,
            "batch": MAIN_BATCH,
            "forward_ms": train_t["forward_ms"],
            "backward_ms": train_t["backward_ms"],
            "optimizer_ms": train_t["optimizer_ms"],
            "step_ms": train_t["step_ms"],
            "epoch_samples_per_s": epoch_sps,
            "step_profile": train_t["whole_step_profile"],
            "backward_profile": train_t["kernel_backward_profile"],
            "optimizer_profile": train_t["optimizer_profile"],
            "captured_step_ms": capt_t["stage 1"]["captured"]["step_ms"],
            "captured_step_profile": capt_t["stage 1"]["captured"]["step_profile"],
            "captured_epoch_samples_per_s": tpsf_capt_info["epoch_samples_per_s"],
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tactilesr_torch/ops/cuda/tpsf_kernel.cu",
            "replaces": f"tactilesr_tpu/ops/pallas/tpsf_kernel.py:162 (precision={prec.upper()})",
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": prec_errs[name],
            "ms": prec_times[name][MAIN_BATCH]["ms"],
            "plain_ms": prec_times[name][MAIN_BATCH]["plain_ms"],
            "bound_ms": prec_times[name][MAIN_BATCH]["bound_ms"],
            "bound_by": prec_times[name][MAIN_BATCH]["bound_by"],
            "library_ms": None,
            "bound_share": prec_times[name][MAIN_BATCH]["bound_share"],
            "blocks_per_sm": info[name]["blocks_per_sm"],
            "batch": MAIN_BATCH,
            "f32_kernel_ms": prec_times[name][MAIN_BATCH]["f32_kernel_ms"],
            "at_b8192": prec_times[name][8192],
            "deviation_from_f32_b8192": prec_devs[name],
        }
        for prec, name in BF16_KERNELS.items()
    ]}
    for k in record["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path: {k['launches_by_path']}")
    log(f"[times] bf16 physics: labels vs f32 {gen_prec_devs}; generation breakdown {breakdown}; "
        f"stage 1 default step: eager {capt_t['stage 1 default']['eager']['step_ms']:.4f} ms, captured "
        f"{capt_t['stage 1 default']['captured']['step_ms']:.4f} ms (f32: eager {train_t['step_ms']:.4f}, "
        f"captured {capt_t['stage 1']['captured']['step_ms']:.4f})")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

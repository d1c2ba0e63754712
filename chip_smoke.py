"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build      -- compile tactilesr_torch/ops/cuda/tpsf_kernel.cu with nvcc
2. kernel     -- the tPSF physics kernel vs its plain PyTorch version at
                 B in {1, 5, 256, 8192} (TF32 off for the plain version;
                 HR rtol/atol 1e-4, LR rtol 1e-4 / atol 1e-6)
3. training   -- ``generate synthetic`` (3 blobs of 81 taps), then stage 1
                 through its entry (``tasks/tpsf_task.py``) at the recipe's
                 defaults for 2 epochs (7,296 samples, batch 256, bf16 MLP),
                 the last epoch timed on the host clock (samples/s);
                 both kernel wrappers' counts must rise by at least the step
                 count, every loss and the eval metric must be finite, every
                 parameter must move, ``latest.pth`` must exist, the
                 alpha/beta curves must be finite; then the wrapper's
                 gradients (kernel forward, recompute backward) vs autograd
                 through the plain physics at B=256 (rtol 1e-3, atol 1e-6)
4. generation -- ``generate single --sample-cnt 4 --batch 256`` from the
                 checkpoint that training wrote; the kernel's launch count
                 must rise and the outputs must be finite and match the
                 plain physics
5. serving    -- a seeded full-width STSR (scale 10, 6 MSRB, 1 ResBlock,
                 perturbed BN stats) served by SRPredictor in bf16 for three
                 requests, held against the f32 eval forward; fused f32 vs
                 unfused f32; hot swap and refusal
6. times      -- kernel and plain times at B=256 and B=8192 (CUDA events);
                 the train step at B=256 split into the physics forward, its
                 recompute backward, the optimizer and the whole step (CUDA
                 events) and the card's busy time in them (torch.profiler);
                 SRPredictor frames/s at bucket 1024

The second-to-last line is the per-kernel JSON record, the line before it
the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tactilesr_torch.config import tPSFNet_config  # noqa: E402
from tactilesr_torch.data import generate  # noqa: E402
from tactilesr_torch.data.datasets import SingleTapSeqsDataset  # noqa: E402
from tactilesr_torch.models.inference import fold_inference_params, tactile_sr_infer  # noqa: E402
from tactilesr_torch.models.tactile_sr import TactileSR  # noqa: E402
from tactilesr_torch.models.tpsf_net import TPSFNet  # noqa: E402
from tactilesr_torch.ops import cuda as tcuda  # noqa: E402
from tactilesr_torch.ops.psf import f32_matmul, physics_plain  # noqa: E402
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file, save_checkpoint_file  # noqa: E402
from tactilesr_torch.runtime.hooks import HookBase  # noqa: E402
from tactilesr_torch.serving import SRPredictor  # noqa: E402
from tactilesr_torch.tasks import tpsf_task  # noqa: E402

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)
KERNEL_BATCHES = (1, 5, 256, 8192)
MAIN_BATCH = 256  # generate single --batch 256 and the recipe's train batch
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_pallas_kernels.py:45
TRAIN_EPOCHS = 2
# bf16 serving vs the f32 eval forward: bf16 keeps 8 significant bits, and
# rounding compounds through ~25 conv layers (about 2% of the output range
# measured on the CPU); allow 5% of the output range
BF16_REL = 5e-2
# fused f32 vs unfused f32: same function, other conv order/algorithms
F32_RTOL, F32_ATOL_REL = 1e-4, 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores (no tensor cores)
PEAK_HBM_BPS = 3.35e12


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


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


def tpsf_bound_ms(b):
    """Least time for B samples: f32 FMA work over the f32 peak vs bytes
    (depth and abm in, HR and LR out, once each) over HBM bandwidth."""
    band = sum(min(99, i + 49) - max(0, i - 49) + 1 for i in range(100))  # 7,450 taps of A
    flops = 2 * 2 * band * 100 + 2 * (4 * 100 * 100 + 4 * 4 * 100)  # A.D.A^T + U.HR.U^T
    nbytes = 4 * (100 * 100 + 3 + 100 * 100 + 16)
    t_ops = b * flops / PEAK_F32_FLOPS * 1e3
    t_bytes = b * nbytes / PEAK_HBM_BPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fused_bound_ms(b):
    """Least time for the function the wrapper computes, forward and abm
    gradient, at B samples.  Operations: the banded forward once (the
    kernel's count), the three banded products of the abm backward with
    P = A D, M = P A^T (dP = dM A, and dA = dM^T P + dP D^T over the band
    only), and the degradation's backward (to HR, and to m through U H and
    U H^T) at twice its forward; elementwise work is left out.  Over the
    f32 peak, against depth and abm in, HR and LR out, the LR cotangent in
    and the abm gradient out, once each, over HBM bandwidth."""
    band = sum(min(99, i + 49) - max(0, i - 49) + 1 for i in range(100))  # 7,450 taps of A
    degrade = 2 * (4 * 100 * 100 + 4 * 4 * 100)
    flops = (2 * 2 * band * 100 + degrade) + 3 * 2 * band * 100 + 2 * degrade
    nbytes = 4 * (100 * 100 + 3 + 100 * 100 + 16 + 16 + 3)
    t_ops = b * flops / PEAK_F32_FLOPS * 1e3
    t_bytes = b * nbytes / PEAK_HBM_BPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    t0 = time.perf_counter()
    tcuda.build()
    log(f"[build] tpsf_kernel.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in tcuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")


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
        log(f"[training] B={b} {name} gradient: kernel fwd + recompute bwd vs plain autograd "
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


def phase_generation(work, dev, raw, ckpt):
    out_dir = os.path.join(work, "SRdataset")
    tcuda.reset_launch_counts()
    generate._cli(["single", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir", out_dir,
                   "--sample-cnt", "4", "--batch", str(MAIN_BATCH)])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    for name in ("tpsf_physics", "tpsf_physics_fused"):
        check(launches[name] > 0, f"generate single launched no {name}: {launches}")

    total = 0
    for split in ("train", "validation", "test"):
        with np.load(os.path.join(out_dir, f"SRdataset_{split}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        n = arrays["LR"].shape[0]
        total += n
        check(n > 0, f"split {split} is empty")
        check(arrays["HR"].shape == (n, 1, 100, 100), f"{split} HR shape {arrays['HR'].shape}")
        for k, v in arrays.items():
            check(np.isfinite(v).all(), f"{split}/{k} has non-finite values")
    log(f"[generation] {total} samples in 3 splits, tpsf_physics launches={launches['tpsf_physics']}")

    # the test split again through the plain physics on the card
    with np.load(os.path.join(out_dir, "SRdataset_test.npz")) as z:
        lr, depth, hr, deg = z["LR"], z["depth"], z["HR"], z["LR_degrade"]
    ref = TPSFNet(use_kernel=False)
    ref.load_state_dict(load_checkpoint_file(ckpt)["model"])
    ref = ref.to(dev).eval()
    with torch.no_grad(), f32_matmul():
        hr_r, deg_r, _, _ = ref(torch.from_numpy(lr).to(dev), torch.from_numpy(depth).to(dev),
                                return_psf=False)
    torch.testing.assert_close(torch.from_numpy(hr), hr_r.cpu(), **HR_TOL)
    torch.testing.assert_close(torch.from_numpy(deg), deg_r.cpu(), **LR_TOL)
    log("[generation] test split matches the plain physics (HR 1e-4, LR 1e-6) ok")
    return launches, lr


def _stsr(seed, pattern_layers=6):
    """Seeded full-width STSR with BN running stats drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    m = TactileSR(scale_factor=10, pattern_feature_extra_layer_cnt=pattern_layers,
                  force_feature_extra_layer_cnt=1, generator=g)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.3 * torch.randn(mod.num_features, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.num_features, generator=g))
    return m


def _unfused_f32(model, x, dev, chunk=256):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = model.to(dev).eval()
        with torch.no_grad():
            return torch.cat([model(x[i:i + chunk].to(dev)) for i in range(0, x.shape[0], chunk)])
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_serving(work, dev, test_lr, n_big=1500):
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
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        folded = fold_inference_params(model.state_dict(), dtype=torch.float32, device=dev)
        fused = tactile_sr_infer(folded, x)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
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


def device_profile(fn, n=5):
    """One torch.profiler trace of ``n`` calls: the device's busy ms per call
    (the kernels' and copies' own device times summed; None when the trace
    holds no device time), device ops per call, and the five largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # GPU-side user annotations (e.g. "Optimizer.step#Adam.step") span the
    # kernels inside them: counting them would count those kernels twice
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(busy_ms=busy if busy > 0 else None,
                kernels=sum(e.count for e in dev) / n,
                top=[(e.key[:60], round(e.self_device_time_total / 1e3 / n, 4)) for e in top])


def phase_train_times(trainer):
    """The train step at the recipe's batch on the trained model: the
    wrapper's forward (the kernel), its recompute backward, forward and
    backward together and the plain version of that, the optimizer, the
    whole step (CUDA events), and the device's busy time in the step, the
    backward and the optimizer (torch.profiler)."""
    from tactilesr_torch.data.loader import epoch_batches

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

    idx, mask = next(epoch_batches(trainer.n_train, b, True, np.random.default_rng(0)))
    weights = mask.reshape(trainer.grad_accum, -1).sum(axis=1)
    idx_t, mask_t = trainer._to_device(idx), trainer._to_device(mask)
    lr_now = trainer.lr
    t["step_ms"] = cuda_ms(lambda: trainer._step(idx_t, mask_t, lr_now, weights), 50)
    t["optimizer_ms"] = cuda_ms(lambda: trainer.optimizer.step(lr_now), 100)
    log(f"[times] train step B={b} (bf16 MLP): whole step {t['step_ms']:.4f} ms; physics forward "
        f"(kernel) {t['forward_ms']:.4f} ms, recompute backward {t['backward_ms']:.4f} ms, "
        f"forward+backward {t['ms']:.4f} ms (plain, TF32 off: {t['plain_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms, {t['bound_by']}); Adam {t['optimizer_ms']:.4f} ms")
    for name, fn, ms in (
        ("whole step", lambda: trainer._step(idx_t, mask_t, lr_now, weights), t["step_ms"]),
        ("recompute backward", lambda: torch.autograd.grad(lr, a, g_lr, retain_graph=True),
         t["backward_ms"]),
        ("optimizer", lambda: trainer.optimizer.step(lr_now), t["optimizer_ms"]),
    ):
        prof = device_profile(fn)
        t[name.replace(" ", "_") + "_profile"] = prof
        busy = prof["busy_ms"]
        share = "not measured" if busy is None else f"{busy:.4f} ms = {busy / ms * 100:.1f}% of {ms:.4f} ms"
        log(f"[times] {name} under torch.profiler: {prof['kernels']:.0f} device ops per call, "
            f"device busy {share}; largest: {prof['top']}")
    return t


def phase_times(dev, pred):
    times = {}
    for b in (MAIN_BATCH, 8192):
        depth, abm = physics_inputs(b, dev, seed=100 + b)
        iters = 200 if b <= 256 else 20
        k_ms = cuda_ms(lambda: tcuda.tpsf_physics(depth, abm), iters)
        p_ms = cuda_ms(lambda: plain_f32(depth, abm), max(5, iters // 4))
        bound, by = tpsf_bound_ms(b)
        times[b] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by)
        log(f"[times] tpsf_physics B={b}: kernel {k_ms:.4f} ms ({b / k_ms * 1e3:.0f} samples/s), "
            f"plain (TF32 off) {p_ms:.4f} ms, bound {bound:.4f} ms ({by})")

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
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()})")
    t_all = time.perf_counter()
    phase_build()
    errs = phase_kernel(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        trainer, raw, ckpt, train_launches, grad_err, epoch_sps = phase_training(work, dev)
        # the recipe allowed TF32 for f32 matmuls (matmul_precision "default");
        # stage 2 runs in a process of its own, at torch's default
        torch.set_float32_matmul_precision("highest")
        gen_launches, test_lr = phase_generation(work, dev, raw, ckpt)
        pred = phase_serving(work, dev, test_lr)
        times = phase_times(dev, pred)
        train_t = phase_train_times(trainer)
    smi = nvidia_smi_line()
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    by_path = {"training": train_launches, "generation": gen_launches}
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
            "batch": MAIN_BATCH,
            "at_b8192": times[8192],
        },
        {
            "name": "tpsf_physics_fused",
            "route": "cuda forward + autograd recompute",
            "source": "tactilesr_torch/ops/cuda/__init__.py",
            "replaces": "tactilesr_tpu/ops/pallas/tpsf_kernel.py:190",
            "launches": train_launches["tpsf_physics_fused"],
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
            "backward_profile": train_t["recompute_backward_profile"],
            "optimizer_profile": train_t["optimizer_profile"],
        },
    ]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build      -- compile tactilesr_torch/ops/cuda/tpsf_kernel.cu with nvcc
2. kernel     -- the tPSF physics kernel vs its plain PyTorch version at
                 B in {1, 5, 256, 8192} (TF32 off for the plain version;
                 HR rtol/atol 1e-4, LR rtol 1e-4 / atol 1e-6)
3. generation -- ``generate synthetic`` (3 blobs of 81 taps), a seeded
                 TPSFNet saved as .pth, ``generate single --sample-cnt 4
                 --batch 256``; the kernel's launch count must rise and the
                 outputs must be finite and match the plain physics
4. serving    -- a seeded full-width STSR (scale 10, 6 MSRB, 1 ResBlock,
                 perturbed BN stats) served by SRPredictor in bf16 for three
                 requests, held against the f32 eval forward; fused f32 vs
                 unfused f32; hot swap and refusal
5. times      -- kernel and plain times at B=256 and B=8192 (CUDA events),
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

from tactilesr_torch.data import generate  # noqa: E402
from tactilesr_torch.models.inference import fold_inference_params, tactile_sr_infer  # noqa: E402
from tactilesr_torch.models.tactile_sr import TactileSR  # noqa: E402
from tactilesr_torch.models.tpsf_net import TPSFNet  # noqa: E402
from tactilesr_torch.ops import cuda as tcuda  # noqa: E402
from tactilesr_torch.ops.psf import physics_plain  # noqa: E402
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file  # noqa: E402
from tactilesr_torch.serving import SRPredictor  # noqa: E402

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)
KERNEL_BATCHES = (1, 5, 256, 8192)
MAIN_BATCH = 256  # generate single --batch 256: the kernel's shape on the main path
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
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return physics_plain(depth, abm)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


def phase_generation(work, dev):
    raw = os.path.join(work, "raw")
    generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "I", "P",
                   "--taps-per-blob", "81", "--seed", "0"])
    tpsf = TPSFNet(generator=torch.Generator().manual_seed(7))
    ckpt = save_checkpoint_file(os.path.join(work, "tpsf.pth"), tpsf.state_dict())
    out_dir = os.path.join(work, "SRdataset")

    tcuda.reset_launch_counts()
    generate._cli(["single", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir", out_dir,
                   "--sample-cnt", "4", "--batch", str(MAIN_BATCH)])
    torch.cuda.synchronize()
    launches = dict(tcuda.launch_counts)
    check(launches["tpsf_physics"] > 0, f"generate single launched no kernel: {launches}")

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
    ref.load_state_dict(tpsf.state_dict())
    ref = ref.to(dev).eval()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            hr_r, deg_r, _, _ = ref(torch.from_numpy(lr).to(dev), torch.from_numpy(depth).to(dev),
                                    return_psf=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
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
        launches, test_lr = phase_generation(work, dev)
        pred = phase_serving(work, dev, test_lr)
        times = phase_times(dev, pred)
    smi = nvidia_smi_line()
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    main_t = times[MAIN_BATCH]
    record = {"kernels": [{
        "name": "tpsf_physics",
        "route": "cuda",
        "source": "tactilesr_torch/ops/cuda/tpsf_kernel.cu",
        "replaces": "tactilesr_tpu/ops/pallas/tpsf_kernel.py:162",
        "launches": launches["tpsf_physics"],
        "max_abs_err": max(errs.values()),
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "batch": MAIN_BATCH,
        "at_b8192": times[8192],
    }]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

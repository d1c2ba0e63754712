"""How far do two runs of one arithmetic part, with and without cuDNN's
deterministic algorithms?

Runs ``chip_smoke.py``'s build, stage-1 training and ``generate single``
phases for labels, then three times over, first with cuDNN's default
algorithms and then with ``cudnn.deterministic``: 5 f32 steps of the
full-width STSR at B=8 from one init, twice eagerly with capturable Adam
and once captured (``scan_epochs``), and prints one ``[spread]`` JSON line
per repeat and setting with the max |d| of the BN running statistics and
of the parameters, and the losses' max relative difference, for captured
against eager and for eager against itself.  Needs one CUDA card:

    python3 cudnn_spread.py
"""
import json
import os
import runpy
import sys
import tempfile

import numpy as np
import torch

STEPS, BATCH, REPEATS = 5, 8, 3


def _runs(g, work, sr_dir, deterministic, variants):
    cfg = dict(g["tactileSR_config"], compute_dtype="float32", warmup_t=0,
               train_batch_size=BATCH, matmul_precision="highest")
    with np.load(os.path.join(sr_dir, "SRdataset_train.npz")) as z:
        arrays = {"LR": z["LR"][:BATCH * STEPS], "HR": z["HR"][:BATCH * STEPS]}
    init = g["sr_task"].build_model(cfg).state_dict()
    g["apply_matmul_precision"](cfg)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    out = {}
    try:
        for name, kw in variants.items():
            kw = dict(kw)
            hooks = kw.pop("hooks", [])
            model = g["sr_task"].build_model(cfg)
            model.load_state_dict(init)
            t = g["_sr_trainer"](cfg, model, arrays, os.path.join(work, f"spread_{name}"),
                                 torch.device("cuda"), max_epochs=1, epoch_len=STEPS, **kw)
            t.register_hooks(hooks)
            t.train(auto_resume=False)
            out[name] = (g["_losses"](t), g["_cpu_state"](t))
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


def _deviation(a, b):
    (la, sa), (lb, sb) = a, b
    stats = ("running_mean", "running_var")
    return {
        "stats": max(float((sa[k] - sb[k]).abs().max()) for k in sa if k.endswith(stats)),
        "params": max(float((sa[k] - sb[k]).abs().max()) for k in sa
                      if not k.endswith(stats + ("num_batches_tracked",))),
        "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(la, lb)),
    }


def main():
    if not torch.cuda.is_available():
        print("cudnn_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    g = runpy.run_path(os.path.join(here, "chip_smoke.py"), run_name="cudnn_spread")
    dev = torch.device("cuda")
    g["phase_build"]()
    with tempfile.TemporaryDirectory(prefix="cudnn_spread_") as work:
        _, raw, ckpt, *_ = g["phase_training"](work, dev)
        torch.set_float32_matmul_precision("highest")
        _, _, sr_dir = g["phase_generation"](work, dev, raw, ckpt)
        for rep in range(REPEATS):
            for det in (False, True):
                r = _runs(g, work, sr_dir, det, {
                    "eager": {"hooks": [g["CapturableAdam"]()]},
                    "eager_again": {"hooks": [g["CapturableAdam"]()]},
                    "captured": {"scan_epochs": True}})
                print("[spread] " + json.dumps({
                    "repeat": rep, "deterministic": det,
                    "captured_vs_eager": _deviation(r["captured"], r["eager"]),
                    "eager_vs_eager": _deviation(r["eager_again"], r["eager"])}), flush=True)
    print(g["nvidia_smi_line"](), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

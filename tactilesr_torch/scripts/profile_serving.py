"""Per-op device-time table of the fused serving forward (the counterpart
of the root ``scripts/profile_serving.py``).

    python -m tactilesr_torch.scripts.profile_serving [--batch 4096] [--iters 3] [--seqs 1]
        [--branch-mode auto] [--top 25] [--device cuda]

Folds a seeded full-width TactileSR (bf16, ``bench.FLAGSHIP``) for
``--seqs`` frames, traces ``--iters`` forwards with torch.profiler and
prints each op's device time per forward, its calls and its share of the
total.  The roofline line divides the original graph's conv FLOPs
(``bench.sr_flops_per_frame``) by the H100's dense bf16 peak (989
TFLOP/s at 700 W) and sets that against the measured device time.  With
``--device cpu`` the table holds the host ops' own times (a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import bench
from ..models.inference import BRANCH_MODES


def print_table(rows, total_ms, per: str, top: int) -> None:
    print(f"{'ms/' + per:>10}  {'calls':>6}  {'share':>6}  op")
    for name, ms, calls in rows[:top]:
        print(f"{ms:10.4f}  {calls:6.1f}  {100 * ms / total_ms:5.1f}%  {name[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.scripts.profile_serving",
                                description="Per-op device-time table of the fused serving forward")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--seqs", type=int, default=1)
    p.add_argument("--branch-mode", default="auto", choices=("auto",) + BRANCH_MODES,
                   help="MTSR branch layout (models/inference.py rewrite 4)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = bench.require_device(args.device)
    w, seqs = bench.FLAGSHIP, args.seqs
    forward, chans = bench.build_forward(seqs, dev, args.branch_mode)
    x = torch.from_numpy(np.random.default_rng(0).random((args.batch, chans, 4, 4))
                         .astype(np.float32)).to(dev)

    def fwd():
        return forward(x)

    rows, total = bench.op_table(fwd, args.iters, dev)
    where = "device" if dev.type == "cuda" else "host (CPU rehearsal, not device)"
    print(f"device: {json.dumps(bench.device_line(dev))}")
    print(f"seqs={seqs} batch={args.batch} branch_mode={args.branch_mode}: total {where} time "
          f"{total:.3f} ms/iter over {args.iters} iters")
    flops = bench.sr_flops_per_frame(w["scale_factor"], seqs, w["pattern_layers"], w["force_layers"])[0]
    if dev.type == "cuda" and total > 0:
        ideal = flops * args.batch / bench.PEAK_BF16_FLOPS * 1e3
        print(f"{flops / 1e9:.3f} GFLOP/frame of convs -> bf16 roofline {ideal:.2f} ms/iter; measured "
              f"{total:.2f} ms = {100 * ideal / total:.1f}% of the roofline "
              f"({args.batch / total * 1e3:,.0f} frames/s device-side)")
    print()
    print_table(rows, total, "iter", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())

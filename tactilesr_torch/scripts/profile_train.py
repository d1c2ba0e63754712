"""Per-op device-time table of the captured STSR train step (the
counterpart of the root ``scripts/profile_train.py``).

    python -m tactilesr_torch.scripts.profile_train [--batch 256] [--steps 24] [--top 30]
        [--device cuda]

Builds the ``SRTrainer(scan_epochs=True)`` that ``bench --train`` builds
(full-width bf16 STSR, seeded arrays of ``--steps`` steps), trains one warm
epoch (the eager warm-up steps and the capture), then traces ``--steps``
replays of the captured step with torch.profiler and prints each op's
device time per step, its calls and its share, with the step's conv FLOPs
(three forwards) against the H100's dense bf16 peak.  With ``--device cpu``
the step runs uncaptured and the table holds host times (a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from .. import bench
from ..runtime.logger import setup_logger
from .profile_serving import print_table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.scripts.profile_train",
                                description="Per-op device-time table of the captured STSR train step")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = bench.require_device(args.device)
    setup_logger("tactilesr_torch", stream=sys.stderr)
    w, batch, steps = bench.FLAGSHIP, args.batch, args.steps
    with tempfile.TemporaryDirectory(prefix="profile_train_") as work:
        tr = bench.captured_trainer(batch, dev, work, steps)
        tr._scan.k.zero_()  # the replays below train on the warm epoch's rows

        def step():
            tr._scan_one()

        rows, total = bench.op_table(step, steps - 1, dev)  # one step warms inside op_table
    where = "device" if dev.type == "cuda" else "host (CPU rehearsal, not device)"
    flops = 3 * bench.sr_flops_per_frame(w["scale_factor"], 1, w["pattern_layers"], w["force_layers"])[0]
    print(f"device: {json.dumps(bench.device_line(dev))}")
    print(f"STSR train step at B={batch} ({'captured' if tr._graph is not None else 'uncaptured'}): total "
          f"{where} time {total:.3f} ms/step over {steps - 1} steps -> {batch / total * 1e3:,.0f} "
          "samples/s")
    if dev.type == "cuda" and total > 0:
        ideal = flops * batch / bench.PEAK_BF16_FLOPS * 1e3
        print(f"{flops / 1e9:.3f} GFLOP/sample of convs (three forwards) -> bf16 roofline {ideal:.3f} "
              f"ms/step; measured {total:.3f} ms = MFU {100 * ideal / total:.2f}%")
    print()
    print_table(rows, total, "step", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())

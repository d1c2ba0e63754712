"""Readings that the limits of ``tpsf-stage1-train``'s ``correct`` are set
from, in one process.

    python3 perfbench/tools/calibrate_tpsf.py --seconds <s> --seeds 1,2,... \\
        --control-seeds 7,8,9 --replays-skipped-seeds 4,5,6 --state-unchanged-seeds 10,11,12

For each of ``--seeds``: one run of the cell (its driver, a window of
``--seconds``, the check) and its numbers.  For each of
``--control-seeds``: the control's numbers (the reference's physics in one
bf16 pass in the program's place) and a planted fault's (half of each
batch).  For each of ``--replays-skipped-seeds``: a run of the program with
its captured step's replays turned into no-ops; for each of
``--state-unchanged-seeds``: one with its optimizer's step a no-op.  One
JSON line each, then a summary: per number, the largest program reading
and, per kind, the smallest control and fault readings.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

CELL = "tpsf-stage1-train"


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=4.0)
    for opt in ("--seeds", "--control-seeds", "--replays-skipped-seeds", "--state-unchanged-seeds"):
        p.add_argument(opt, default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench import core

    core.set_caches()
    import torch

    from tactilesr_torch.ops.graph import CapturedGraph
    from tactilesr_torch.runtime.optim import AdamL2

    dev = torch.device(args.device)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    prog, least = {}, {}

    def keep_least(kind, nums):
        for k, v in nums.items():
            least.setdefault(kind, {})[k] = min(least.get(kind, {}).get(k, float("inf")), v)

    for s in seeds(args.seeds):
        t = time.perf_counter()
        line, out = core.run(CELL, s, args.seconds, False, dev)
        for k, v in out.checks.items():
            prog[k] = max(prog.get(k, 0.0), v)
        print(json.dumps({"seed": s, "kind": "program", "correct": line["correct"], "checks": out.checks,
                          "metrics": line["metrics"], "memory_peak_bytes": line["device"]["memory_peak_bytes"],
                          "notes": out.notes, "seconds": time.perf_counter() - t}), flush=True)
    for s in seeds(args.control_seeds):
        cell = core.make_cell(CELL, s, args.seconds, False, dev, time.perf_counter())
        for kind, nums in core.load_module("drivers", cell.traffic["driver"]).control(cell).items():
            keep_least(kind, nums)
            print(json.dumps({"seed": s, "kind": kind, "checks": nums}), flush=True)
    for kind, owner, name, value, text in (
            ("replays_skipped", CapturedGraph, "replay", lambda self: None, args.replays_skipped_seeds),
            ("state_unchanged", AdamL2, "step", lambda self, lr: None, args.state_unchanged_seeds)):
        with patched(owner, name, value):
            for s in seeds(text):
                line, out = core.run(CELL, s, args.seconds, False, dev)
                keep_least(kind, out.checks)
                print(json.dumps({"seed": s, "kind": kind, "correct": line["correct"], "checks": out.checks}),
                      flush=True)
    print(json.dumps({"summary": CELL, "program_max": prog, "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

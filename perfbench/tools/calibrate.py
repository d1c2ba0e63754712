"""Readings that the limits of ``correct`` are set from, in one process.

    python3 perfbench/tools/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1,2,... --control-seeds 7,8,9 [--replays-skipped-seeds 4,5,6]

For each of ``--seeds``: one run of the cell (its driver, a window of
``--seconds`` at the cell's load, the check) and its numbers.  For each
of ``--control-seeds``: the control's numbers (the reference in fp8 in the
program's place), and for a training cell a planted fault's (half of each
batch).  For each of ``--replays-skipped-seeds``: a run of the program with
its captured step's replays turned into no-ops (a state left unchanged on
every step after the eager ones).  One JSON line each, then a summary: per
number, the largest program reading and the smallest control and fault
readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--replays-skipped-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench import core

    core.set_caches()
    import torch

    dev = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    prog, fails, requests = {}, {}, 0
    for s in seeds:
        t = time.perf_counter()
        line, out = core.run(args.workload, s, args.seconds, False, dev)
        requests = max(requests, out.attempted)
        for k, v in out.checks.items():
            prog[k] = max(prog.get(k, 0.0), v)
        print(json.dumps({"seed": s, "kind": "program", "correct": line["correct"], "checks": out.checks,
                          "metrics": line["metrics"], "notes": out.notes,
                          "seconds": time.perf_counter() - t}), flush=True)
    for s in ctl:
        cell = core.make_cell(args.workload, s, args.seconds, False, dev, time.perf_counter())
        driver = core.load_module("drivers", cell.traffic["driver"])
        if hasattr(driver, "control"):
            readings = driver.control(cell)
        else:
            from perfbench.common import serving_control

            frames = driver.control_frames(cell, requests or 1)
            readings = {"fp8": serving_control(cell.config, s, frames, dev)}
        for kind, nums in readings.items():
            for k, v in nums.items():
                fails.setdefault(kind, {})[k] = min(fails.get(kind, {}).get(k, float("inf")), v)
            print(json.dumps({"seed": s, "kind": kind, "checks": nums}), flush=True)
    skipped = [int(s) for s in args.replays_skipped_seeds.split(",") if s]
    if skipped:
        from tactilesr_torch.ops.graph import CapturedGraph

        CapturedGraph.replay = lambda self: None
    for s in skipped:
        line, out = core.run(args.workload, s, args.seconds, False, dev)
        for k, v in out.checks.items():
            fails.setdefault("replays_skipped", {})[k] = min(fails.get("replays_skipped", {}).get(k, float("inf")), v)
        print(json.dumps({"seed": s, "kind": "replays_skipped", "correct": line["correct"], "checks": out.checks}),
              flush=True)
    print(json.dumps({"summary": args.workload, "program_max": prog, "least": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

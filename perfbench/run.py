"""Run one cell of the benchmark once, on the cards of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the program's objects for the cell from the seed, warms the cell's
own shapes, drives the cell's entry for ``--seconds``, checks what that
window produced against the plain reference, and prints one JSON line as
the last line of standard output (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, read from a profiled
sub-window).  The numbers that decide ``correct`` are printed beside their
limits as the last lines of standard error and, under ``checks``, last in
the result line; the driver's notes come on the lines before, and the run's record, with the notes,
goes to ``perfbench/_out/<cell>-s<seed>-t<trace>.json``.  Without enough CUDA cards, or where a JAX module was
loaded, it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# run as a script, sys.path[0] is this folder: put the checkout's root there instead
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

FORBIDDEN = ("jax", "jaxlib", "flax", "tactilesr_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 perfbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import core

    core.set_caches()

    chips = core.load_cell(args.workload)["entry"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, out = core.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), t0=T0, chips=chips)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures the port alone", file=sys.stderr)
        return 2
    for note in out.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    record = HERE / "_out" / f"{args.workload}-s{args.seed}-t{args.trace}.json"
    record.parent.mkdir(exist_ok=True)
    record.write_text(json.dumps({"notes": out.notes, "details": out.details, "result": line}))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

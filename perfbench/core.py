"""The harness: find a cell's files by name, run its driver, read its
metrics, judge its outputs, and make the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``, as ``configs[].file`` says) and a
traffic mix (``traffic/<traffic>.json``), whose ``driver`` key names the
code that drives the program (``drivers/<driver>.py``: ``run(cell) ->
Outcome``).  ``workloads/<cell>.json`` holds the limits of the numbers
that decide ``correct``.  A per-layer metric is ``metrics/<name>.py``:
``read(trace) -> float | None``.  Nothing here lists a name: a new cell,
configuration, mix or metric is a new file and an entry in
``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_compute"}


def set_caches() -> None:
    """Point the program's build and kernel caches at fixed directories in
    the checkout (before torch is imported): the first run of a checkout
    builds, the later ones hit."""
    import os

    for var, sub in CACHES.items():
        os.environ[var] = str(PKG / "_cache" / sub)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # time.perf_counter() at the process's start
    scratch: str = ""  # a private directory under TMPDIR, removed after the run


@dataclass
class Outcome:
    e2e: dict  # end-to-end metric name -> value (setup_s is the harness's)
    attempted: int
    failed: int
    checks: dict  # number name -> value, judged against the cell's limits
    window_start: float  # time.perf_counter() at the first timed call
    ok: bool = True  # False where the driver saw an answer that never came
    trace: object = None  # devtrace.Trace of a --trace 1 run
    memory_peak: int = 0
    notes: list = field(default_factory=list)  # lines for standard error
    details: dict = field(default_factory=dict)  # readings for the run's record


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark (a driver or a metric's reader)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry with its configuration, traffic and limits read."""
    bench = bench or read_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    return dict(entry=entry, config=read_json(REPO / conf),
                traffic=read_json(PKG / "traffic" / f"{entry['traffic']}.json"),
                limits=read_json(PKG / "workloads" / f"{name}.json")["limits"])


def cell_metrics(name: str, bench: dict) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def make_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
              overrides: dict | None = None) -> Cell:
    spec = load_cell(name)
    over = overrides or {}
    return Cell(name=name, config={**spec["config"], **over.get("config", {})},
                traffic={**spec["traffic"], **over.get("traffic", {})},
                limits=spec["limits"], seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=device, t0=t0)


def drive(cell: Cell) -> Outcome:
    with tempfile.TemporaryDirectory(prefix="perfbench-") as scratch:
        cell.scratch = scratch
        return load_module("drivers", cell.traffic["driver"]).run(cell)


def result_line(cell: Cell, out: Outcome, bench: dict, chips: int) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, [breakdown], and last the numbers judged with their limits."""
    from .reference.compare import judge

    e2e, layer = cell_metrics(cell.name, bench)
    metrics = {}
    if cell.trace:
        for m in layer:
            v = load_module("metrics", m["name"]).read(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.window_start - cell.t0)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": _device_kind(dev), "count": chips, "memory_peak_bytes": out.memory_peak}
    line = {"correct": bool(out.ok and judge(out.checks, cell.limits)),
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s()
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": _num(out.checks.get(k, math.inf)), "limit": lim}
                      for k, lim in cell.limits.items()}
    return line


def _num(x: float):
    return x if math.isfinite(x) else "inf"


def _device_kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(name: str, seed: int, seconds: float, trace: bool, device, t0: float | None = None,
        chips: int = 1, overrides: dict | None = None) -> tuple[dict, Outcome]:
    """One run of cell ``name``: (the result line, the driver's outcome)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = read_json(REPO / "BENCHMARK.json")
    cell = make_cell(name, seed, seconds, trace, device, t0, overrides)
    out = drive(cell)
    return result_line(cell, out, bench, chips), out

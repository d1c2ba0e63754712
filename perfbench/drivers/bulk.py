"""Bulk serving: one caller, requests of a fixed size back to back, through
``tactilesr_torch.serving.SRPredictor.predict`` (default buckets, fused
graph, the configuration's serving dtype).

Traffic keys: ``frames_per_request``, ``distinct_requests`` (inputs made in
set-up and cycled), ``reading_range``, ``checked_rows``,
``traced_requests``.  ``frames_per_s``: frames of every request completed,
over the time from the window's start to the end of the last one.  The
window keeps every answer; after it, the check draws ``checked_rows``
(request, row) pairs from the seed among all of them and compares those
rows with the f32 reference, so a run compares as many rows whatever its
length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.common import free_program, peak_memory, program_widths, serving_check, write_checkpoint
from perfbench.core import Outcome
from perfbench.devtrace import Spans, traced
from perfbench.inputs import norm_seed, readings
from perfbench.weights import seeded_state_dict
from perfbench.workcount import config_flops_per_frame, frame_bytes


def run(cell) -> Outcome:
    from tactilesr_torch.serving import SRPredictor

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    n = tr["frames_per_request"]
    lo, hi = tr["reading_range"]
    chans = cfg["seqsCnt"] * cfg["axisCnt"]
    state = seeded_state_dict(cfg, cell.seed, dev)
    pred = SRPredictor(write_checkpoint(state, cell.scratch), device=dev, **program_widths(cfg))
    inputs = [readings(cell.seed, i, n, chans, lo, hi) for i in range(tr["distinct_requests"])]
    pred.predict(inputs[0])  # the cell's only shapes: its buckets, chunk by chunk
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    answers = []
    t_start = time.perf_counter()
    while True:
        answers.append(pred.predict(inputs[len(answers) % len(inputs)]))
        t_end = time.perf_counter()
        if t_end - t_start >= cell.seconds:
            break
    done = len(answers)
    fps = done * n / (t_end - t_start)

    trace = None
    if cell.trace:
        spans = Spans()
        with traced(spans, dev.type == "cuda") as trace:
            for i in range(tr["traced_requests"]):
                with spans.span("predict", rows=n):
                    pred.predict(inputs[i % len(inputs)])
        trace.counters = dict(frames=tr["traced_requests"] * n, frames_per_s=fps, chunk_rows=pred.buckets[-1],
                              flops_per_frame=config_flops_per_frame(cfg), bytes_per_frame=frame_bytes(cfg))
    memory = peak_memory(dev)
    del pred
    free_program(dev)

    req, rows = checked_rows(cell, done)
    frames = np.stack([inputs[q % len(inputs)][r] for q, r in zip(req, rows)])
    checks = serving_check(cfg, state, frames, np.stack([answers[q][r] for q, r in zip(req, rows)]), dev)
    return Outcome(e2e={"frames_per_s": fps}, attempted=done, failed=0, checks=checks, window_start=t_start,
                   trace=trace, memory_peak=memory, details={"window_s": t_end - t_start},
                   notes=[f"{done} requests of {n} frames in {t_end - t_start:.3f} s; "
                          f"{len(rows)} rows checked"])


def checked_rows(cell, requests: int):
    """(request, row) index arrays of the rows the check compares."""
    rng = np.random.default_rng([norm_seed(cell.seed), 4])
    k = cell.traffic["checked_rows"]
    return rng.integers(0, requests, size=k), rng.integers(0, cell.traffic["frames_per_request"], size=k)


def control_frames(cell, requests: int) -> np.ndarray:
    """The rows a run of ``requests`` requests checks, drawn as it draws them."""
    tr, cfg = cell.traffic, cell.config
    lo, hi = tr["reading_range"]
    chans = cfg["seqsCnt"] * cfg["axisCnt"]
    req, rows = checked_rows(cell, requests)
    return np.stack([readings(cell.seed, q % tr["distinct_requests"], tr["frames_per_request"], chans, lo, hi)[r]
                     for q, r in zip(req, rows)])

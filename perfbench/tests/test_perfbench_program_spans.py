"""The readers of the program's spans (``perfbench/program_spans.py`` and
the five ``program_span`` metrics) on synthetic windows, then on toy runs
of the cells on the CPU."""

import sys

import pytest
import torch

from perfbench import core
from perfbench.devtrace import Trace
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing
from tactilesr_torch.runtime.tracing import Span

MS = 1_000_000
SERVING = ("serving.input_ms_per_chunk.bulk", "serving.launch_ms_per_chunk.bulk",
           "serving.output_ms_per_chunk.bulk")
TRAINING = ("trainer.epoch_host_ms.train", "trainer.replay_idle_ms.train")


def _ms(*bounds):
    return [round(b * MS) for b in bounds]


def _serving_window():
    """One request of two 1024-frame chunks.  Per chunk (from o): prepare
    [o, o+1] all idle; h2d [o+1, o+3] with a 0.5 ms copy; launch [o+3, o+6]
    with kernels from o+3.5 to o+30; fetch [o+6, o+40] with a 1 ms copy
    at o+31, so 9 ms idle.  Assemble [81, 85], all idle; the root [1, 86];
    the harness's span [0.5, 87]."""
    recs, device = [], []
    root = Span(*_ms(1, 86), "serving.predict", 1, None, 1, {"frames": 2048, "chunks": 2})
    sid = 2
    for o in (1, 41):
        for a, b, name in ((0, 1, "serving.prepare"), (1, 3, "serving.h2d"), (3, 6, "serving.launch"),
                           (6, 40, "serving.fetch")):
            recs.append(Span(*_ms(o + a, o + b), name, sid, 1, 1, {}))
            sid += 1
        device += [(*_ms(o + 2, o + 2.5), "Memcpy HtoD"), (*_ms(o + 3.5, o + 30), "conv"),
                   (*_ms(o + 31, o + 32), "Memcpy DtoH")]
    recs += [Span(*_ms(81, 85), "serving.assemble", sid, 1, 1, {}), root]
    trace = Trace(0, 100 * MS, device=device, spans=[(*_ms(0.5, 87), "predict", {"rows": 2048})],
                  counters={"chunk_rows": 1024})
    return trace, recs


def _training_window():
    """Two epochs of 100 ms: prepare [0, 5] idle; replays [5, 90] with the
    device busy from 6 to 89.5 but for [40, 41] (2.5 ms idle); fetch
    [90, 92] with a 0.2 ms copy (1.8 idle); log [92, 99] idle."""
    recs, device = [], []
    for e, o in enumerate((0, 100)):
        root = 10 * e + 1
        recs.append(Span(*_ms(o, o + 100), "trainer.epoch", root, None, root, {"steps": 84}))
        for k, (a, b, name) in enumerate(((0, 5, "trainer.prepare"), (5, 90, "trainer.replays"),
                                          (90, 92, "trainer.fetch"), (92, 99, "trainer.log"))):
            recs.append(Span(*_ms(o + a, o + b), name, root + k + 1, root, root, {}))
        device += [(*_ms(o + 6, o + 40), "step"), (*_ms(o + 41, o + 89.5), "step"),
                   (*_ms(o + 90.2, o + 90.4), "Memcpy DtoH")]
    return Trace(0, 200 * MS, device=device), recs


@pytest.fixture
def program(monkeypatch):
    """Put ``records`` in the program's buffer, with ``dropped`` records lost."""
    def put(records, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(records))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


def _read(name, trace):
    return core.load_module("metrics", name).read(trace)


def test_serving_readers_split_the_host_time_per_chunk(program):
    trace, recs = _serving_window()
    program(recs)
    got = [_read(n, trace) for n in SERVING]
    assert got == pytest.approx([(1 + 1.5) * 2 / 2, 0.5 * 2 / 2, (9 * 2 + 4) / 2])
    host = _read("serving.host_ms_per_chunk.bulk", trace)
    assert host == pytest.approx((86.5 - 2 * 28) / 2)
    assert sum(got) <= host  # the rest: the root's and the harness's edges, 2.5 ms over 2 chunks
    assert host - sum(got) == pytest.approx(2.5 / 2)


def test_training_readers_split_the_idle_per_epoch(program):
    trace, recs = _training_window()
    program(recs)
    boundary, replays = (_read(n, trace) for n in TRAINING)
    assert (boundary, replays) == pytest.approx((5 + 1.8 + 7, 1 + 0.5 + 1))
    idle_ms = _read("device.idle_share.train", trace) / 100 * trace.window_s() * 1e3
    assert idle_ms == pytest.approx(2 * (5 + 2.5 + 1.8 + 7 + 1))
    assert 2 * (boundary + replays) == pytest.approx(idle_ms, rel=0.1)


def test_records_outside_the_window_are_left_out(program):
    trace, recs = _serving_window()
    early = [r._replace(start_ns=r.start_ns - 10**12, end_ns=r.end_ns - 10**12, id=r.id + 100) for r in recs]
    program(early + recs)
    assert _read(SERVING[0], trace) == pytest.approx(2.5)


@pytest.mark.parametrize("name", SERVING + TRAINING)
@pytest.mark.parametrize("case", ["no_tracer", "dropped", "no_spans", "no_window"])
def test_readers_read_nothing_they_cannot_trust(name, case, program, monkeypatch):
    trace, recs = (_serving_window if name in SERVING else _training_window)()
    if case == "no_tracer":  # a program without the tracer, as the parent of these readers
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    assert _read(name, trace if case != "no_window" else None) is None


@pytest.mark.parametrize("cell, names", [("stsr-serve-bulk", SERVING), ("stsr-train-b32", TRAINING)])
def test_a_traced_toy_run_reports_the_span_metrics(cell, names, toy):
    """The program's own spans in a ``--trace 1`` run at toy widths on the
    CPU (no device events there: the whole span counts as idle)."""
    tracing.clear()
    line, out = core.run(cell, 2**31 + 211, 0.5, True, torch.device("cpu"), overrides=toy[cell])
    for n in names:
        assert line["metrics"][n]["value"] > 0 and line["metrics"][n]["unit"] == "ms", n
    if cell == "stsr-serve-bulk":
        host = line["metrics"]["serving.host_ms_per_chunk.bulk"]["value"]
        assert sum(line["metrics"][n]["value"] for n in names) <= host

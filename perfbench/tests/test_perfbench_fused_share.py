"""The reader of ``graph.fused_conv_share.bulk``: the conv counts that the
program puts on its ``serving.launch`` spans, on synthetic windows, then
on a toy run of a bulk cell on the CPU, where nothing is fused."""

import sys

import pytest
import torch

from perfbench import core
from test_perfbench_program_spans import _serving_window
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing

NAME = "graph.fused_conv_share.bulk"


@pytest.fixture
def program(monkeypatch):
    """Put ``records`` in the program's buffer, with ``dropped`` records lost."""
    def put(records, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(records))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


def _read(trace):
    return core.load_module("metrics", NAME).read(trace)


def _counted(recs, *counts):
    """The window's ``serving.launch`` records, each with one chunk's counts."""
    chunks = iter(counts)
    return [r._replace(attrs=dict(zip(("convs", "fused_convs"), next(chunks))))
            if r.name == "serving.launch" else r for r in recs]


def test_the_share_of_the_windows_conv_calls(program):
    trace, recs = _serving_window()
    program(_counted(recs, (39, 32), (39, 29)))
    assert _read(trace) == pytest.approx(100 * 61 / 78)
    program(_counted(recs, (39, 0), (39, 0)))  # the CPU's decomposition
    assert _read(trace) == 0
    early = [r._replace(start_ns=r.start_ns - 10**12, end_ns=r.end_ns - 10**12, id=r.id + 100)
             for r in _counted(recs, (39, 0), (39, 0))]
    program(early + _counted(recs, (39, 39), (39, 39)))  # only the window's chunks count
    assert _read(trace) == 100


@pytest.mark.parametrize("case", ["no_tracer", "dropped", "no_spans", "no_window", "no_counts"])
def test_the_share_reads_nothing_it_cannot_trust(case, program, monkeypatch):
    trace, recs = _serving_window()
    if case != "no_counts":  # launch spans without counts: a program that does not count its convs
        recs = _counted(recs, (39, 32), (39, 32))
    if case == "no_tracer":  # a program without the tracer
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    assert _read(trace if case != "no_window" else None) is None


def test_a_traced_toy_run_reports_the_share(toy):
    tracing.clear()
    line, _ = core.run("stsr-serve-bulk", 2**31 + 217, 0.5, True, torch.device("cpu"),
                       overrides=toy["stsr-serve-bulk"])
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}

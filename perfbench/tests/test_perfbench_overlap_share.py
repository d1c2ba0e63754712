"""The reader of ``serving.overlapped_chunk_share.bulk``: the ``overlapped``
and ``chunks`` that the program puts on its ``serving.predict`` spans, on
synthetic windows, then on a toy run of a bulk cell on the CPU."""

import sys

import pytest
import torch

from perfbench import core
from test_perfbench_program_spans import _serving_window
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing

NAME = "serving.overlapped_chunk_share.bulk"
EARLY_NS = 10**12  # far before the window


@pytest.fixture
def program(monkeypatch):
    """Put ``records`` in the program's buffer, with ``dropped`` records lost."""
    def put(records, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(records))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


def _read(trace):
    return core.load_module("metrics", NAME).read(trace)


def _requests(recs, *attrs, shift_ns=0):
    """The window's ``serving.predict`` record once for each of ``attrs``
    (its attrs then), moved ``shift_ns`` earlier."""
    (root,) = [r for r in recs if r.name == "serving.predict"]
    return [root._replace(start_ns=root.start_ns - shift_ns, end_ns=root.end_ns - shift_ns,
                          id=root.id + 1000 * k, root_id=root.id + 1000 * k, attrs=a)
            for k, a in enumerate(attrs)]


def test_seven_of_every_eight_chunks_overlap(program):
    trace, recs = _serving_window()
    eight = {"frames": 8192, "chunks": 8, "overlapped": 7}
    program(_requests(recs, eight, eight, eight))
    assert _read(trace) == 87.5
    program(_requests(recs, eight, {"frames": 5, "chunks": 1, "overlapped": 0}))
    assert _read(trace) == pytest.approx(100 * 7 / 9)


def test_only_the_windows_requests_count(program):
    trace, recs = _serving_window()
    early = _requests(recs, {"frames": 8192, "chunks": 8, "overlapped": 0}, shift_ns=EARLY_NS)
    program(early + _requests(recs, {"frames": 8192, "chunks": 8, "overlapped": 7}))
    assert _read(trace) == 87.5
    program(early)  # a window with none of the program's requests
    assert _read(trace) is None


@pytest.mark.parametrize("case", ["no_attribute", "no_tracer", "dropped", "no_spans", "no_window"])
def test_the_share_reads_nothing_it_cannot_trust(case, program, monkeypatch):
    trace, recs = _serving_window()
    if case != "no_attribute":  # a program that does not pipeline its chunks has chunks only
        recs = [r for r in recs if r.name != "serving.predict"] + _requests(
            recs, {"frames": 2048, "chunks": 2, "overlapped": 1})
    if case == "no_tracer":  # a program without the tracer
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    assert _read(trace if case != "no_window" else None) is None


def test_a_traced_toy_run_reports_the_share(toy):
    """Requests of 2,100 frames: chunks of 1,024, 1,024 and 52 (padded into
    64), of which the first two are fetched after the next is enqueued."""
    tracing.clear()
    over = {"config": toy["stsr-serve-bulk"]["config"],
            "traffic": {**toy["stsr-serve-bulk"]["traffic"], "frames_per_request": 2100}}
    line, _ = core.run("stsr-serve-bulk", 2**31 + 219, 0.5, True, torch.device("cpu"), overrides=over)
    assert line["correct"]
    assert line["metrics"][NAME] == {"value": pytest.approx(100 * 2 / 3), "unit": "%"}

"""The reader of ``kernels.channels_last_share.train``: the conv and
BatchNorm counts that the program puts on its ``trainer.replays`` spans,
on synthetic windows, then on a toy run of the training cell on the CPU,
where every layer runs NCHW."""

import sys

import pytest
import torch

from perfbench import core
from test_perfbench_program_spans import _training_window
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing

NAME = "kernels.channels_last_share.train"


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
    """The window's ``trainer.replays`` records, each with one epoch's
    (sr_conv, sr_conv_nhwc, sr_bn, sr_bn_nhwc) among other counters."""
    epochs = iter(counts)
    keys = ("sr_conv", "sr_conv_nhwc", "sr_bn", "sr_bn_nhwc")
    return [r._replace(attrs=dict(r.attrs, launches=dict(zip(keys, next(epochs)), tpsf_physics=0)))
            if r.name == "trainer.replays" else r for r in recs]


def test_the_share_of_the_windows_convs_and_batchnorms(program):
    trace, recs = _training_window()
    program(_counted(recs, (38 * 84, 38 * 84, 27 * 84, 27 * 84), (38 * 84, 38 * 84, 27 * 84, 27 * 84)))
    assert _read(trace) == 100
    program(_counted(recs, (38 * 84, 36 * 84, 27 * 84, 27 * 84), (38 * 84, 36 * 84, 27 * 84, 27 * 84)))
    assert _read(trace) == pytest.approx(100 * 63 / 65)
    program(_counted(recs, (38, 0, 27, 0), (38, 38, 27, 27)))  # one NCHW epoch, one NHWC
    assert _read(trace) == 50
    early = [r._replace(start_ns=r.start_ns - 10**12, end_ns=r.end_ns - 10**12, id=r.id + 100)
             for r in _counted(recs, (38, 0, 27, 0), (38, 0, 27, 0))]
    program(early + _counted(recs, (38, 38, 27, 27), (38, 38, 27, 27)))  # only the window's epochs count
    assert _read(trace) == 100


@pytest.mark.parametrize("case", ["no_tracer", "dropped", "no_spans", "no_window", "no_launches",
                                  "no_layer_counts"])
def test_the_share_reads_nothing_it_cannot_trust(case, program, monkeypatch):
    trace, recs = _training_window()
    if case == "no_layer_counts":  # counters, but none of the layers' (a program that does not count them)
        recs = [r._replace(attrs=dict(r.attrs, launches={"tpsf_physics": 0})) if r.name == "trainer.replays"
                else r for r in recs]
    elif case != "no_launches":
        recs = _counted(recs, (38, 38, 27, 27), (38, 38, 27, 27))
    if case == "no_tracer":  # a program without the tracer
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    assert _read(trace if case != "no_window" else None) is None


def test_a_traced_toy_run_reports_the_share(toy):
    tracing.clear()
    line, _ = core.run("stsr-train-b32", 2**31 + 223, 0.5, True, torch.device("cpu"),
                       overrides=toy["stsr-train-b32"])
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}

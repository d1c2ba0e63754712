"""The readers of ``optim.launches_per_step.{train,tpsf,seqs}``: the
optimizer kernel's ``adam_l2`` count that the program puts on its
``trainer.replays`` spans, over the window's steps, on synthetic windows,
then on a toy run of the training cell on the CPU, where no kernel runs."""

import sys

import pytest
import torch

from perfbench import core
from test_perfbench_program_spans import _training_window
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing

NAMES = [f"optim.launches_per_step.{c}" for c in ("train", "tpsf", "seqs")]


@pytest.fixture
def program(monkeypatch):
    """Put ``records`` in the program's buffer, with ``dropped`` records lost."""
    def put(records, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(records))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


def _counted(recs, *counts):
    """The window's ``trainer.replays`` records (two epochs of 84 steps),
    each with one epoch's ``adam_l2`` launches among other counters; a
    count of None leaves ``adam_l2`` out (a program without the kernel)."""
    epochs = iter(counts)

    def launches():
        n = next(epochs)
        return {"tpsf_physics": 0} if n is None else {"tpsf_physics": 0, "adam_l2": n}

    return [r._replace(attrs=dict(r.attrs, launches=launches())) if r.name == "trainer.replays" else r
            for r in recs]


@pytest.mark.parametrize("name", NAMES)
def test_launches_over_the_windows_steps(name, program):
    trace, recs = _training_window()
    read = core.load_module("metrics", name).read
    program(_counted(recs, 84, 84))
    assert read(trace) == 1.0
    program(_counted(recs, 168, 168))  # the step counters in a launch of their own
    assert read(trace) == 2.0
    program(_counted(recs, 0, 84))  # one epoch on a path without the kernel
    assert read(trace) == 0.5


@pytest.mark.parametrize("case", ["no_counter", "no_tracer", "dropped", "no_spans", "no_window"])
def test_reads_nothing_where_the_program_has_no_counter(case, program, monkeypatch):
    """The parent's program counts no ``adam_l2``: its window reads nothing,
    as does a window with no tracer, dropped records or no spans."""
    trace, recs = _training_window()
    recs = _counted(recs, None, None) if case == "no_counter" else _counted(recs, 84, 84)
    if case == "no_tracer":
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    for name in NAMES:
        assert core.load_module("metrics", name).read(trace if case != "no_window" else None) is None


def test_a_traced_toy_run_reads_no_kernel_on_the_cpu(toy):
    tracing.clear()
    line, _ = core.run("stsr-train-b32", 2**31 + 224, 0.5, True, torch.device("cpu"),
                       overrides=toy["stsr-train-b32"])
    assert line["metrics"]["optim.launches_per_step.train"] == {"value": 0.0, "unit": "launches"}

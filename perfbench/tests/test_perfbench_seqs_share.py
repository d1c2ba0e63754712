"""The readers of ``kernels.branch_channels_last_share.seqs`` (the
pattern-branch conv counts that the program puts on its
``trainer.replays`` spans) and ``kernels.layout_copy_share.seqs`` (cuDNN's
layout transposes in the device trace) on hand-made windows, then a traced
toy run of the MTSR training cell on the CPU."""

import sys

import pytest
import torch

from perfbench import core
from perfbench.devtrace import Trace
from test_perfbench_program_spans import _training_window
import tactilesr_torch.runtime
from tactilesr_torch.runtime import tracing

BRANCH, LAYOUT = "kernels.branch_channels_last_share.seqs", "kernels.layout_copy_share.seqs"
MS = 1_000_000
TOY = {"config": {"scale_factor": 2, "patternFeatureExtraLayerCnt": 1},
       "traffic": {"batch": 4, "steps_per_epoch": 6, "traced_epochs": 1}}


@pytest.fixture
def program(monkeypatch):
    """Put ``records`` in the program's buffer, with ``dropped`` records lost."""
    def put(records, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(records))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


def _read(name, trace):
    return core.load_module("metrics", name).read(trace)


def _counted(recs, *counts):
    """The window's ``trainer.replays`` records, each with one epoch's
    (sr_branch_conv, sr_branch_conv_nhwc) beside the other layer counts."""
    epochs = iter(counts)
    return [r._replace(attrs=dict(r.attrs, launches=dict(zip(("sr_branch_conv", "sr_branch_conv_nhwc"), next(epochs)),
                                                          sr_conv=53 * 63, sr_conv_nhwc=45 * 63)))
            if r.name == "trainer.replays" else r for r in recs]


def test_the_share_of_the_windows_branch_convs(program):
    trace, recs = _training_window()
    program(_counted(recs, (14 * 63, 7 * 63), (14 * 63, 7 * 63)))
    assert _read(BRANCH, trace) == 50
    program(_counted(recs, (14 * 63, 14 * 63), (14 * 63, 14 * 63)))
    assert _read(BRANCH, trace) == 100
    program(_counted(recs, (14, 0), (14, 7)))  # one NCHW epoch, one half NHWC
    assert _read(BRANCH, trace) == 25
    early = [r._replace(start_ns=r.start_ns - 10**12, end_ns=r.end_ns - 10**12, id=r.id + 100)
             for r in _counted(recs, (14, 0), (14, 0))]
    program(early + _counted(recs, (14, 14), (14, 14)))  # only the window's epochs count
    assert _read(BRANCH, trace) == 100


@pytest.mark.parametrize("case", ["no_tracer", "dropped", "no_spans", "no_window", "no_launches",
                                  "no_branch_counts"])
def test_the_branch_share_reads_nothing_it_cannot_trust(case, program, monkeypatch):
    trace, recs = _training_window()
    if case == "no_branch_counts":  # the layer counts, but not the branches' (a program that does not count them)
        recs = [r._replace(attrs=dict(r.attrs, launches={"sr_conv": 53, "sr_conv_nhwc": 45}))
                if r.name == "trainer.replays" else r for r in recs]
    elif case != "no_launches":
        recs = _counted(recs, (14, 7), (14, 7))
    if case == "no_tracer":  # a program without the tracer
        monkeypatch.setitem(sys.modules, "tactilesr_torch.runtime.tracing", None)
        monkeypatch.delattr(tactilesr_torch.runtime, "tracing")
    program(recs if case != "no_spans" else [], dropped=int(case == "dropped"))
    assert _read(BRANCH, trace if case != "no_window" else None) is None


def _device_window(*ops):
    """A 100 ms window; ``ops`` are (start_ms, end_ms, name)."""
    return Trace(0, 100 * MS, device=[(round(s * MS), round(e * MS), n) for s, e, n in ops])


def test_the_layout_copy_share_of_device_busy():
    nchw_to_nhwc = "void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true>(...)"
    nhwc_to_nchw = "void cudnn::ops::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, true, false>(...)"
    conv = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
    trace = _device_window((10, 50, conv), (50, 54, nchw_to_nhwc), (60, 80, conv), (80, 81, nhwc_to_nchw),
                           (98, 103, nchw_to_nhwc),  # clipped to the window: 2 ms of it count
                           (-5, -1, nchw_to_nhwc))  # before the window: none
    assert _read(LAYOUT, trace) == pytest.approx(100 * 7 / 67)
    assert _read(LAYOUT, _device_window((10, 50, conv), (60, 61, "Memcpy DtoH"))) == 0  # work, no transpose
    assert _read(LAYOUT, _device_window()) is None  # no device work: nothing to read
    assert _read(LAYOUT, None) is None


def test_a_traced_toy_run_reports_the_branch_share():
    """On the CPU every layer runs NCHW: the branch share reads 0, and the
    device readers, with no device trace, read nothing."""
    tracing.clear()
    line, _ = core.run("mtsr7-train-b32", 2**31 + 229, 0.5, True, torch.device("cpu"), overrides=TOY)
    assert line["metrics"][BRANCH] == {"value": 0.0, "unit": "%"}
    assert LAYOUT not in line["metrics"] and "kernels_roofline.seqs" not in line["metrics"]
    assert line["metrics"]["train_mfu.seqs"]["value"] > 0

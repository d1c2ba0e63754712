"""The port's program spans (``tactilesr_torch/runtime/tracing.py``) on the
CPU: off without a profiler; under one, the tree of ``SRPredictor.predict``
(on the calling thread and on a ``MicroBatcher`` worker) and of a
``scan_epochs`` epoch, on the clock of the profiler's own events, with the
served maps unchanged."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tactilesr_torch.models.tactile_sr import TactileSR
from tactilesr_torch.runtime import tracing
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.server import MicroBatcher
from tactilesr_torch.serving import SRPredictor
from test_torch_scan import _lin_trainer

BUCKETS = (4, 16)
FRAMES = 2 * 16 + 5  # two chunks of 16, then 5 rows padded into 16
CHUNK = ("serving.prepare", "serving.h2d", "serving.launch", "serving.fetch")
EPOCH = ("trainer.prepare", "trainer.replays", "trainer.fetch", "trainer.log")
CLOCK_NS = 500_000  # the tracer's clock against the profiler's events


@pytest.fixture(autouse=True)
def _one_thread_and_no_records():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(prev)


@pytest.fixture
def predictor(tmp_path):
    torch.manual_seed(0)
    model = TactileSR(scale_factor=2, pattern_feature_extra_layer_cnt=1, force_feature_extra_layer_cnt=1)
    path = save_checkpoint_file(str(tmp_path / "m.pth"), model.state_dict())
    return SRPredictor(path, scale_factor=2, pattern_layers=1, force_layers=1, compute_dtype="float32",
                       buckets=BUCKETS, device="cpu")


def _frames(n=FRAMES):
    return (np.random.default_rng(7).random((n, 3, 4, 4)) * 4).astype(np.float32)


def _children(recs, root):
    kids = sorted((r for r in recs if r.parent_id == root.id), key=lambda r: r.start_ns)
    assert all(r.root_id == root.id for r in recs if r.id != root.id)
    for r in kids:
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns, r
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    return kids


def test_span_is_the_shared_noop_without_a_profiler(predictor):
    a, b = tracing.span("x"), tracing.span("y", frames=1)
    assert a is b and a is tracing._OFF
    with a as sp:
        sp.set(chunks=2)
    predictor.predict(_frames())
    assert tracing.records() == [] and tracing.dropped() == 0


def _on_the_worker(predictor, frames):
    batcher = MicroBatcher(predictor, linger_ms=0.5)
    try:
        out = batcher.submit(frames)
    finally:
        batcher.shutdown()
    return out


@pytest.mark.parametrize("thread", ["caller", "microbatcher"])
def test_predict_spans_form_one_tree_per_request(predictor, thread):
    """One ``serving.predict`` with ``frames`` and ``chunks``, then per chunk
    prepare, h2d, launch and fetch, then assemble: children of the root,
    inside it and in turn.  The maps are bit-equal to an unprofiled call's."""
    frames = _frames()
    want = predictor.predict(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = predictor.predict(frames) if thread == "caller" else _on_the_worker(predictor, frames)
    np.testing.assert_array_equal(got, want)
    recs = tracing.records()
    (root,) = [r for r in recs if r.name == "serving.predict"]
    assert root.parent_id is None and root.root_id == root.id
    assert root.attrs == {"frames": FRAMES, "chunks": 3}
    kids = _children(recs, root)
    assert [r.name for r in kids] == list(CHUNK) * 3 + ["serving.assemble"]
    assert len(recs) == 1 + len(kids)
    if thread == "caller":  # the profiler records the ops of the thread that started it
        _launch_ops_inside_the_spans(prof, [r for r in kids if r.name == "serving.launch"])


def _launch_ops_inside_the_spans(prof, spans):
    """Each span is a ``serving.launch`` annotation in the profile, and every
    ``aten::`` op inside the annotation lies in the span, on one clock.  (The
    annotation itself opens before the span's first clock reading and closes
    after its last, by as long as the thread waits for a core.)"""
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type().name == "CPU"]
    marks = sorted((e for e in events if e.name() == "serving.launch"), key=lambda e: e.start_ns())
    assert len(marks) == len(spans)
    for mark, sp in zip(marks, spans):
        lo, hi = mark.start_ns(), mark.start_ns() + mark.duration_ns()
        ops = [e for e in events if e.name().startswith("aten::") and lo <= e.start_ns() < hi]
        assert any(e.name() == "aten::conv2d" for e in ops)
        for e in ops:
            assert sp.start_ns - CLOCK_NS <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns + CLOCK_NS


def test_scan_epoch_spans(tmp_path):
    """Each ``scan_epochs`` epoch is one ``trainer.epoch`` (``steps``) over
    prepare, replays (every step eager on the CPU, none captured), fetch and
    log."""
    t = _lin_trainer(tmp_path, max_epochs=2, scan_epochs=True)
    with profile(activities=[ProfilerActivity.CPU]):
        t.train(auto_resume=False)
    recs = tracing.records()
    epochs = sorted((r for r in recs if r.name == "trainer.epoch"), key=lambda r: r.start_ns)
    assert len(epochs) == 2
    for ep in epochs:
        assert ep.parent_id is None and ep.attrs == {"steps": t.epoch_len}
        kids = _children([r for r in recs if r.root_id == ep.id], ep)
        assert [r.name for r in kids] == list(EPOCH)
        assert kids[1].attrs == {"eager": t.epoch_len, "captured": 0}
    assert len(recs) == 2 * (1 + len(EPOCH))


def test_the_buffer_drops_its_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "TRACER", tracing.Tracer(capacity=2))
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with tracing.span(name):
                pass
    assert [r.name for r in tracing.records()] == ["b", "c"] and tracing.dropped() == 1
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_a_span_closes_when_its_block_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(FloatingPointError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    raise FloatingPointError
        with tracing.span("after"):
            pass
    inner, outer, after = tracing.records()
    assert (inner.name, outer.name, after.name) == ("inner", "outer", "after")
    assert inner.parent_id == outer.id and after.parent_id is None and after.root_id == after.id


def test_a_torch_without_the_flag_leaves_tracing_off(monkeypatch):
    import importlib

    import torch.autograd.profiler as autograd_profiler

    monkeypatch.delattr(autograd_profiler, "_is_profiler_enabled")
    try:
        importlib.reload(tracing)
        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing.span("x") is tracing._OFF
    finally:
        monkeypatch.undo()
        importlib.reload(tracing)
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("x") is not tracing._OFF

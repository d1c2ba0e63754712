"""The ``tpsf-stage1-train`` cell's own pieces on the CPU: a sound toy run
is correct and runs with the timed path broken are not (the control of the
check itself), the bf16-physics control fails the cell's limits, and the
cell's readers on synthetic windows (the physics kernels' roofline and
share, the program's launch counts a step)."""

import pytest
import torch

from perfbench import core
from perfbench.devtrace import Trace
from perfbench.physics_count import BACKWARD_FLOPS, FORWARD_FLOPS, MLP_FLOPS, kernel_least_seconds
from perfbench.reference.compare import judge
from tactilesr_torch.runtime import tracing
from tactilesr_torch.runtime.tracing import Span

CELL = "tpsf-stage1-train"
CPU = torch.device("cpu")
SEED = 2**31 + 181
# toy traffic; the MLP in f32, so that a sound run's gaps are f32 rounding at B=4
TOY = {"config": {"compute_dtype": "float32"},
       "traffic": {"batch": 4, "steps_per_epoch": 6, "distinct_depths": 3, "traced_epochs": 1}}
MS = 1_000_000


def _half_batch(monkeypatch):
    from tactilesr_torch.runtime.trainer import Trainer

    gather = Trainer._gather

    def half(self, idx, mask):
        keep = torch.ones_like(mask)
        keep[mask.shape[0] // 2:] = 0
        return gather(self, idx, mask * keep)  # the loss's mean over the rest

    monkeypatch.setattr(Trainer, "_gather", half)


def _state_unchanged(monkeypatch):
    from tactilesr_torch.runtime.optim import AdamL2

    monkeypatch.setattr(AdamL2, "step", lambda self, lr: None)


@pytest.mark.parametrize("fault", [None, _half_batch, _state_unchanged], ids=["sound", "half_batch", "state_unchanged"])
def test_only_a_sound_run_is_correct(fault, monkeypatch):
    if fault:
        fault(monkeypatch)
    line, _ = core.run(CELL, SEED, 0.3, False, CPU, overrides=TOY)
    assert line["correct"] == (fault is None), line["checks"]


def test_the_physics_gaps_read_the_steps_own_backward(monkeypatch):
    """A step whose (alpha, beta, m) gradient is 1% off fails
    ``abm_grad_gap`` alone: the gap reads what the step's backward took."""
    from tactilesr_torch.models import tpsf_net

    class OnePercentOff(torch.autograd.Function):
        @staticmethod
        def forward(ctx, abm):
            return abm.view_as(abm)

        @staticmethod
        def backward(ctx, g):
            return 1.01 * g

    physics = tpsf_net.tpsf_forward_physics
    monkeypatch.setattr(tpsf_net, "tpsf_forward_physics",
                        lambda depth, abm, **kw: physics(depth, OnePercentOff.apply(abm), **kw))
    line, _ = core.run(CELL, SEED, 0.3, False, CPU, overrides=TOY)
    checks = line["checks"]
    assert checks["abm_grad_gap"]["value"] > 100 * checks["abm_grad_gap"]["limit"], checks
    assert checks["hr_gap"]["value"] < checks["hr_gap"]["limit"], checks
    assert checks["lr_gap"]["value"] < checks["lr_gap"]["limit"], checks


def test_the_bf16_physics_control_and_half_batch_fail_the_limits():
    cell = core.make_cell(CELL, SEED + 1, 1, False, CPU, 0, TOY)
    readings = core.load_module("drivers", "tpsf_train").control(cell)
    ctl = readings["bf16_physics"]
    assert all(ctl[k] > cell.limits[k] for k in ("hr_gap", "lr_gap", "abm_grad_gap")), ctl
    assert not judge(readings["half_batch"], {k: v for k, v in cell.limits.items() if k in readings["half_batch"]})


def test_frozen_counts():
    assert (FORWARD_FLOPS, BACKWARD_FLOPS, MLP_FLOPS) == (3_063_200, 7_616_400, 1_074_688)
    from tactilesr_torch.bench import tpsf_bound_ms, tpsf_bwd_bound_ms

    for b in (256, 8192):  # the port's own bounds, from which these were copied
        assert kernel_least_seconds("tpsf_physics_kernel", b) * 1e3 == pytest.approx(tpsf_bound_ms(b)[0])
        assert kernel_least_seconds("tpsf_physics_bwd_kernel", b) * 1e3 == pytest.approx(tpsf_bwd_bound_ms(b)[0])


def _window():
    """Two steps at B=256: each a 0.06 ms forward kernel, a 0.12 ms backward
    kernel and a 0.22 ms other kernel, back to back, in a 1 ms window."""
    device = []
    for o in (0.0, 0.5):
        device += [(*[round((o + a) * MS) for a in (0.0, 0.06)], "(anonymous namespace)::tpsf_physics_kernel(float const*, float*)"),
                   (*[round((o + a) * MS) for a in (0.06, 0.18)], "(anonymous namespace)::tpsf_physics_bwd_kernel(float const*)"),
                   (*[round((o + a) * MS) for a in (0.18, 0.40)], "void at::native::multi_tensor_apply_kernel<...>")]
    return Trace(0, MS, device=device, counters={"batch": 256, "steps": 2})


def _read(name, trace):
    return core.load_module("metrics", name).read(trace)


def test_the_physics_readers_on_a_synthetic_window():
    trace = _window()
    least = 2 * (kernel_least_seconds("tpsf_physics_kernel", 256) + kernel_least_seconds("tpsf_physics_bwd_kernel", 256))
    assert _read("physics_kernels_roofline.tpsf", trace) == pytest.approx(100 * least / 0.36e-3)
    assert _read("physics.device_share.tpsf", trace) == pytest.approx(100 * 0.36 / 0.8)
    assert _read("device.idle_share.tpsf", trace) == pytest.approx(20.0)
    assert _read("trainer.device_ops_per_step.tpsf", trace) == 3


def test_launches_per_step_reads_the_replays_counts(monkeypatch):
    launches = {"tpsf_physics": 6, "tpsf_physics_fused": 6, "tpsf_physics_bwd": 6}
    recs = [Span(0, 900_000, "trainer.epoch", 1, None, 1, {"steps": 6}),
            Span(10_000, 800_000, "trainer.replays", 2, 1, 1, {"eager": 0, "captured": 0, "launches": launches})]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    assert _read("physics.launches_per_step.tpsf", Trace(0, MS)) == 2.0
    recs[1] = recs[1]._replace(attrs={"eager": 0, "captured": 0})  # a program that counts nothing on its spans
    assert _read("physics.launches_per_step.tpsf", Trace(0, MS)) is None


def test_the_epoch_readers_read_the_trainers_spans(monkeypatch):
    """Two epochs, each a 0.1 ms prepare, 0.6 ms of replays and a 0.1 ms
    fetch, in a window whose device is busy 0.4 ms inside each epoch's
    replays: 0.2 ms idle at the boundary and 0.2 ms between the steps, per
    epoch."""
    recs = []
    for i, o in enumerate((0, 1_000_000)):
        root = 10 * i + 1
        recs += [Span(o, o + 800_000, "trainer.epoch", root, None, root, {"steps": 6}),
                 Span(o, o + 100_000, "trainer.prepare", root + 1, root, root, {}),
                 Span(o + 100_000, o + 700_000, "trainer.replays", root + 2, root, root, {}),
                 Span(o + 700_000, o + 800_000, "trainer.fetch", root + 3, root, root, {})]
    device = [(o + 200_000, o + 600_000, "void at::native::multi_tensor_apply_kernel<...>") for o in (0, 1_000_000)]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    trace = Trace(0, 2 * MS, device=device)
    assert _read("trainer.epoch_host_ms.tpsf", trace) == pytest.approx(0.2)
    assert _read("trainer.replay_idle_ms.tpsf", trace) == pytest.approx(0.2)

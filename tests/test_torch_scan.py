"""The trainer's ``scan_epochs``, ``remat`` and ``ProfilerHook`` in the port,
on the CPU: scan mode against the port's eager loop and against the JAX
trainer's ``lax.scan`` epochs, its resume on an epoch boundary, gradient
accumulation with an all-padded micro-batch under scan and remat, remat
against no remat, and the trace window, iteration by iteration and over
scan epochs.  On the CPU the scan path runs the step function a CUDA graph
captures on the card, uncaptured, through the same device buffers and step
counter.  Also: ``apply_matmul_precision`` governs cuDNN's TF32 flag."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from conftest import make_toy_trainer, toy_sr_config, toy_sr_data
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.runtime import ProfilerHook
from tactilesr_torch.runtime import schedule
from tactilesr_torch.runtime.misc import apply_matmul_precision
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.trainer import Trainer, masked_mse
from tactilesr_torch.tasks import sr_task

# test_torch_sr_train.py's state rule: pre-BN conv biases aside, all but 1%
# of the parameters' elements within 1e-5, none beyond 2 x lr x steps
from test_torch_sr_train import _assert_state_close  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes: the suite runs several worker
    processes at once, and torch's one thread per core in each of them
    oversubscribes the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sr_trainer(tmp_path, name, lr, hr, variables=None, max_epochs=2, **kw):
    """The port's toy SRTrainer (scale 4, one MSRB, f32, batch 8) from one
    seeded init, or from JAX ``variables``."""
    cfg = toy_sr_config(str(tmp_path / name))
    model = sr_task.build_model(cfg)
    if variables is not None:
        model.load_state_dict(tactile_sr_state_dict(variables), strict=True)
    sched = schedule.LRWarmupSchedule(
        schedule.StepLR(cfg["lr"], cfg["lr_scheduler_step_size"], cfg["lr_scheduler_gamma"]),
        by_epoch=True, epoch_len=-(-lr.shape[0] // cfg["train_batch_size"]))
    return sr_task.SRTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=sched, train_arrays={"LR": lr, "HR": hr}, batch_size=cfg["train_batch_size"],
        max_epochs=max_epochs, work_dir=cfg["save_dir"], seed=42, device="cpu", **kw)


def _losses(t):
    return t.metric_storage["total_loss"].state_dict()["values"]


def _bn(t):
    return {k: v for k, v in t.model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


class _Lin(Trainer):
    def train_cal_loss(self, batch):
        loss = masked_mse(self.model(batch["x"]), batch["y"], batch["mask"])
        return loss, {"total_loss": loss}


def _lin_trainer(path, n=70, bs=16, **kw):
    """A BN-free linear least-squares problem (tests/test_grad_accum.py's
    shape: 70 rows at batch 16, so every epoch ends on a padded batch)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = (x @ rng.standard_normal((5, 1)) + 0.01 * rng.standard_normal((n, 1))).astype(np.float32)
    torch.manual_seed(0)
    model = torch.nn.Linear(5, 1)
    kw.setdefault("max_epochs", 3)
    return _Lin(model=model, optimizer=adam_l2(model.parameters()),
                lr_schedule=schedule.LRWarmupSchedule(schedule.StepLR(1e-2, 1, 0.9), by_epoch=True,
                                                      epoch_len=math.ceil(n / bs)),
                train_arrays={"x": x, "y": y}, batch_size=bs, work_dir=str(path), device="cpu",
                log_period=2, **kw)


def test_scan_matches_the_eager_loop(tmp_path, rng):
    """2 epochs of 20 samples at batch 8 (each epoch ends on 4 real rows
    and 4 padded): scan mode's losses, parameters and BN state equal the
    eager loop's at rtol 1e-6 (atol 1e-8 for the state: the one difference
    is the learning rate, which scan mode reads from an f32 device buffer,
    and its rounding moves values near 0 by a few 1e-9), the same step
    count, per-step logs and checkpoints."""
    lr, hr = toy_sr_data(rng, n=20)
    eager = _sr_trainer(tmp_path, "eager", lr, hr)
    eager.train(auto_resume=False)
    scan = _sr_trainer(tmp_path, "scan", lr, hr, scan_epochs=True)
    scan.train(auto_resume=False)
    assert scan.step == eager.step == 6
    np.testing.assert_allclose(_losses(scan), _losses(eager), rtol=1e-6)
    want = eager.model.state_dict()
    for k, v in scan.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(want[k]) == 6, k
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    storage = scan.metric_storage
    assert len(storage["lr"]) == len(storage["iter_time"]) == 6
    assert storage["data_time"].latest == 0.0
    np.testing.assert_allclose(storage["lr"].state_dict()["values"],
                               eager.metric_storage["lr"].state_dict()["values"], rtol=1e-7)
    assert sorted(os.listdir(scan.ckpt_dir)) == ["epoch_0.pth", "epoch_1.pth", "latest.pth"]


def test_scan_matches_jax_scan_epochs(tmp_path, rng):
    """One epoch of 20 samples at batch 8 in scan mode, the port's against
    JAX ``scan_epochs=True``, from the same weights: the 3-step SRTrainer
    trajectory rule (losses rtol 1e-4; the BN statistics after step 3 at
    atol 5e-4; parameters per element, see _assert_state_close)."""
    lr, hr = toy_sr_data(rng, n=20)
    cfg = toy_sr_config(str(tmp_path / "jax"))
    tj = make_toy_trainer(cfg, lr, hr, max_epochs=1, scan_epochs=True)
    init = jax.device_get({"params": tj.state.params, "batch_stats": tj.state.batch_stats})
    tj.train(auto_resume=False)
    tp = _sr_trainer(tmp_path, "port", lr, hr, init, max_epochs=1, scan_epochs=True)
    tp.train(auto_resume=False)
    assert tp.step == 3
    np.testing.assert_allclose(_losses(tp), tj.metric_storage["total_loss"].state_dict()["values"],
                               rtol=1e-4)
    want = tactile_sr_state_dict(jax.device_get({"params": tj.state.params,
                                                 "batch_stats": tj.state.batch_stats}))
    _assert_state_close(tp.model.state_dict(), want, cfg["lr"], 3, stats_atol=5e-4)


def test_scan_resume_lands_on_the_epoch_boundary(tmp_path):
    """tests/test_trainer.py's scan resume: 2 epochs, then a trainer of 4
    epochs with ``scan_epochs`` set after construction resumes from
    latest.pth at epoch 2 and logs all 4 epochs' steps, the first two
    epochs' as the first trainer logged them."""
    t1 = _lin_trainer(tmp_path / "w", max_epochs=2)
    t1.scan_epochs = True
    t1.train(auto_resume=False)
    t2 = _lin_trainer(tmp_path / "w", max_epochs=4)
    t2.scan_epochs = True
    t2.train(auto_resume=True)
    assert t2.start_iter == 2 * t2.epoch_len and t2.step == 4 * t2.epoch_len
    assert len(t2.metric_storage["total_loss"]) == 4 * t2.epoch_len
    assert _losses(t2)[:2 * t2.epoch_len] == _losses(t1)
    assert all(np.isfinite(_losses(t2)))


def test_scan_with_max_iters_raises(tmp_path):
    """As tests/test_runtime_units.py: scan mode needs epoch-based training."""
    with pytest.raises(AssertionError, match="scan_epochs requires epoch"):
        _lin_trainer(tmp_path, max_epochs=0, max_iters=4, scan_epochs=True)


@pytest.mark.parametrize("scan", [False, True])
def test_cpu_training_keeps_host_side_adam(tmp_path, scan):
    """Only scan mode on CUDA makes Adam capturable: on the CPU both loops
    keep the float learning rate, and asking for the capturable form raises."""
    t = _lin_trainer(tmp_path, max_epochs=1, scan_epochs=scan)
    t.train(auto_resume=False)
    assert not t.optimizer.capturable
    assert all(isinstance(g["lr"], float) for g in t.optimizer.optimizer.param_groups)
    with pytest.raises(ValueError, match="capturable Adam needs CUDA"):
        t.optimizer.make_capturable()


def test_kernel_launch_counts_are_kept_under_graph_replay():
    """The physics kernels' launch counters are registered once with the
    graph module, which sets them back after a capture and adds each
    replay's launches; registering again adds no second entry."""
    from tactilesr_torch.ops import cuda as tcuda
    from tactilesr_torch.ops import graph

    n = len(graph._counters)
    graph.register_counters(tcuda.launch_counts)
    assert len(graph._counters) == n
    assert sum(c is tcuda.launch_counts for c in graph._counters) == 1


def test_accumulation_under_scan_and_remat_matches_full_batch(tmp_path):
    """tests/test_grad_accum.py's counterpart on the BN-free problem:
    grad_accum=4 under scan and remat (70 rows at batch 16: each epoch's
    last batch has 6 valid rows, so two of its four micro-batches are all
    padding) equals the unaccumulated eager trajectory, losses rtol 1e-5,
    weights rtol 1e-5 / atol 1e-7."""
    ta = _lin_trainer(tmp_path / "a")
    ta.train(auto_resume=False)
    tb = _lin_trainer(tmp_path / "b", grad_accum=4, scan_epochs=True, remat=True)
    tb.train(auto_resume=False)
    np.testing.assert_allclose(_losses(tb), _losses(ta), rtol=1e-5)
    for pa, pb in zip(ta.model.parameters(), tb.model.parameters()):
        np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_all_padded_micro_batch_leaves_bn_alone_under_scan_and_remat(tmp_path, rng):
    """K=4 over 10 rows at batch 8: the second step has one micro-batch of
    2 valid rows and three all-padded ones.  Under scan and remat the step
    selects on the device instead of skipping on the host, and the BN
    statistics and num_batches_tracked come out as the eager skip leaves
    them: the counters at 5 (not 8), the statistics at rtol 1e-6, the
    losses at rtol 1e-6."""
    lr, hr = toy_sr_data(rng, n=10)
    eager = _sr_trainer(tmp_path, "eager", lr, hr, max_epochs=1, grad_accum=4)
    eager.train(auto_resume=False)
    scan = _sr_trainer(tmp_path, "scan", lr, hr, max_epochs=1, grad_accum=4, scan_epochs=True,
                       remat=True)
    scan.train(auto_resume=False)
    assert scan.step == eager.step == 2
    np.testing.assert_allclose(_losses(scan), _losses(eager), rtol=1e-6)
    want = _bn(eager)
    for k, v in _bn(scan).items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(want[k]) == 5, k
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("scan", [False, True])
def test_remat_equals_no_remat(tmp_path, rng, scan):
    """remat recomputes the forward in the backward pass, and undoes the
    recompute's BN update: 2 epochs of 20 samples at batch 8, eager and in
    scan mode.  Losses at rtol 1e-5; the BN statistics and counters equal
    to the run without remat, bit for bit; parameters at rtol 1e-5."""
    lr, hr = toy_sr_data(rng, n=20)
    plain = _sr_trainer(tmp_path, "plain", lr, hr, scan_epochs=scan)
    plain.train(auto_resume=False)
    remat = _sr_trainer(tmp_path, "remat", lr, hr, scan_epochs=scan, remat=True)
    remat.train(auto_resume=False)
    np.testing.assert_allclose(_losses(remat), _losses(plain), rtol=1e-5)
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(v, want[k]), k
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-8, err_msg=k)
    assert int(_bn(remat)["inputContact_layer.1.num_batches_tracked"]) == 6


def test_profiler_hook_traces_its_window(tmp_path):
    """A window of 2 iterations from iteration 3 writes one Chrome trace
    with CPU events; a window that runs past the end of training is closed
    at train end and written too."""
    t = _lin_trainer(tmp_path / "a", max_epochs=2)
    hook = ProfilerHook(str(tmp_path / "trace"), start_iter=3, num_iters=2)
    t.register_hooks([hook])
    t.train(auto_resume=False)
    assert hook.trace_path == str(tmp_path / "trace" / "trace_iter_3_5.json")
    with open(hook.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert os.listdir(tmp_path / "trace") == ["trace_iter_3_5.json"]

    late = ProfilerHook(str(tmp_path / "late"), start_iter=8, num_iters=100)
    t2 = _lin_trainer(tmp_path / "b", max_epochs=2)
    t2.register_hooks([late])
    t2.train(auto_resume=False)
    assert late.trace_path is not None and os.path.getsize(late.trace_path) > 0
    assert late.priority == 4


def test_profiler_hook_traces_scan_epochs(tmp_path):
    """Under ``scan_epochs`` (5-step epochs) a window of iterations 6-8
    opens before epoch 1, which holds iteration 6, and closes after it: one
    Chrome trace that names that epoch's spans, and no other epoch's."""
    t = _lin_trainer(tmp_path / "a", max_epochs=3, scan_epochs=True)
    hook = ProfilerHook(str(tmp_path / "trace"), start_iter=6, num_iters=3)
    t.register_hooks([hook])
    t.train(auto_resume=False)
    assert hook.trace_path == str(tmp_path / "trace" / "trace_iter_6_9.json")
    with open(hook.trace_path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "trainer.prepare" in names and "trainer.fetch" in names
    assert names.count("trainer.epoch") == 1


@pytest.mark.parametrize("prec, tf32", [("highest", False), ("high", True), ("default", True),
                                        (None, True)])
def test_apply_matmul_precision_governs_cudnn(prec, tf32):
    """matmul_precision sets cuDNN's TF32 flag as well as the matmul one
    (the JAX flag covers convolutions): off for highest, on otherwise, from
    either previous value.  The flags are restored after."""
    prev_cudnn = torch.backends.cudnn.allow_tf32
    try:
        for start in (True, False):
            torch.backends.cudnn.allow_tf32 = start
            apply_matmul_precision({"matmul_precision": prec})
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev_cudnn
        torch.set_float32_matmul_precision("highest")

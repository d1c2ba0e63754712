"""The trainer's ``scan_epochs`` on the GPU: every step after the warm-up
steps is a replay of one captured CUDA graph, held against the eager loop
at toy size (SR: scale 4, one MSRB, f32, batch 8; stage 1: batch 16), with
the physics kernels replayed inside the stage-1 graph and counted per
replay.  Every test here needs an NVIDIA GPU (and nvcc, for stage 1) and
skips without one.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q

Tolerances: losses rtol 1e-4 and BN statistics atol 1e-4 between the
captured and the eager run, f32 with TF32 off (the card-vs-CPU rule of
``chip_smoke.py::phase_sr_parity``): the captured step runs capturable Adam
(the optimizer kernel, bias corrections on the device in f32) and the eager
loop torch's host-side form (in double), and cuDNN's backward kernels may
sum in another order from run to run.
"""

import numpy as np
import pytest
import torch

from tactilesr_torch.config import tactileSR_config, tPSFNet_config
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.graph import CapturedGraph, register_counters
from tactilesr_torch.runtime.misc import apply_matmul_precision
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.tasks import sr_task, tpsf_task

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture only on one)")
    prev = torch.backends.cudnn.allow_tf32
    apply_matmul_precision({"matmul_precision": "highest"})
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _sr_config(tmp_path, name):
    return dict(tactileSR_config, save_dir=str(tmp_path / name), train_batch_size=8,
                test_batch_size=4, patternFeatureExtraLayerCnt=1, scale_factor=4, warmup_t=0,
                compute_dtype="float32", inference_test=False)


def _sr_data(n=36):
    rng = np.random.default_rng(0)
    lr = (rng.random((n, 3, 4, 4)) * 4).astype(np.float32)
    hr = np.repeat(np.repeat(lr[:, 2:3], 25, axis=2), 25, axis=3).astype(np.float32)
    return lr, hr


def _sr_trainer(tmp_path, name, dev, max_epochs=2, **kw):
    cfg = _sr_config(tmp_path, name)
    lr, hr = _sr_data()
    model = sr_task.build_model(cfg)
    return sr_task.SRTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], 2, 0.8), by_epoch=True, epoch_len=5),
        train_arrays={"LR": lr, "HR": hr}, batch_size=8, max_epochs=max_epochs,
        work_dir=cfg["save_dir"], seed=42, device=dev, **kw)


def _losses(t):
    return t.metric_storage["total_loss"].state_dict()["values"]


def _assert_runs_close(got, want, steps):
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    ref = want.model.state_dict()
    for k, v in got.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]), k
        elif k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, ref[k], rtol=0, atol=1e-4, msg=k)
    assert got.step == want.step == steps


@pytest.mark.parametrize("kw", [{}, {"remat": True}, {"grad_accum": 4, "remat": True}],
                         ids=["plain", "remat", "accum_remat"])
def test_captured_sr_epochs_match_eager(tmp_path, dev, kw):
    """36 samples at batch 8: 5 steps per epoch, the last with 4 valid rows
    (under grad_accum 4 its micro-batches have 2 rows, and two of them are
    all padding).  2 epochs: 3 eager warm-up steps, one capture, 7
    replays."""
    eager = _sr_trainer(tmp_path, "eager", dev, **kw)
    eager.train(auto_resume=False)
    scan = _sr_trainer(tmp_path, "scan", dev, scan_epochs=True, **kw)
    scan.train(auto_resume=False)
    assert scan._graph is not None and scan.optimizer.capturable
    assert scan._graph.per_replay["adam_l2"] == 1  # Adam is one kernel launch a step
    assert not eager.optimizer.capturable  # the eager loop keeps host-side Adam
    _assert_runs_close(scan, eager, 10)


def test_captured_resume_captures_again(tmp_path, dev):
    """A scan run resumed from its checkpoint loads new optimizer state, so
    it warms up and captures again; its 2 epochs from epoch 1 log 10 steps
    in all, the first five as the first run logged them."""
    first = _sr_trainer(tmp_path, "w", dev, max_epochs=1, scan_epochs=True)
    first.train(auto_resume=False)
    again = _sr_trainer(tmp_path, "w", dev, max_epochs=2, scan_epochs=True)
    again.train(auto_resume=True)
    assert again.start_iter == 5 and again.step == 10 and again._graph is not None
    assert _losses(again)[:5] == _losses(first)
    assert np.isfinite(_losses(again)).all()


def _tpsf_trainer(tmp_path, name, dev, physics_precision="highest", **kw):
    cfg = dict(tPSFNet_config, compute_dtype="float32", save_dir=str(tmp_path / name),
               physics_precision=physics_precision)
    rng = np.random.default_rng(1)
    n = 72  # 5 steps of 16, the last with 8 valid rows
    lr = (rng.random((n, 3, 4, 4)) * 300).astype(np.float32)
    depth = np.zeros((n, 100, 100), np.float32)
    for k in range(n):
        r, c = rng.integers(20, 60, 2)
        depth[k, r:r + 20, c:c + 20] = rng.random()
    model = tpsf_task.build_model(cfg)
    return tpsf_task.TPSFTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], 1, 0.8), by_epoch=True, epoch_len=5),
        train_arrays={"LR": lr, "depth": depth}, batch_size=16, max_epochs=2,
        work_dir=cfg["save_dir"], seed=42, device=dev, **kw)


def test_captured_stage1_replays_the_physics_kernels(tmp_path, dev):
    """Stage 1 in scan mode: the graph holds the forward and backward
    physics kernels and the optimizer kernel, and each replay counts them,
    so over 10 steps the backward kernel and the optimizer kernel count
    exactly 10 launches and each forward wrapper at least 10 (the capture
    itself counts none).  Losses against the eager run at rtol 1e-4 (f32
    MLP)."""
    eager = _tpsf_trainer(tmp_path, "eager", dev)
    eager.train(auto_resume=False)
    tcuda.reset_launch_counts()
    scan = _tpsf_trainer(tmp_path, "scan", dev, scan_epochs=True)
    scan.train(auto_resume=False)
    counts = dict(tcuda.launch_counts)
    assert scan._graph.per_replay["tpsf_physics_bwd"] == scan._graph.per_replay["adam_l2"] == 1
    assert counts["tpsf_physics_bwd"] == counts["adam_l2"] == 10, counts
    assert counts["tpsf_physics"] >= 10 and counts["tpsf_physics_fused"] >= 10, counts
    np.testing.assert_allclose(_losses(scan), _losses(eager), rtol=1e-4)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_captured_stage1_replays_the_bf16_kernel(tmp_path, dev, precision):
    """``physics_precision: default|high`` in scan mode: the graph holds that
    precision's forward kernel, the f32 backward and the optimizer kernel,
    one of each per replay, and the f32 forward kernel never launches.  Losses against the eager run
    at that precision at rtol 1e-4."""
    name = {"default": "tpsf_physics_bf16", "high": "tpsf_physics_bf16x3"}[precision]
    eager = _tpsf_trainer(tmp_path, "eager", dev, precision)
    eager.train(auto_resume=False)
    tcuda.reset_launch_counts()
    scan = _tpsf_trainer(tmp_path, "scan", dev, precision, scan_epochs=True)
    scan.train(auto_resume=False)
    counts = dict(tcuda.launch_counts)
    launched = {k: n for k, n in scan._graph.per_replay.items() if n}
    assert launched == {"tpsf_physics_bwd": 1, name: 1, "tpsf_physics_fused": 1, "adam_l2": 1}, launched
    assert counts["tpsf_physics_bwd"] == 10 and counts[name] >= 10, counts
    assert counts["tpsf_physics"] == 0, counts
    np.testing.assert_allclose(_losses(scan), _losses(eager), rtol=1e-4)


def test_captured_graph_counts_each_replay_not_the_capture(dev):
    """A registered counter bumped inside a capture reads as before the
    capture, and each replay adds the capture's launches."""
    counts = {"probe": 0}
    register_counters(counts)
    x = torch.zeros(4, device=dev)
    g = CapturedGraph()
    torch.cuda.synchronize()
    with g.capture():
        x.add_(1.0)
        counts["probe"] += 1
    assert counts == {"probe": 0} and g.per_replay["probe"] == 1
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert counts == {"probe": 3}
    assert torch.equal(x, torch.full((4,), 3.0, device=dev))

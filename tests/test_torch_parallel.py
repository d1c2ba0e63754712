"""The port's data-parallel layout in one process: ``resolve_mesh`` against
JAX's on stand-in devices, the launch's precedence in ``init_distributed``,
the trainer's guards, ``SRPredictor`` over a two-device mesh against the
unsharded predictor and JAX's over its 8-device mesh, and
``graft_entry.dryrun_multichip`` over 2 gloo ranks (its own group of
worker processes)."""

import logging

import jax
import numpy as np
import pytest
import torch

import tactilesr_tpu.parallel.mesh as jax_mesh
import tactilesr_torch.parallel.mesh as port_mesh
from conftest import make_sr_checkpoint
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.serving import SRPredictor as JaxSRPredictor
from tactilesr_torch import graft_entry
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.parallel import dist, make_mesh
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.runtime.trainer import Trainer
from tactilesr_torch.serving import SRPredictor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes (the suite runs several
    worker processes at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ resolve_mesh
class _Dev:
    """A stand-in device with its process (both packages' ``make_mesh`` are
    patched, so only the layout is read)."""

    def __init__(self, pid, i):
        self.process_index = pid
        self.id = i


def _decide(module, monkeypatch, spec, batch, devices):
    """The devices ``module.resolve_mesh`` puts on the data axis (None for
    no mesh), or the class of the error it raises."""
    picked = {}
    monkeypatch.setattr(module, "make_mesh", lambda ds: picked.setdefault("ds", list(ds)))
    try:
        mesh = module.resolve_mesh(spec, batch_size=batch, devices=devices)
    except (AssertionError, ValueError) as e:
        return type(e)
    return None if mesh is None else [(d.process_index, d.id) for d in picked["ds"]]


@pytest.mark.parametrize("procs, per_proc", [(1, 1), (1, 8), (2, 1), (2, 4)])
@pytest.mark.parametrize("batch", [6, 8, 30])
@pytest.mark.parametrize("spec", ["auto", True, "on", "off", 1, 2, "4", 8, 3])
def test_resolve_mesh_decides_as_jax(monkeypatch, spec, batch, procs, per_proc):
    """Every spec over every layout: the same devices on the data axis (so
    the same size and the same count from each process), no mesh, or an
    error of the same class as JAX's ``resolve_mesh``."""
    devices = [_Dev(p, p * per_proc + i) for p in range(procs) for i in range(per_proc)]
    want = _decide(jax_mesh, monkeypatch, spec, batch, devices)
    got = _decide(port_mesh, monkeypatch, spec, batch, devices)
    assert got == want


def test_mesh_over_the_process_group_and_in_process():
    """One process: ``make_mesh()`` is the process group's (size 1, rank 0,
    no devices of its own); a list of devices is an in-process mesh that
    holds each; the config's knob resolves over the group, so a world of
    one process trains without a mesh and refuses 4 devices."""
    assert make_mesh() == port_mesh.Mesh(1, 0)
    m = make_mesh(["cpu", "cpu"])
    assert (m.size, m.rank, m.devices, m.shape) == (2, 0, (torch.device("cpu"),) * 2, {"data": 2})
    assert port_mesh.resolve_mesh_from_config({"data_parallel": "auto", "train_batch_size": 8}) is None
    with pytest.raises(AssertionError, match="only 1 devices"):
        port_mesh.resolve_mesh_from_config({"data_parallel": 4, "train_batch_size": 8})


# ----------------------------------------------------- init_distributed
_LAUNCH_VARS = ("TACTILESR_COORDINATOR", "TACTILESR_NUM_PROCESSES", "TACTILESR_PROCESS_ID",
                "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_LOCALID")


def test_launch_precedence(monkeypatch):
    """Explicit arguments, then TACTILESR_*, then torch's env://, then
    SLURM, else a single process (and init_distributed a no-op)."""
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert dist._launch(None, None, None) is None
    assert dist.init_distributed(device="cpu") == 0 and dist.get_world_size() == 1
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "3")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dist._launch(None, None, None)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    assert dist._launch(None, None, None) == ("tcp://node0:29500", 4, 3, 3)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert dist._launch(None, None, None) == ("env://", 2, 1, 1)
    monkeypatch.setenv("TACTILESR_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("TACTILESR_NUM_PROCESSES", "8")
    monkeypatch.setenv("TACTILESR_PROCESS_ID", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist._launch(None, None, None) == ("tcp://10.0.0.1:1234", 8, 5, 1)
    assert dist._launch("h:9", 2, 0) == ("tcp://h:9", 2, 0, 1)
    assert dist._launch(None, 1, None) is None  # one process asked for explicitly
    with pytest.raises(ValueError, match="coordinator"):
        dist._launch(None, 2, None)


def test_local_ranks_report_and_a_failed_rank_ends_the_wait():
    """spawn_local_ranks gives each rank the TACTILESR_* variables and
    rank_results reads their RESULT lines; when a rank fails, the ranks
    still running (here one that would sleep a minute) are killed at once
    and the error carries the failed rank's output."""
    import sys
    import time

    code = ("import json, os, sys, time\n"
            "r = int(os.environ['TACTILESR_PROCESS_ID'])\n"
            "print('RESULT ' + json.dumps({'rank': r, 'world': os.environ['TACTILESR_NUM_PROCESSES'],"
            " 'coordinator': os.environ['TACTILESR_COORDINATOR']}))\n"
            "if os.environ.get('FAIL') and r == 0:\n"
            "    print('rank 0 gives up'); sys.exit(3)\n"
            "if os.environ.get('FAIL'):\n"
            "    time.sleep(60)\n")
    res = dist.rank_results(dist.spawn_local_ranks([sys.executable, "-c", code], 2), timeout=60)
    assert [res[r]["rank"] for r in (0, 1)] == [0, 1] and res[0]["world"] == "2"
    assert res[0]["coordinator"] == res[1]["coordinator"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 exited 3") as e:
        dist.rank_results(dist.spawn_local_ranks([sys.executable, "-c", code], 2,
                                                 env={"FAIL": "1"}), timeout=60)
    assert time.monotonic() - t0 < 30 and "rank 0 gives up" in str(e.value)


def test_trainer_takes_a_mesh_over_the_process_group_only(tmp_path):
    """A mesh needs the process group (none here), and an in-process
    serving mesh is refused; a batch that does not split over the data
    axis fails first, with JAX's message."""
    model = torch.nn.Linear(2, 1)
    kw = dict(model=model, optimizer=adam_l2(model.parameters()),
              lr_schedule=LRWarmupSchedule(StepLR(1e-3, 1, 0.9), by_epoch=True, epoch_len=1),
              train_arrays={"x": np.zeros((8, 2), np.float32)}, batch_size=8, max_epochs=1,
              work_dir=str(tmp_path), device="cpu")
    for mesh in (make_mesh(), make_mesh(["cpu", "cpu"])):
        with pytest.raises(ValueError, match="process group"):
            Trainer(mesh=mesh, **kw)
    with pytest.raises(AssertionError, match="divisible by the data-axis size 3"):
        Trainer(mesh=port_mesh.Mesh(3, 0), **kw)


# ------------------------------------------------------------------ serving
class _Capture(logging.Handler):
    """Records of the port's logger (it does not propagate to the root)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logger = logging.getLogger("tactilesr_torch")
        self._level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logger = logging.getLogger("tactilesr_torch")
        logger.removeHandler(self)
        logger.setLevel(self._level)


def _ckpts(tmp_path, seed):
    """A random-init TactileSR as a JAX ``.ckpt`` and the same weights as a
    port ``.pth``."""
    jax_path = make_sr_checkpoint(str(tmp_path / f"m{seed}.ckpt"), seed=seed)
    m = jax_load(jax_path)["model"]
    pth = save_checkpoint_file(str(tmp_path / f"m{seed}.pth"), tactile_sr_state_dict(
        {"params": m["params"], "batch_stats": m["batch_stats"]}))
    return jax_path, pth


KW = dict(scale_factor=4, pattern_layers=1, force_layers=1, compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_serving_matches_one_device_and_jax_mesh(tmp_path, rng, fused):
    """SRPredictor over a two-device mesh (both the CPU): buckets rounded
    up to multiples of 2, with JAX's log line; 13 rows (a padded bucket of
    16 and one of 4, each split in two) against the unsharded predictor
    and JAX's SRPredictor over its 8-device mesh, f32 rtol 1e-4 atol 1e-5;
    a hot swap replaces both replicas."""
    jax_path, pth = _ckpts(tmp_path, 0)
    with _Capture() as cap:
        pred = SRPredictor(pth, buckets=(3, 16), mesh=make_mesh(["cpu", "cpu"]), fused=fused,
                           **KW)
    assert pred.buckets == (4, 16) and len(pred._replicas) == 2
    assert "buckets (3, 16) rounded to data-axis multiples: (4, 16)" in cap.messages
    pred.warmup()
    lr = (rng.random((13, 3, 4, 4)) * 4).astype(np.float32)
    one = SRPredictor(pth, buckets=(3, 16), device="cpu", fused=fused, **KW)
    jax_pred = JaxSRPredictor(jax_path, buckets=(3, 16), mesh=jax_mesh.make_mesh(jax.devices()),
                              fused=fused, **KW)
    assert jax_pred.buckets == (8, 16)
    got = pred.predict(lr)
    np.testing.assert_allclose(got, one.predict(lr), **TOL)
    np.testing.assert_allclose(got, jax_pred.predict(lr), **TOL)

    _, pth2 = _ckpts(tmp_path, 1)
    pred.reload_checkpoint(pth2)
    want = SRPredictor(pth2, buckets=(4,), device="cpu", fused=fused, **KW)
    np.testing.assert_allclose(pred.predict(lr), want.predict(lr), **TOL)
    x = torch.from_numpy(lr[:2])
    for w in pred._replicas:
        np.testing.assert_allclose(pred._forward(w, x).numpy(), want.predict(lr[:2]), **TOL)
    assert not np.allclose(want.predict(lr), one.predict(lr))  # the swap changed the maps


# ------------------------------------------------------------ the dry run
def test_dryrun_multichip_over_two_gloo_ranks(capsys):
    """``graft_entry.dryrun_multichip(2, device="cpu")``: every rank's
    sequence passes, and the summary line is JAX's."""
    line = graft_entry.dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip OK: 2-device mesh {'data': 2} | epoch-scan DP")
    for part in ("resumed from epoch_1 and trained to epoch 3", "'epoch_3.pth'",
                 "fused SRPredictor served the checkpoint over the mesh",
                 "tPSF recipe under the mesh: 1 epoch", "grad_accum=2 sharded micro-batches"):
        assert part in line, part
    assert line in capsys.readouterr().out

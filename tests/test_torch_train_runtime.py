"""The port's training runtime against the JAX package's, on the CPU: the
same index sequences, learning-rate sequences, metric windows, metrics and
Adam updates; plus the port's checkpoint manager, config parser and trainer
contracts."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tactilesr_tpu import metrics as jax_metrics
from tactilesr_tpu.config.default import tPSFNet_config as jax_tpsf_config
from tactilesr_tpu.data.loader import epoch_batches as jax_epoch_batches
from tactilesr_tpu.runtime import history as jax_history
from tactilesr_tpu.runtime import schedule as jax_schedule
from tactilesr_tpu.runtime.optim import adam_l2 as jax_adam_l2
from tactilesr_torch import metrics
from tactilesr_torch.config import ConfigArgumentParser, add_config_args, apply_overrides, tPSFNet_config
from tactilesr_torch.data.loader import epoch_batches
from tactilesr_torch.parallel import get_rank, get_world_size, is_main_process
from tactilesr_torch.runtime import history, schedule
from tactilesr_torch.runtime.checkpoint import (
    CheckpointManager,
    load_checkpoint_file,
    load_state_dict_strict_false,
)
from tactilesr_torch.runtime.hooks import HookBase
from tactilesr_torch.runtime.misc import apply_matmul_precision, set_random_seed
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.trainer import Trainer, masked_mse


# ----------------------------------------------------------------- batching
@pytest.mark.parametrize("n,bs,shuffle,drop_last", [
    (23, 8, True, False), (24, 8, True, False), (23, 8, False, False), (23, 8, True, True),
    (5, 8, True, False),
])
def test_epoch_batches_match_jax(n, bs, shuffle, drop_last):
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # two epochs: the generator state carries over alike
        got = list(epoch_batches(n, bs, shuffle, ra if shuffle else None, drop_last))
        ref = list(jax_epoch_batches(n, bs, shuffle, rb if shuffle else None, drop_last))
        assert len(got) == len(ref)
        for (i, m), (ij, mj) in zip(got, ref):
            np.testing.assert_array_equal(i, ij)
            np.testing.assert_array_equal(m, mj)
            assert i.shape == (bs,) and m.dtype == np.float32


# ---------------------------------------------------------------- schedules
def _schedules(mod):
    """Every schedule mode, built the same way from either package."""
    return {
        "step_by_epoch": lambda: mod.LRWarmupSchedule(mod.StepLR(1e-3, 2, 0.5), by_epoch=True,
                                                      epoch_len=5),
        "step_by_iter": lambda: mod.LRWarmupSchedule(mod.StepLR(1e-3, 7, 0.5), by_epoch=False),
        "constant": lambda: mod.LRWarmupSchedule(mod.ConstantLR(3e-4), by_epoch=True, epoch_len=5),
        "fix_iter_warmup": lambda: mod.LRWarmupSchedule(
            mod.StepLR(1e-3, 1, 0.8), by_epoch=True, epoch_len=5, warmup_t=12,
            warmup_mode="fix", warmup_init_lr=1e-5),
        "factor_iter_warmup": lambda: mod.LRWarmupSchedule(
            mod.StepLR(1e-3, 4, 0.8), by_epoch=False, warmup_t=9, warmup_mode="factor",
            warmup_factor=1e-2),
        "auto_iter_warmup": lambda: mod.LRWarmupSchedule(
            mod.StepLR(1e-3, 2, 0.8), by_epoch=True, epoch_len=5, warmup_t=13,
            warmup_mode="auto", warmup_factor=1e-4),
        "fix_epoch_warmup": lambda: mod.LRWarmupSchedule(
            mod.StepLR(1e-3, 1, 0.8), by_epoch=True, epoch_len=5, warmup_t=3,
            warmup_by_epoch=True, warmup_mode="fix", warmup_init_lr=1e-5),
        "auto_epoch_warmup": lambda: mod.LRWarmupSchedule(
            mod.StepLR(1e-3, 1, 0.8), by_epoch=True, epoch_len=5, warmup_t=3,
            warmup_by_epoch=True, warmup_mode="auto", warmup_factor=1e-3),
        "plateau": lambda: mod.LRWarmupSchedule(
            mod.ReduceLROnPlateau(1e-3, factor=0.5, patience=1, cooldown=1), by_epoch=True,
            epoch_len=5),
        "plateau_abs_max": lambda: mod.LRWarmupSchedule(
            mod.ReduceLROnPlateau(1e-3, mode="max", factor=0.5, patience=0,
                                  threshold_mode="abs", threshold=0.1, min_lr=3e-4),
            by_epoch=True, epoch_len=5),
    }


def _drive(sched, epochs=8, epoch_len=5):
    metrics_seq = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7]
    lrs = []
    for e in range(epochs):
        for _ in range(epoch_len):
            lrs.append(sched.get_lr())
            sched.iter_update()
        plateau = getattr(sched.inner, "is_plateau", False)
        sched.epoch_update(metrics_seq[e] if plateau else None)
    return lrs, sched.state_dict()


@pytest.mark.parametrize("mode", sorted(_schedules(schedule)))
def test_schedule_sequence_matches_jax(mode):
    lrs, state = _drive(_schedules(schedule)[mode]())
    lrs_j, state_j = _drive(_schedules(jax_schedule)[mode]())
    assert lrs == lrs_j
    assert state == state_j
    resumed = _schedules(schedule)[mode]()
    resumed.load_state_dict(state)
    assert resumed.state_dict() == state_j and resumed.get_lr() == state_j["lr"]


# ------------------------------------------------------------ metric storage
def test_metric_storage_windows_match_jax():
    ours, ref = history.MetricStorage(window_size=4), jax_history.MetricStorage(window_size=4)
    rng = np.random.default_rng(0)
    for it in range(11):
        v = float(rng.random())
        for s in (ours, ref):
            s.update(it, total_loss=v)
            s.update(it, lr=0.1 * it, smooth=False)
            if it % 3 == 0:
                s.update(eval_metric=v * 2, smooth=False)
    assert ours.values_maybe_smooth == ref.values_maybe_smooth
    for k in ref.keys():
        assert ours[k].avg == ref[k].avg and ours[k].global_avg == ref[k].global_avg
        assert len(ours[k]) == len(ref[k]) and ours[k].latest == ref[k].latest
    assert ours.state_dict() == ref.state_dict()
    back = history.MetricStorage()
    back.load_state_dict(ours.state_dict())
    assert back.values_maybe_smooth == ours.values_maybe_smooth
    with pytest.raises(AssertionError, match="increasing"):
        ours.update(3, total_loss=1.0)
    with pytest.raises(ValueError, match="empty"):
        history.HistoryBuffer().latest


# ------------------------------------------------------------------ metrics
def test_metrics_match_jax(rng):
    a = rng.random((5, 4, 4)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal((5, 4, 4))).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(metrics.mse(ta, tb), jax_metrics.mse(a, b), **tol)
    np.testing.assert_allclose(metrics.psnr(ta[0], tb[0], 250.0), jax_metrics.psnr(a[0], b[0], 250.0), **tol)
    np.testing.assert_allclose(metrics.ssim(ta[1], tb[1]), jax_metrics.ssim(a[1], b[1]), **tol)
    np.testing.assert_allclose(metrics.ssim_loss(ta[2], tb[2]), jax_metrics.ssim_loss(a[2], b[2]), **tol)
    np.testing.assert_allclose(metrics.batched_psnr(ta, tb, 250.0),
                               jax_metrics.batched_psnr(a, b, 250.0), **tol)
    np.testing.assert_allclose(metrics.batched_ssim(ta, tb), jax_metrics.batched_ssim(a, b), **tol)
    assert float(metrics.ssim(ta[0], ta[0])) == pytest.approx(1.0, abs=1e-6)


# -------------------------------------------------------------------- adam
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_adam_l2_matches_optax_chain(rng, clip):
    """Five steps of the port's Adam (coupled L2, per-step lr) against the
    JAX package's optax chain.  f32 rounding only: rtol 1e-5.  With the
    clip, torch scales by max/(norm + 1e-6) and optax by max/norm, a 1e-6
    relative change of the gradient that Adam's normalisation nearly
    cancels; the same tolerance holds."""
    shapes = {"w": (6, 5), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 1e-3]

    tx = jax_adam_l2(weight_decay=1e-2, clip_grad_norm=clip)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, upd))

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = adam_l2(tparams.values(), weight_decay=1e-2, clip_grad_norm=clip)
    for g, lr in zip(grads, lrs):
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(lr)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-5, atol=1e-7)
    assert all(g["lr"] == lrs[-1] for g in opt.optimizer.param_groups)


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_manager_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_path() is None
    net = torch.nn.Linear(3, 2)
    opt = adam_l2(net.parameters(), weight_decay=1e-5)
    net(torch.ones(1, 3)).sum().backward()
    opt.step(1e-3)
    for e in range(3):
        mgr.save(f"epoch_{e}.pth", {"model": net.state_dict(), "optimizer": opt.state_dict(),
                                    "epoch": e, "num_devices": 1, "hooks": {"H": {"saved": [1]}}})
    files = sorted(os.listdir(tmp_path / "ck"))
    assert files == ["epoch_1.pth", "epoch_2.pth", "latest.pth"]
    assert os.readlink(tmp_path / "ck" / "latest.pth") == "epoch_2.pth"
    bundle = load_checkpoint_file(mgr.latest_path())  # weights_only=True
    assert bundle["epoch"] == 2 and set(bundle["optimizer"]) == {"state", "param_groups"}
    assert mgr.state_dict() == {"saved": ["epoch_1.pth", "epoch_2.pth"]}


def test_strict_false_load_reports_missing_unexpected_and_shape(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    sd = {"0.weight": torch.full((4, 3), 2.0), "1.weight": torch.zeros(5, 5),
          "extra.bias": torch.zeros(1)}
    missing, unexpected = load_state_dict_strict_false(net, sd)
    assert missing == ["0.bias", "1.bias"]
    assert unexpected == ["1.weight", "extra.bias"]
    assert torch.equal(net[0].weight, sd["0.weight"])
    assert torch.equal(net[1].weight, before["1.weight"])


# -------------------------------------------------------------------- config
def test_config_schema_is_the_jax_schema_plus_device():
    assert set(tPSFNet_config) == set(jax_tpsf_config) | {"device"}
    for k, v in jax_tpsf_config.items():
        if k not in ("root_path", "dataset_dir", "save_dir", "test_dataset_dir_1",
                     "test_dataset_dir_2"):
            assert tPSFNet_config[k] == v, k
    assert tPSFNet_config["device"] == "cuda"


def test_config_parser_yaml_and_flags(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("lr: 0.5\nepochs: 3\ninference_test: false\n")
    parser = ConfigArgumentParser()
    add_config_args(parser, tPSFNet_config)
    args = parser.parse_args(["-c", str(cfg), "--epochs", "7", "--device", "cpu",
                              "--use_pallas_physics", "false"])
    out = apply_overrides(tPSFNet_config, args)
    assert out["lr"] == 0.5 and out["epochs"] == 7 and out["inference_test"] is False
    assert out["device"] == "cpu" and out["use_pallas_physics"] == "false"
    assert out["sample_cnt"] == tPSFNet_config["sample_cnt"]
    bad = tmp_path / "bad.yaml"
    bad.write_text("not_a_key: 1\n")
    with pytest.raises(SystemExit):
        parser.parse_args(["-c", str(bad)])


# ------------------------------------------------------------------- misc
def test_matmul_precision_and_seed():
    try:
        for prec, want in (("highest", "highest"), ("high", "high"), ("default", "high")):
            apply_matmul_precision({"matmul_precision": prec})
            assert torch.backends.cuda.matmul.allow_tf32 == (want == "high")
        with pytest.raises(ValueError, match="matmul_precision"):
            apply_matmul_precision({"matmul_precision": "medium"})
    finally:
        torch.set_float32_matmul_precision("highest")
    a = set_random_seed(5)
    x = (np.random.rand(), float(torch.rand(())))
    set_random_seed(5)
    assert a == 5 and x == (np.random.rand(), float(torch.rand(())))
    assert (get_rank(), get_world_size(), is_main_process()) == (0, 1, True)


# ------------------------------------------------------------------ trainer
class _LinTrainer(Trainer):
    def train_cal_loss(self, batch):
        pred = self.model(batch["x"])
        loss = masked_mse(pred, batch["y"], batch["mask"])
        return loss, {"total_loss": loss}


def _lin_trainer(tmp_path, n=10, bs=4, cls=_LinTrainer, **kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = (x @ np.array([[1.0], [-2.0], [0.5]], np.float32)).astype(np.float32)
    model = torch.nn.Linear(3, 1)
    kw.setdefault("max_epochs", 2)
    return cls(
        model=model, optimizer=adam_l2(model.parameters()),
        lr_schedule=schedule.LRWarmupSchedule(schedule.StepLR(1e-2, 1, 0.9), by_epoch=True,
                                              epoch_len=math.ceil(n / bs)),
        train_arrays={"x": x, "y": y}, batch_size=bs, work_dir=str(tmp_path / "w"),
        device="cpu", log_period=2, **kw)


def test_masked_mse_excludes_padding():
    pred = torch.tensor([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]])
    tgt = torch.zeros(3, 2)
    assert float(masked_mse(pred, tgt, torch.tensor([1.0, 1.0, 0.0]))) == pytest.approx(7.5)
    p = pred.clone().requires_grad_(True)
    loss = masked_mse(p, tgt, torch.zeros(3))
    loss.backward()
    assert float(loss.detach()) == 0.0 and torch.all(p.grad == 0)


def test_trainer_hooks_order_and_iteration_mode(tmp_path):
    calls = []

    class Rec(HookBase):
        def __init__(self, name, prio):
            self.name, self.priority = name, prio

        def after_epoch(self):
            calls.append(self.name)

    t = _lin_trainer(tmp_path, max_epochs=1)
    t.register_hooks([Rec("late", 9), Rec("early", 1), Rec("mid", 5), Rec("mid2", 5)])
    assert [h.class_name for h in t._hooks][:2] == ["Rec", "LRUpdateHook"]
    t.train(auto_resume=False)
    assert calls == ["early", "mid", "mid2", "late"]
    assert t.step == 3 and len(t.metric_storage["total_loss"]) == 3

    it = _lin_trainer(tmp_path / "it", max_epochs=0, max_iters=5, checkpoint_period=2)
    it.train(auto_resume=False)
    files = sorted(os.listdir(it.ckpt_dir))
    assert files == ["iter_1.pth", "iter_3.pth", "iter_4.pth", "latest.pth"]
    assert load_checkpoint_file(os.path.join(it.ckpt_dir, "latest.pth"))["iter"] == 4


def test_trainer_nan_loss_raises_at_flush(tmp_path):
    class NaNTrainer(_LinTrainer):
        def train_cal_loss(self, batch):
            loss, _ = super().train_cal_loss(batch)
            loss = loss * float("nan")
            return loss, {"total_loss": loss}

    t = _lin_trainer(tmp_path, max_epochs=1, cls=NaNTrainer)
    with pytest.raises(FloatingPointError, match="iteration=0"):
        t.train(auto_resume=False)


def test_trainer_refuses_unported_modes(tmp_path):
    """scan_epochs and remat are ported: each trains the linear problem
    along the eager trajectory (losses rtol 1e-6).  Still refused: scan
    mode with iteration-based training, and a batch that does not split
    into grad_accum micro-batches."""
    torch.manual_seed(0)  # the Linear's init
    ref = _lin_trainer(tmp_path / "ref")
    ref.train(auto_resume=False)
    want = ref.metric_storage["total_loss"].state_dict()["values"]
    for name, kw in (("scan", {"scan_epochs": True}), ("remat", {"remat": True})):
        torch.manual_seed(0)
        t = _lin_trainer(tmp_path / name, **kw)
        t.train(auto_resume=False)
        assert t.step == 6
        np.testing.assert_allclose(t.metric_storage["total_loss"].state_dict()["values"], want,
                                   rtol=1e-6)
    with pytest.raises(AssertionError, match="scan_epochs requires epoch"):
        _lin_trainer(tmp_path, max_epochs=0, max_iters=4, scan_epochs=True)
    with pytest.raises(AssertionError, match="grad_accum"):
        _lin_trainer(tmp_path, grad_accum=3)


def test_trainer_auto_resume_and_device_assert(tmp_path):
    t = _lin_trainer(tmp_path, max_epochs=1)
    t.train(auto_resume=False)
    r = _lin_trainer(tmp_path, max_epochs=2)
    r.train(auto_resume=True)  # resumes from latest.pth: epoch 1 only
    assert r.start_iter == 3 and r.step == 6
    for a, b in zip(r.metric_storage["total_loss"].state_dict()["values"][:3],
                    t.metric_storage["total_loss"].state_dict()["values"]):
        assert a == b
    bad = load_checkpoint_file(os.path.join(t.ckpt_dir, "epoch_0.pth"))
    bad["num_devices"] = 2
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(AssertionError, match="2 devices"):
        _lin_trainer(tmp_path / "b", max_epochs=2).load_checkpoint(str(tmp_path / "bad.pth"))

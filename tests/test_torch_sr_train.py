"""The SR training recipe in the port against the JAX package, on the CPU
at toy size (``toy_sr_config``: scale 4, 1 MSRB, 1 ResBlock, f32): a 3-step
``SRTrainer`` trajectory, ``grad_accum`` over BatchNorm, the eval, the
dead-head detector, the inference PNG, the MTSR trunk transfer and warmup
gate, and both entries end to end."""

import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from conftest import make_toy_trainer, toy_sr_config, toy_sr_data
from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR
from tactilesr_tpu.runtime.hooks import HookBase as JaxHookBase
from tactilesr_tpu.tasks import sr_task as jax_sr_task
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.config import tactileSeqs_config
from tactilesr_torch.parallel import dist
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file
from tactilesr_torch.runtime.hooks import HookBase
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.serving import SRPredictor
from tactilesr_torch.tasks import sr_seqs_task, sr_task

# Why a trajectory is held per element and not at one atol.  In f32 the
# gradients through the BatchNorm chain carry rounding of the size of BN's
# output gradient (BN's input gradient is dy - mean(dy) - x_hat *
# mean(dy x_hat), a difference of such terms): against a float64 forward and
# backward of the same step, JAX's are off by up to 3.5e-3 of a tensor's
# largest entry and the port's by up to 1e-4 (toy model, batch 8).  Adam
# divides each gradient element by its own magnitude, so an element whose
# true gradient lies under that rounding takes a step of about lr whose sign
# is the rounding's: such elements part by up to 2 x lr per step.  They are
# a few per thousand of a weight tensor, and every element of the biases of
# the convs that feed a BN, whose true gradient is exactly 0 (BN removes any
# per-channel constant).  Hence: all but 1% of the parameters' elements
# within 1e-5, and none beyond 2 x lr x steps.
PRE_BN_BIAS = re.compile(r"patternFeatureExtra_layer\.\d+\.conv_[35]_[12]\.0\.bias$")
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes: the suite runs several worker
    processes at once, and torch's one thread per core in each of them
    oversubscribes the CPU (this file's tests ran 20-70x slower so)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Capture(logging.Handler):
    """Warnings of the port's logger (it does not propagate to the root)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("tactilesr_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("tactilesr_torch").removeHandler(self)


def _jax_init(cfg, seed=42):
    model = jax_sr_task.build_model(cfg)
    c = cfg["seqsCnt"] * cfg["axisCnt"]
    v = jax.device_get(model.init(jax.random.key(seed), np.zeros((1, c, 4, 4), np.float32),
                                  train=False))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _port_trainer(cfg, lr, hr, variables=None, max_epochs=1, grad_accum=1, seed=42):
    """The port's counterpart of ``make_toy_trainer``: the same schedule,
    optimizer and data order; the init from JAX ``variables`` when given."""
    model = sr_task.build_model(cfg)
    if variables is not None:
        model.load_state_dict(tactile_sr_state_dict(variables), strict=True)
    sched = LRWarmupSchedule(StepLR(cfg["lr"], cfg["lr_scheduler_step_size"], cfg["lr_scheduler_gamma"]),
                             by_epoch=True, epoch_len=-(-lr.shape[0] // cfg["train_batch_size"]))
    return sr_task.SRTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=sched, train_arrays={"LR": lr, "HR": hr}, batch_size=cfg["train_batch_size"],
        max_epochs=max_epochs, work_dir=cfg["save_dir"], seed=seed, grad_accum=grad_accum,
        device="cpu")


def _losses(t):
    return t.metric_storage["total_loss"].state_dict()["values"]


# ------------------------------------------------------------ the trainer
class _Snapshots:
    """State after each step, as the bridge's state_dict, from either package."""

    def __init__(self):
        self.states = []

    def jax_hook(self):
        outer = self

        class _Hook(JaxHookBase):
            def after_iter(self):
                outer.states.append(tactile_sr_state_dict(jax.device_get(
                    {"params": self.trainer.state.params,
                     "batch_stats": self.trainer.state.batch_stats})))
        return _Hook()

    def port_hook(self):
        outer = self

        class _Hook(HookBase):
            def after_iter(self):
                outer.states.append({k: v.clone() for k, v in self.trainer.model.state_dict().items()})
        return _Hook()


def _assert_state_close(got, want, lr, steps, stats_atol):
    """BN running statistics at ``stats_atol``; every parameter element
    within 2 x lr x steps, and all but 1% of the parameters' elements
    within 1e-5, the pre-BN conv biases aside (see PRE_BN_BIAS)."""
    over = total = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == steps, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=stats_atol, err_msg=k)
        else:
            d = (got[k] - v).abs()
            assert float(d.max()) <= 2 * lr * steps, (k, float(d.max()))
            if not PRE_BN_BIAS.search(k):
                over, total = over + int((d > 1e-5).sum()), total + d.numel()
    assert over <= 0.01 * total, (over, total)


def test_three_step_trajectory_matches_jax(tmp_path, rng):
    """20 samples at batch 8 (the last step 4 real rows and 4 padded, which
    enter BN's batch statistics as row 0 does in JAX), lr 1e-3, weight decay
    1e-2, no warmup.  Losses at rtol 1e-4.  After step 1 the BN running
    statistics at atol 1e-5 (they come from the initial weights alone);
    after step 3 at atol 5e-4, since the weights before them have parted as
    PRE_BN_BIAS's note says.  Parameters per element (_assert_state_close;
    measured: 0.08% of the elements beyond 1e-5, at most 0.6% of one
    tensor's, up to 4.2e-3; running stats up to 3.1e-4 after step 3)."""
    lr, hr = toy_sr_data(rng, n=20)
    cfg = toy_sr_config(str(tmp_path / "jax"))
    tj = make_toy_trainer(cfg, lr, hr, max_epochs=1)
    init = jax.device_get({"params": tj.state.params, "batch_stats": tj.state.batch_stats})
    snap_j, snap_p = _Snapshots(), _Snapshots()
    tj.register_hooks([snap_j.jax_hook()])
    tj.train(auto_resume=False)
    tp = _port_trainer(dict(cfg, save_dir=str(tmp_path / "port")), lr, hr, init)
    tp.register_hooks([snap_p.port_hook()])
    tp.train(auto_resume=False)
    assert tp.step == 3 and len(_losses(tp)) == 3 and len(snap_p.states) == len(snap_j.states) == 3
    np.testing.assert_allclose(_losses(tp), _losses(tj), rtol=1e-4)
    _assert_state_close(snap_p.states[0], snap_j.states[0], cfg["lr"], 1, stats_atol=1e-5)
    _assert_state_close(snap_p.states[2], snap_j.states[2], cfg["lr"], 3, stats_atol=5e-4)
    start = tactile_sr_state_dict(init)
    moved = max(float((v - start[k]).abs().max()) for k, v in snap_p.states[2].items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert moved > 1e-4  # the parameters really moved


def test_grad_accum_all_padded_micro_batch_keeps_bn_stats(tmp_path, rng):
    """K=4 over 10 rows at batch 8: the first step runs 4 micro-batches of
    2 rows, the second 1 of 2 valid rows and skips 3 all-padded ones, so
    num_batches_tracked rises by 5, not 8 (tests/test_grad_accum.py's
    counter, on the real BN model)."""
    lr, hr = toy_sr_data(rng, n=10)
    t = _port_trainer(toy_sr_config(str(tmp_path)), lr, hr, grad_accum=4)
    t.train(auto_resume=False)
    assert t.step == 2
    counts = {int(v) for k, v in t.model.state_dict().items() if k.endswith("num_batches_tracked")}
    assert counts == {5}


def test_grad_accum_trains(tmp_path, rng):
    """grad_accum=2 on the toy problem: the loss falls below 0.7 of its
    first value in 9 steps (tests/test_grad_accum.py's check)."""
    lr, hr = toy_sr_data(rng)
    cfg = toy_sr_config(str(tmp_path))
    t = _port_trainer(cfg, lr, hr, _jax_init(cfg), max_epochs=3, grad_accum=2)
    t.train(auto_resume=False)
    losses = _losses(t)
    assert len(losses) == 9 and np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0]


def test_eval_matches_jax_and_leaves_the_model_alone(tmp_path, rng):
    """10 test samples at test_batch_size 4 (a partial last batch): loss,
    PSNR and SSIM at rtol 1e-5.  The labels are the JAX model's own output
    plus noise, at 16 x 16 and x HR_scale_num, so SSIM is far from 0 and the
    comparison is not one of rounding.  After the eval the model is in train
    mode with its running stats unchanged."""
    lr, hr = toy_sr_data(rng, n=16)
    test_lr = toy_sr_data(rng, n=10)[0]
    cfg = toy_sr_config(str(tmp_path / "jax"))
    tj = make_toy_trainer(cfg, lr, hr, max_epochs=1)
    init = jax.device_get({"params": tj.state.params, "batch_stats": tj.state.batch_stats})
    out = np.asarray(tj.model_apply(test_lr, train=False))
    noise = rng.standard_normal(out.shape).astype(np.float32) * 0.1 * float(out.std())
    arrays = {"LR": test_lr, "HR": (cfg["HR_scale_num"] * (out + noise)).astype(np.float32)}
    tp = _port_trainer(dict(cfg, save_dir=str(tmp_path / "port")), lr, hr, init)
    want = jax_sr_task.build_eval_fn(tj, arrays)()
    before = {k: v.clone() for k, v in tp.model.state_dict().items()}
    tp.model.train()
    got = sr_task.build_eval_fn(tp, arrays)()
    assert set(got) == set(want) == {"test_loss", "test_SSIM", "test_PSNR"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["test_SSIM"] > 0.5 and np.isfinite(got["test_PSNR"])
    assert tp.model.training
    for k, v in tp.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------ dead-head detector
def _dead_trainer(tmp_path, rng, max_epochs=4):
    """All-zero parameters emit a constant-zero map and lr ~0 keeps them
    there: the loss pins at mean(HR^2) with zero output variance."""
    lr, hr = toy_sr_data(rng, n=16)
    t = _port_trainer(toy_sr_config(str(tmp_path), lr=1e-30), lr, hr, max_epochs=max_epochs)
    with torch.no_grad():
        for p in t.model.parameters():
            p.zero_()
    return t, lr


def _kill_head(t):
    """An all-negative head kernel on ReLU features: dead everywhere."""
    w = t.model.output_layer[2].weight
    with torch.no_grad():
        w.copy_(-w.abs() - 1e-3)


def test_dead_head_hook_warns_on_pinned_constant_output(tmp_path, rng):
    t, lr = _dead_trainer(tmp_path, rng)
    t.register_hooks([sr_task.DeadHeadHook(lr, patience=3)])
    with _Capture() as cap:
        t.train(auto_resume=False)
    dead = [m for m in cap.messages if "Dead head detected" in m]
    assert len(dead) == 1  # once, then quiet
    assert "head_init" in dead[0] and "non_negative" in dead[0]


def test_dead_head_hook_reinit_recovers_in_run(tmp_path, rng):
    """reinit after 2 pinned epochs; the same run then trains below the
    pinned mean(HR^2) level and never escalates."""
    lr, hr = toy_sr_data(rng, n=16)
    cfg = toy_sr_config(str(tmp_path), lr=3e-3)
    t = _port_trainer(cfg, lr, hr, _jax_init(cfg), max_epochs=12)
    _kill_head(t)
    t.register_hooks([sr_task.DeadHeadHook(lr, patience=2, action="reinit")])
    with _Capture() as cap:
        t.train(auto_resume=False)
    revive = [m for m in cap.messages if "re-drew the 'output_layer.2' kernel" in m]
    assert len(revive) == 1, cap.messages
    hr_power = float(t.device_arrays["HR"].square().mean())
    assert t.metric_storage["total_loss"].latest < 0.8 * hr_power
    assert not any("will not recover" in m for m in cap.messages)


def test_dead_head_hook_reinit_only_touches_the_head(tmp_path, rng):
    """At lr ~0 nothing else moves: every other tensor is bit-identical,
    the head is a fresh non-negative draw and its two Adam moments are 0
    (the reinit fires on the last epoch, after the last step)."""
    lr, hr = toy_sr_data(rng, n=16)
    cfg = toy_sr_config(str(tmp_path), lr=1e-30)
    t = _port_trainer(cfg, lr, hr, _jax_init(cfg), max_epochs=3)
    _kill_head(t)
    start = {k: v.clone() for k, v in t.model.state_dict().items()}
    hook = sr_task.DeadHeadHook(lr, patience=3, action="reinit")
    t.register_hooks([hook])
    t.train(auto_resume=False)
    assert hook._reinited
    for k, v in t.model.state_dict().items():
        if k == "output_layer.2.weight":
            assert bool((v >= 0).all()) and not torch.equal(v, start[k])
        elif not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(v, start[k]), k
    head = t.model.output_layer[2].weight
    state = t.optimizer.optimizer.state
    assert not bool(state[head]["exp_avg"].any()) and not bool(state[head]["exp_avg_sq"].any())
    other = t.model.output_layer[0].weight
    assert bool(state[other]["exp_avg_sq"].any())  # the other moments stay


def test_dead_head_hook_probe_failure_disables_not_kills(tmp_path, rng):
    t, _lr = _dead_trainer(tmp_path, rng)
    hook = sr_task.DeadHeadHook(np.zeros((8, 21, 4, 4), np.float32), patience=1)
    t.register_hooks([hook])
    with _Capture() as cap:
        t.train(auto_resume=False)  # completes
    assert hook._disabled
    assert any("probe forward failed" in m for m in cap.messages)


def test_dead_head_hook_rejects_unknown_action():
    with pytest.raises(ValueError, match="dead_head_action"):
        sr_task.DeadHeadHook(np.zeros((1, 3, 4, 4), np.float32), action="restart")


def test_dead_head_hook_second_death_escalates_to_warning(tmp_path, rng):
    """Whole net zero: a head reinit cannot revive it; the second
    detection warns once, naming the reinit already applied."""
    t, lr = _dead_trainer(tmp_path, rng, max_epochs=8)
    hook = sr_task.DeadHeadHook(lr, patience=2, action="reinit")
    t.register_hooks([hook])
    with _Capture() as cap:
        t.train(auto_resume=False)
    assert hook._reinited
    assert len([m for m in cap.messages if "died again" in m]) == 1, cap.messages


def test_dead_head_hook_missing_head_module_disables(tmp_path, rng):
    t, lr = _dead_trainer(tmp_path, rng)
    hook = sr_task.DeadHeadHook(lr, patience=1, action="reinit", head_module="no_such_module")
    t.register_hooks([hook])
    with _Capture() as cap:
        t.train(auto_resume=False)
    assert hook._disabled
    assert any("cannot reinit" in m for m in cap.messages)


def test_dead_head_hook_multiprocess_falls_back_to_warn(tmp_path, rng, monkeypatch):
    t, lr = _dead_trainer(tmp_path, rng)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    hook = sr_task.DeadHeadHook(lr, patience=2, action="reinit")
    t.register_hooks([hook])
    with _Capture() as cap:
        t.train(auto_resume=False)
    assert not hook._reinited
    assert any("not supported under a multi-process mesh" in m for m in cap.messages)
    assert any("Dead head detected" in m for m in cap.messages)


def test_dead_head_hook_quiet_on_healthy_run(tmp_path, rng):
    lr, hr = toy_sr_data(rng, n=16)
    cfg = toy_sr_config(str(tmp_path))
    t = _port_trainer(cfg, lr, hr, _jax_init(cfg), max_epochs=4)
    hook = sr_task.DeadHeadHook(lr, patience=2)
    t.register_hooks([hook])
    with _Capture() as cap:
        t.train(auto_resume=False)
    assert not any("Dead head" in m for m in cap.messages)
    assert not hook._warned and not hook._disabled


def test_dead_head_hook_state_dict_keys_match_jax():
    probe = np.zeros((1, 3, 4, 4), np.float32)
    ours = sr_task.DeadHeadHook(probe).state_dict()
    assert list(ours) == list(jax_sr_task.DeadHeadHook(probe).state_dict())
    hook = sr_task.DeadHeadHook(probe)
    hook.load_state_dict({"streak": 2, "warned": True, "reinited": True})
    assert hook.state_dict() == {"streak": 2, "warned": True, "reinited": True}


# -------------------------------------------------------------- the recipe
def _npz(path, lr, hr):
    np.savez(path, LR=lr, HR=hr)
    return str(path)


@pytest.fixture
def sr_data(tmp_path):
    rng = np.random.default_rng(0)
    lr = (rng.random((24, 3, 4, 4)) * 4).astype(np.float32)
    hr = (6.0 * np.repeat(np.repeat(lr[:, 2:3], 25, 2), 25, 3)).astype(np.float32)
    seqs_lr = (rng.random((16, 21, 4, 4)) * 4).astype(np.float32)
    seqs_hr = (6.0 * np.repeat(np.repeat(seqs_lr[:, 2:3], 25, 2), 25, 3)).astype(np.float32)
    return dict(train=_npz(tmp_path / "train.npz", lr[:16], hr[:16]),
                test=_npz(tmp_path / "test.npz", lr[16:], hr[16:]),
                seqs_train=_npz(tmp_path / "seqs_train.npz", seqs_lr[:8], seqs_hr[:8]),
                seqs_test=_npz(tmp_path / "seqs_test.npz", seqs_lr[8:], seqs_hr[8:]))


def _argv(sr_data, work, seqs=False, epochs=1):
    pre = "seqs_" if seqs else ""
    return ["--device", "cpu", "--train_dataset_dir", sr_data[pre + "train"],
            "--test_dataset_dir", sr_data[pre + "test"], "--save_dir", work,
            "--epochs", str(epochs), "--scale_factor", "4", "--patternFeatureExtraLayerCnt", "1",
            "--forceFeatureExtraLayerCnt", "1", "--train_batch_size", "8", "--test_batch_size", "4",
            "--compute_dtype", "float32", "--warmup_t", "5", "--inference_test", "false"]


@pytest.fixture
def restore_matmul_precision():
    yield
    torch.set_float32_matmul_precision("highest")


def test_inference_hook_writes_epoch_pngs(tmp_path, sr_data, restore_matmul_precision):
    work = str(tmp_path / "run")
    sr_task._cli(_argv(sr_data, work, epochs=2)[:-1] + ["true"])
    for epoch in (0, 1):
        path = os.path.join(work, "inference_result", f"epoch_{epoch}.png")
        with open(path, "rb") as f:
            assert f.read(8) == PNG_MAGIC
        assert os.path.getsize(path) > 1000


def test_transfer_trunk_params_matches_jax(tmp_path):
    """The MTSR state_dict after the transfer equals the bridge of JAX's
    transferred variables, entry for entry."""
    def variables(seqs_cnt, seed):
        m = JaxTactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                         force_feature_extra_layer_cnt=1)
        v = jax.device_get(m.init(jax.random.key(seed), np.zeros((1, 3 * seqs_cnt, 4, 4), np.float32),
                                  train=False))
        return {"params": v["params"], "batch_stats": v["batch_stats"]}

    seqs_v, single_v = variables(7, 1), variables(1, 2)
    want = tactile_sr_state_dict(jax_sr_task.transfer_trunk_params(seqs_v, {"model": single_v}))
    single_sd = tactile_sr_state_dict(single_v)
    got = sr_task.transfer_trunk_params(tactile_sr_state_dict(seqs_v), {"model": single_sd})
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    moved = [k for k in got if k.startswith(sr_task.TRUNK_PREFIXES)]
    assert moved and all(torch.equal(got[k], single_sd[k]) for k in moved)


def test_seqs_warmup_gate(tmp_path, sr_data, restore_matmul_precision):
    """The seqs recipe wires no warmup unless seqs_use_warmup opts in
    (tests/test_trainer.py's gate)."""
    def run(tag, *extra):
        cfg_argv = _argv(sr_data, str(tmp_path / tag), seqs=True) + [
            "--load_checkpoint_dir", str(tmp_path / "missing.pth"), "--warmup_t", "100",
            "--warmup_mode", "fix", "--warmup_init_lr", "1e-9", *extra]
        t = sr_seqs_task._cli(cfg_argv)
        return t.metric_storage["lr"].latest, t.config["lr"]

    lr_off, base = run("off")
    assert lr_off == pytest.approx(base) and base == tactileSeqs_config["lr"]
    lr_on, base = run("on", "--seqs_use_warmup", "true")
    assert lr_on < base


def test_entries_train_resume_serve_and_warm_start(tmp_path, sr_data, restore_matmul_precision):
    """STSR for one epoch through the entry: checkpoints, finite eval
    metrics, a resumed trainer with the same state, the checkpoint served
    by SRPredictor (fused and unfused, f32) equal to ``model_apply`` at
    rtol 1e-4 / atol 1e-5; then the MTSR entry warm-starts from it."""
    work = str(tmp_path / "stsr")
    seen = []

    class _Probe(HookBase):
        def after_epoch(self):
            seen.append((self.trainer.cur_epoch, self.trainer.step))

    t = sr_task._cli(_argv(sr_data, work), hooks=[_Probe()])
    assert seen == [(0, 2)] and (t.n_train, t.epoch_len) == (16, 2)
    assert t.model.training
    ck = os.path.join(work, "checkpoints")
    assert sorted(os.listdir(ck)) == ["epoch_0.pth", "latest.pth"]
    for key in ("test_loss", "test_PSNR", "test_SSIM"):
        assert np.isfinite(t.metric_storage[key].latest), key
    bundle = load_checkpoint_file(os.path.join(ck, "latest.pth"))
    assert bundle["epoch"] == 0 and bundle["step"] == 2
    assert set(bundle["hooks"]) == {"CheckpointHook", "DeadHeadHook"}
    assert bundle["hooks"]["DeadHeadHook"] == {"streak": 0, "warned": False, "reinited": False}

    cfg = dict(t.config, save_dir=str(tmp_path / "r"))
    model = sr_task.build_model(cfg)
    r = sr_task.SRTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], 2, 0.8), by_epoch=True, epoch_len=2,
                                     warmup_t=5, warmup_mode="auto", warmup_init_lr=1e-5,
                                     warmup_factor=1e-4),
        train_arrays={"LR": np.zeros((16, 3, 4, 4), np.float32),
                      "HR": np.zeros((16, 1, 100, 100), np.float32)},
        batch_size=8, max_epochs=2, work_dir=cfg["save_dir"], device="cpu")
    r.load_checkpoint(os.path.join(ck, "latest.pth"))
    assert r.start_iter == 2 and r.step == 2
    for k, v in t.model.state_dict().items():
        assert torch.equal(r.model.state_dict()[k], v), k
    so, sr = t.optimizer.state_dict()["state"], r.optimizer.state_dict()["state"]
    assert set(so) == set(sr)
    for i in so:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(so[i][k], sr[i][k])
    assert r.lr_schedule.state_dict() == t.lr_schedule.state_dict()

    with np.load(sr_data["test"]) as z:
        test_lr = z["LR"]
    want = t.model_apply(torch.from_numpy(test_lr)).numpy()
    for fused in (True, False):
        pred = SRPredictor(os.path.join(ck, "latest.pth"), scale_factor=4, pattern_layers=1,
                           compute_dtype="float32", buckets=(1, 8), fused=fused, device="cpu")
        np.testing.assert_allclose(pred.predict(test_lr), want, rtol=1e-4, atol=1e-5)

    with _Capture() as cap, pytest.MonkeyPatch.context() as mp:
        infos = []
        mp.setattr(sr_task.logger, "info", lambda msg, *a, **k: infos.append(msg % a))
        s = sr_seqs_task._cli(_argv(sr_data, str(tmp_path / "mtsr"), seqs=True)
                              + ["--load_checkpoint_dir", os.path.join(ck, "latest.pth")])
    assert not any("training from scratch" in m for m in cap.messages)
    assert any("Transferred 2 trunk modules" in m for m in infos), infos
    assert s.model.seqs_cnt == 7 and s.step == 1
    assert os.path.exists(os.path.join(str(tmp_path / "mtsr"), "checkpoints", "latest.pth"))


def test_entry_defaults_to_cuda_and_refuses_unported_options(tmp_path, sr_data,
                                                            restore_matmul_precision):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train on it")
    argv = _argv(sr_data, str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="cuda"):
        sr_task._cli(argv[2:])  # without --device cpu
    with pytest.raises(RuntimeError, match="cuda"):
        sr_seqs_task._cli(_argv(sr_data, str(tmp_path / "s"), seqs=True)[2:])
    with pytest.raises(AssertionError, match="only 1 devices"):  # a world of one process
        sr_task._cli(argv + ["--data_parallel", "4"])
    with pytest.raises(ValueError, match="single-frame"):  # the MTSR config, seqsCnt 7
        sr_seqs_task._cli(_argv(sr_data, str(tmp_path / "s"), seqs=True)
                          + ["--model_arch", "TactileSRCNN"])
    # scan_epochs and the CNN train (one epoch, 2 steps): the CNN in scan mode
    t = sr_task._cli(_argv(sr_data, str(tmp_path / "cnn")) + ["--model_arch", "TactileSRCNN",
                                                                 "--scan_epochs", "true"])
    assert type(t.model).__name__ == "TactileSRCNN" and t.scan_epochs and t.step == 2
    assert np.isfinite(_losses(t)).all() and np.isfinite(t.metric_storage["test_PSNR"].latest)

"""Stage-1 tPSFNet training in the port against the JAX package, on the CPU:
the physics' autograd wrapper against JAX's ``tpsf_physics_fused`` (Pallas
interpret forward, XLA recompute backward), the bf16 MLP against JAX's
``TPSFNet(dtype=bfloat16)``, a 3-step ``TPSFTrainer`` trajectory from one
JAX init, and the entry point end to end (train, resume, generate, inspect).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX trainer's optimizer)
import pytest
import torch

from tactilesr_tpu.config.default import tPSFNet_config as jax_tpsf_config
from tactilesr_tpu.models.tpsf_net import TPSFNet as JaxTPSFNet
from tactilesr_tpu.ops.pallas.tpsf_kernel import tpsf_physics_fused as jax_fused
from tactilesr_tpu.runtime.optim import adam_l2 as jax_adam_l2
from tactilesr_tpu.runtime.schedule import LRWarmupSchedule as JaxWarmup
from tactilesr_tpu.runtime.schedule import StepLR as JaxStepLR
from tactilesr_tpu.tasks import tpsf_task as jax_task
from tactilesr_torch.compat.from_jax import tpsf_net_state_dict
from tactilesr_torch.config import tPSFNet_config
from tactilesr_torch.data import generate
from tactilesr_torch.models.tpsf_net import TPSFNet
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.psf import physics_plain, physics_vjp_plain
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file
from tactilesr_torch.runtime.hooks import HookBase
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.runtime.trainer import masked_mse
from tactilesr_torch.tasks import tpsf_task

GRAD_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_pallas_kernels.py:45


def _physics_inputs(rng, b=3):
    """Rectangular contact maps (as tests/test_pallas_kernels.py), one with
    sensor-like noise; abm = 0.5 + |N(0, 1)|."""
    depth = np.zeros((b, 100, 100), np.float32)
    for k in range(b):
        depth[k, 20 + 5 * k:60, 30:70 + 3 * k] = 1.0
    depth[0] += 0.01 * rng.standard_normal((100, 100)).astype(np.float32)
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    return depth, abm


def _loss(hr, lr):
    return (lr ** 2).sum() + 1e-6 * hr.sum()


# ------------------------------------------------------------ the physics
def test_fused_gradients_match_jax(rng):
    depth, abm = _physics_inputs(rng)

    def loss_j(d, a):
        hr, lr = jax_fused(d, a)
        return jnp.sum(lr ** 2) + 1e-6 * jnp.sum(hr)

    gd_j, ga_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(abm))
    d = torch.from_numpy(depth).requires_grad_(True)
    a = torch.from_numpy(abm).requires_grad_(True)
    hr, lr = tcuda.tpsf_physics_fused(d, a)
    _loss(hr, lr).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga_j), **GRAD_TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd_j), **GRAD_TOL)
    assert np.abs(np.asarray(gd_j)).max() > 1e-4  # the depth gradient is not trivially 0


def test_fused_backward_is_the_plain_autograd_in_f32(rng, monkeypatch):
    """The CPU backward is one call of physics_vjp_plain, the backward
    kernel's plain version, with TF32 off whatever the global flag says; it
    restores the flag and equals autograd through physics_plain."""
    depth, abm = _physics_inputs(rng, b=2)
    a_ref = torch.from_numpy(abm).requires_grad_(True)
    (physics_plain(torch.from_numpy(depth), a_ref)[1] ** 2).sum().backward()

    seen = []

    def spy(d, a, g_hr, g_lr, need_depth, need_abm):
        seen.append((torch.backends.cuda.matmul.allow_tf32, g_hr is None, need_depth, need_abm))
        return physics_vjp_plain(d, a, g_hr, g_lr, need_depth, need_abm)

    monkeypatch.setattr(tcuda, "physics_vjp_plain", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.from_numpy(abm).requires_grad_(True)
        hr, lr = tcuda.tpsf_physics_fused(torch.from_numpy(depth), a)
        (lr ** 2).sum().backward()  # HR unused: its cotangent never materialises
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [(False, True, False, True)]  # once, f32, LR cotangent only, abm only
    torch.testing.assert_close(a.grad, a_ref.grad, rtol=1e-6, atol=1e-9)


def test_fused_launches_nothing_on_cpu(rng):
    depth, abm = _physics_inputs(rng, b=2)
    before = dict(tcuda.launch_counts)
    hr, lr = tcuda.tpsf_physics_fused(torch.from_numpy(depth), torch.from_numpy(abm))
    assert tcuda.launch_counts == before
    assert hr.shape == (2, 100, 100) and lr.shape == (2, 4, 4)
    with pytest.raises(ValueError, match="abm must be"):
        tcuda.tpsf_physics_fused(torch.from_numpy(depth), torch.ones(3, 3))


# -------------------------------------------------------------- the model
def _jax_variables(seed=0):
    return jax.device_get(JaxTPSFNet().init(jax.random.key(seed), jnp.zeros((1, 3, 4, 4)),
                                            jnp.zeros((1, 1, 100, 100)), return_psf=False))


def _batch(rng, n):
    lr = (rng.random((n, 3, 4, 4)) * 400).astype(np.float32)
    depth = np.zeros((n, 100, 100), np.float32)
    for k in range(n):
        r0, c0 = rng.integers(10, 45, 2)
        r1, c1 = rng.integers(55, 95, 2)
        depth[k, r0:r1, c0:c1] = 1.0
    return lr, depth


def test_tpsf_net_bf16_matches_jax(rng):
    """bf16 MLP products with f32 params on both sides: alpha_beta and the
    loss agree at rtol 1e-2 (bf16 keeps 8 significant bits)."""
    variables = _jax_variables(seed=1)
    lr, depth = _batch(rng, 6)
    lr_in, d4 = lr / 100.0, depth[:, None]
    _hr, deg_j, _psf, ab_j = JaxTPSFNet(dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(lr_in), jnp.asarray(d4), return_psf=False)
    loss_j = float(jnp.mean((deg_j - jnp.asarray(lr_in[:, 2:3])) ** 2))

    net = TPSFNet(dtype=torch.bfloat16)
    net.load_state_dict(tpsf_net_state_dict(variables), strict=True)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        _hr, deg, _psf, ab = net(torch.from_numpy(lr_in), torch.from_numpy(d4), return_psf=False)
    assert ab.dtype == torch.float32 and deg.dtype == torch.float32
    loss = float(masked_mse(torch.from_numpy(lr_in[:, 2:3]), deg, torch.ones(6)))
    np.testing.assert_allclose(ab.numpy(), np.asarray(ab_j), rtol=1e-2)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-2)
    f32 = TPSFNet()
    f32.load_state_dict(net.state_dict())
    with torch.no_grad():
        ab32 = f32(torch.from_numpy(lr_in), torch.from_numpy(d4), return_psf=False)[3]
    assert not torch.equal(ab32, ab)  # the dtype really changed the products


# ------------------------------------------------------------ the trainer
def _toy_config(tmp, **kw):
    cfg = dict(jax_tpsf_config)
    cfg.update(save_dir=str(tmp), train_batch_size=8, compute_dtype="float32",
               matmul_precision="highest", inference_test=False)
    cfg.update(kw)
    return cfg


def _jax_trajectory(tmp, variables, lr, depth, cfg):
    model = jax_task.build_model(cfg)
    sched = JaxWarmup(JaxStepLR(cfg["lr"], 1, 0.8), by_epoch=True, epoch_len=-(-len(lr) // 8))
    t = jax_task.TPSFTrainer(
        config=cfg, model=model, variables={"params": variables["params"], "batch_stats": {}},
        tx=jax_adam_l2(weight_decay=cfg["weight_decay"]), lr_schedule=sched,
        train_arrays={"LR": lr, "depth": depth}, batch_size=8, max_epochs=1,
        work_dir=str(tmp), seed=7)
    t.train(auto_resume=False)
    return t


def _port_trajectory(tmp, variables, lr, depth, cfg, grad_accum=1):
    model = TPSFNet()
    model.load_state_dict(tpsf_net_state_dict(variables), strict=True)
    sched = LRWarmupSchedule(StepLR(cfg["lr"], 1, 0.8), by_epoch=True, epoch_len=-(-len(lr) // 8))
    t = tpsf_task.TPSFTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=sched, train_arrays={"LR": lr, "depth": depth}, batch_size=8,
        max_epochs=1, work_dir=str(tmp), seed=7, grad_accum=grad_accum, device="cpu")
    t.train(auto_resume=False)
    return t


def _losses(t):
    return t.metric_storage["total_loss"].state_dict()["values"]


def test_three_step_trajectory_matches_jax(tmp_path, rng):
    """20 samples at batch 8: three steps, the last of 4 real rows and 4
    padded ones.  Losses at rtol 1e-5, final params at atol 1e-6."""
    variables = _jax_variables(seed=3)
    lr, depth = _batch(rng, 20)
    cfg = _toy_config(tmp_path)
    tj = _jax_trajectory(tmp_path / "jax", variables, lr, depth, cfg)
    tp = _port_trajectory(tmp_path / "port", variables, lr, depth, cfg)
    assert tp.step == 3 and len(_losses(tp)) == 3
    np.testing.assert_allclose(_losses(tp), _losses(tj), rtol=1e-5)
    want = tpsf_net_state_dict(jax.device_get({"params": tj.state.params}))
    got = tp.model.state_dict()
    moved = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
        moved = max(moved, float((v - tpsf_net_state_dict(variables)[k]).abs().max()))
    assert moved > 1e-4  # the params really moved (lr 1e-4, three Adam steps)


def test_grad_accum_matches_full_batch(tmp_path, rng):
    """grad_accum=2 splits each batch of 8 into two of 4; the final batch's
    second half is all padding and is skipped.  Same trajectory as one
    batch: losses at rtol 1e-5, params at atol 1e-6."""
    variables = _jax_variables(seed=4)
    lr, depth = _batch(rng, 20)
    cfg = _toy_config(tmp_path)
    ta = _port_trajectory(tmp_path / "a", variables, lr, depth, cfg, grad_accum=1)
    tb = _port_trajectory(tmp_path / "b", variables, lr, depth, cfg, grad_accum=2)
    np.testing.assert_allclose(_losses(tb), _losses(ta), rtol=1e-5)
    sa, sb = ta.model.state_dict(), tb.model.state_dict()
    for k in sa:
        np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ the entry point
@pytest.fixture
def raw_dir(tmp_path):
    raw = str(tmp_path / "raw")
    generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "I", "P",
                   "--taps-per-blob", "9", "--seqs", "24"])
    return raw


def _argv(raw, work, epochs):
    return ["--device", "cpu", "--dataset_dir", raw, "--save_dir", work, "--epochs", str(epochs),
            "--sample_cnt", "4", "--train_batch_size", "16", "--test_dataset_dir_1",
            os.path.join(raw, "I.npy"), "--test_dataset_dir_2", os.path.join(raw, "P.npy"),
            "--inference_index", "2", "--inference_seqs_length", "4"]


@pytest.fixture
def restore_matmul_precision():
    yield
    torch.set_float32_matmul_precision("highest")


def test_entry_trains_resumes_and_feeds_generation(tmp_path, raw_dir, restore_matmul_precision):
    """The recipe's defaults (bf16 MLP, the wrapper's physics) for one epoch:
    checkpoints, the eval metric, the PNG; a resumed trainer holds the same
    state; ``generate single`` and ``inspect_checkpoint`` read the
    checkpoint."""
    work = str(tmp_path / "work")
    seen = []

    class _EpochProbe(HookBase):
        def after_epoch(self):
            seen.append((self.trainer.cur_epoch, self.trainer.step))

    t = tpsf_task._cli(_argv(raw_dir, work, 1), hooks=[_EpochProbe()])
    assert seen == [(0, 3)]  # a caller's hook runs beside the recipe's
    assert t.model.dtype == torch.bfloat16 and t.model.use_kernel == "auto"
    assert (t.n_train, t.epoch_len, t.step) == (48, 3, 3)
    ck = os.path.join(work, "checkpoints")
    assert sorted(os.listdir(ck)) == ["epoch_0.pth", "latest.pth"]
    assert os.path.exists(os.path.join(work, "inference_result", "epoch_0.png"))
    assert np.isfinite(t.metric_storage["Eval Metric"].latest)

    bundle = load_checkpoint_file(os.path.join(ck, "latest.pth"))
    assert bundle["epoch"] == 0 and bundle["step"] == 3 and bundle["num_devices"] == 1
    assert set(bundle["hooks"]) == {"CheckpointHook"}

    cfg = dict(tPSFNet_config, device="cpu", dataset_dir=raw_dir, save_dir=str(tmp_path / "r"),
               sample_cnt=4, train_batch_size=16, inference_test=False)
    model = tpsf_task.build_model(cfg)
    r = tpsf_task.TPSFTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(1e-4, 1, 0.8), by_epoch=True, epoch_len=3),
        train_arrays={"LR": np.zeros((48, 3, 4, 4), np.float32),
                      "depth": np.zeros((48, 100, 100), np.float32)},
        batch_size=16, max_epochs=2, work_dir=cfg["save_dir"], device="cpu")
    r.load_checkpoint(os.path.join(ck, "latest.pth"))
    assert r.start_iter == 3 and r.step == 3
    for k, v in t.model.state_dict().items():
        assert torch.equal(r.model.state_dict()[k], v)
    so, sr = t.optimizer.state_dict()["state"], r.optimizer.state_dict()["state"]
    for i in so:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(so[i][k], sr[i][k])
    assert r.lr_schedule.state_dict() == t.lr_schedule.state_dict()
    # the final eval logs in after_train, after the checkpoint was written
    assert r.metric_storage.state_dict() == bundle["metric_storage"]
    assert set(t.metric_storage.keys()) - set(r.metric_storage.keys()) == {"Eval Metric", "eval_ssim"}
    assert r.lr == pytest.approx(1e-4 * 0.8)

    out = generate.generate_single_srdataset(os.path.join(ck, "latest.pth"), raw_dir,
                                             str(tmp_path / "sr"), sample_cnt=4,
                                             splits={"test": [0, 6]}, batch=8, device="cpu")
    with np.load(out["test"]) as z:
        assert z["HR"].shape == (24, 1, 100, 100) and np.isfinite(z["HR"]).all()  # 3 blobs x 2 taps x 4

    png = tpsf_task.inspect_checkpoint(dict(cfg, test_dataset_dir_1=os.path.join(raw_dir, "I.npy"),
                                            test_dataset_dir_2=os.path.join(raw_dir, "P.npy"),
                                            inference_index=2, inference_seqs_length=4),
                                       os.path.join(ck, "latest.pth"), str(tmp_path / "x.png"))
    assert os.path.getsize(png) > 0


def test_entry_defaults_to_cuda_and_refuses_unported_options(tmp_path, raw_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train on it")
    argv = _argv(raw_dir, str(tmp_path / "w"), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tpsf_task._cli(argv[2:])  # without --device cpu
    with pytest.raises(ValueError, match="physics_precision"):
        tpsf_task._cli(argv + ["--physics_precision", "default"])
    with pytest.raises(ValueError, match="use_pallas_physics"):
        tpsf_task._cli(argv + ["--use_pallas_physics", "ture"])
    with pytest.raises(NotImplementedError, match="scan_epochs"):
        tpsf_task._cli(argv + ["--scan_epochs", "true"])
    with pytest.raises(NotImplementedError, match="data_parallel"):
        tpsf_task._cli(argv + ["--data_parallel", "4"])
    plain = tpsf_task.build_model(dict(tPSFNet_config, use_pallas_physics="false"))
    assert plain.use_kernel is False

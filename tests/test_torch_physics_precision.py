"""The physics' bf16 modes (``physics_precision: default|high``) in the port
against the JAX package, on the CPU.

JAX's ``tpsf_physics_pallas_raw`` takes a ``precision`` for its four
in-kernel dots (``_sample_body``): DEFAULT is one bf16 MXU pass with f32
accumulation, HIGH three.  XLA on the CPU ignores ``precision``, so these
tests put a thin proxy in place of the kernel module's ``jnp`` whose ``dot``
does on the CPU what the TPU does: DEFAULT rounds both operands to bf16
and multiplies in f32, HIGH sums the three split products hi.hi + hi.lo +
lo.hi (x = hi + lo, both bf16), HIGHEST is unchanged.  Every other name
passes through to ``jax.numpy``; no JAX file changes.

Tolerance of the port against that reference: 1e-3 of the largest |HR| and
|LR|.  Both sides round T = A D to bf16 as the next product's operand, and
their f32 sums run in different orders, so an element of T that lies on a
bf16 rounding boundary can round to neighbouring bf16 values on the two
sides (2^-8 of that element); measured deviations are near 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX trainer's optimizer)
import pytest
import torch

import tactilesr_tpu.ops.pallas.tpsf_kernel as jax_kernel
from tactilesr_tpu.config.default import tPSFNet_config as jax_tpsf_config
from tactilesr_tpu.data import generate as jax_generate
from tactilesr_tpu.models.tpsf_net import TPSFNet as JaxTPSFNet
from tactilesr_tpu.ops.psf import tpsf_forward_physics as jax_forward_physics
from tactilesr_tpu.runtime.checkpoint import save_checkpoint_file as jax_save
from tactilesr_tpu.runtime.optim import adam_l2 as jax_adam_l2
from tactilesr_tpu.runtime.schedule import LRWarmupSchedule as JaxWarmup
from tactilesr_tpu.runtime.schedule import StepLR as JaxStepLR
from tactilesr_tpu.tasks import tpsf_task as jax_task
from tactilesr_torch.compat.from_jax import tpsf_net_state_dict
from tactilesr_torch.data import generate as torch_generate
from tactilesr_torch.data.synthetic import write_raw_blob
from tactilesr_torch.models.tpsf_net import TPSFNet
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.psf import (
    physics_plain,
    physics_vjp_plain,
    resolve_physics_precision,
    tpsf_forward_physics,
)
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.tasks import tpsf_task

P = jax.lax.Precision
JAX_PRECISION = {"default": P.DEFAULT, "high": P.HIGH, "highest": P.HIGHEST}
REL_TOL = 1e-3  # of the largest |HR| or |LR| (the module docstring)


class _TPUDots:
    """``jax.numpy`` with a ``dot`` that rounds as the TPU's MXU does at
    ``precision=DEFAULT`` and ``HIGH`` (the module docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None, precision=None):
        def rnd(x):
            return x.astype(jnp.bfloat16).astype(jnp.float32)

        def f32(x, y):
            return jnp.dot(x, y, preferred_element_type=jnp.float32, precision=P.HIGHEST)

        if precision == P.DEFAULT:
            return f32(rnd(a), rnd(b))
        if precision == P.HIGH:
            a_hi, b_hi = rnd(a), rnd(b)
            a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
            return f32(a_hi, b_hi) + f32(a_hi, b_lo) + f32(a_lo, b_hi)
        return jnp.dot(a, b, preferred_element_type=preferred_element_type, precision=precision)


@pytest.fixture
def tpu_dots(monkeypatch):
    """The proxy in the JAX kernel module, with JAX's caches of traced
    physics emptied so that nothing traced without it is reused."""
    monkeypatch.setattr(jax_kernel, "jnp", _TPUDots())
    monkeypatch.setattr(jax_generate, "_PHYSICS_FWD_CACHE", {})
    jax_kernel.get_fused.cache_clear()
    yield
    jax_kernel.get_fused.cache_clear()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes: the suite runs several worker
    processes at once (as tests/test_torch_sr_train.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, b):
    """Rectangular contact maps (as tests/test_pallas_kernels.py::_inputs),
    the first with sensor-like noise so that depth itself rounds in bf16;
    abm = 0.5 + |N(0, 1)|."""
    depth = np.zeros((b, 100, 100), np.float32)
    for k in range(b):
        depth[k, 20 + 5 * k:60, 30:70 + 3 * k] = 1.0
    depth[0] += 0.05 * np.abs(rng.standard_normal((100, 100))).astype(np.float32)
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    return depth, abm


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ the plain modes
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_plain_matches_jax_kernel(tpu_dots, rng, precision, b):
    depth, abm = _inputs(rng, b)
    hr_j, lr_j = jax_kernel.tpsf_physics_pallas_raw(
        jnp.asarray(depth), jnp.asarray(abm), interpret=True, precision=JAX_PRECISION[precision])
    hr, lr = tcuda.tpsf_physics(torch.from_numpy(depth), torch.from_numpy(abm), precision)
    assert _max_rel(hr.numpy(), hr_j) < REL_TOL
    assert _max_rel(lr.numpy(), lr_j) < REL_TOL
    # the proxy really rounds: the mode differs from f32
    hr32, lr32 = physics_plain(torch.from_numpy(depth), torch.from_numpy(abm))
    assert not torch.equal(lr, lr32)


def test_deviation_from_f32_is_within_jax_envelope(rng):
    """``default`` stays within 1e-2 of max|LR| from f32, the envelope of
    tests/test_pallas_kernels.py::test_precision_knob_matches_reference_numerics;
    ``high`` within 1e-4 (it drops only lo.lo, 2^-16 relative)."""
    depth, abm = (torch.from_numpy(x) for x in _inputs(rng, 4))
    hr32, lr32 = physics_plain(depth, abm)
    for precision, envelope in (("default", 1e-2), ("high", 1e-4)):
        hr, lr = physics_plain(depth, abm, precision)
        dev = _max_rel(lr.numpy(), lr32.numpy())
        assert 0 < dev < envelope, (precision, dev)
        assert _max_rel(hr.numpy(), hr32.numpy()) < 10 * envelope


def test_rounding_points_are_the_kernels(rng):
    """The contact mask and the second max read unrounded f32: a map whose
    contact plateau differs from its rim by less than a bf16 step keeps the
    f32 mask (only the plateau is contact), and the all-zero map gives zero
    HR and LR in every mode."""
    depth = np.zeros((2, 100, 100), np.float32)
    depth[0, 30:70, 30:70] = 1.0
    depth[0, 40:60, 40:60] = 1.0 + 2e-3  # bf16(1 + 2e-3) == 1: rounding it would widen the mask
    abm = np.array([[1.0, 2.0, 1.5], [1.0, 2.0, 1.5]], np.float32)
    d, a = torch.from_numpy(depth), torch.from_numpy(abm)
    hr32, _ = physics_plain(d, a)
    for precision in ("default", "high"):
        hr, lr = physics_plain(d, a, precision)
        plateau = hr[0, 40:60, 40:60]
        assert torch.all(plateau == plateau[0, 0])  # the second max, on the plateau only
        assert not torch.all(hr[0, 30:40, 30:70] == plateau[0, 0])
        assert torch.all(hr[1] == 0) and torch.all(lr[1] == 0)
        assert _max_rel(hr.numpy(), hr32.numpy()) < 1e-2


def test_resolve_physics_precision():
    """As tests/test_pallas_kernels.py::test_resolve_physics_precision."""
    assert resolve_physics_precision(None) == "highest"
    assert resolve_physics_precision("highest") == "highest"
    assert resolve_physics_precision("HIGH") == "high"
    assert resolve_physics_precision("default") == "default"
    for bad in ("bf16", 16, ""):
        with pytest.raises(ValueError, match="physics_precision"):
            resolve_physics_precision(bad)
    with pytest.raises(ValueError, match="physics_precision"):
        tcuda.tpsf_physics(torch.zeros(1, 100, 100), torch.ones(1, 3), "bf16")
    with pytest.raises(ValueError, match="physics_precision"):
        TPSFNet(physics_precision="fp8")


def test_use_kernel_false_ignores_precision(rng):
    """``use_kernel=False`` is the plain f32 physics whatever the precision,
    as JAX's XLA path ignores ``precision``; "auto" on the CPU is the plain
    version of the chosen precision, and launches nothing."""
    depth, abm = (torch.from_numpy(x) for x in _inputs(rng, 3))
    hr32, lr32, _ = tpsf_forward_physics(depth, abm, return_psf=False, use_kernel=False)
    before = dict(tcuda.launch_counts)
    for precision in ("default", "high"):
        hr, lr, _ = tpsf_forward_physics(depth, abm, return_psf=False, use_kernel=False,
                                         precision=precision)
        assert torch.equal(hr, hr32) and torch.equal(lr, lr32)
        hr, lr, _ = tpsf_forward_physics(depth, abm, return_psf=False, precision=precision)
        want = physics_plain(depth, abm, precision)
        assert torch.equal(hr, want[0]) and torch.equal(lr, want[1])
    assert tcuda.launch_counts == before
    hr_x, lr_x, _ = jax_forward_physics(jnp.asarray(depth.numpy()), jnp.asarray(abm.numpy()),
                                        return_psf=False, precision="default")
    np.testing.assert_allclose(lr32.numpy(), np.asarray(lr_x), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ the gradient
def test_fused_gradient_is_f32_at_every_precision(tpu_dots, rng):
    """For a fixed cotangent the backward recomputes in f32 from (depth,
    abm), so the gradient at ``default`` equals the one at ``highest`` bit for
    bit.  Through a loss on the forward's LR only the cotangent moves with
    the precision: the port's gradient at ``default`` equals the f32 VJP of
    its own cotangent, tracks JAX's fused gradient at DEFAULT (under the
    proxy) at rtol 1e-3, as tests/test_pallas_kernels.py::
    test_precision_knob_grad_path holds it against f32, and stays within the
    1e-2 envelope of the f32 gradient (the cotangent 2 LR carries the bf16
    forward's deviation: 3.8e-3 here; that JAX test sees none, since XLA on
    the CPU ignores the precision)."""
    depth, abm = _inputs(rng, 3)
    g_lr = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    grads = {}
    for precision in ("highest", "default", "high"):
        d = torch.from_numpy(depth).requires_grad_(True)
        a = torch.from_numpy(abm).requires_grad_(True)
        _hr, lr = tcuda.tpsf_physics_fused(d, a, precision)
        grads[precision] = torch.autograd.grad(lr, (d, a), g_lr)
    for precision in ("default", "high"):
        assert all(torch.equal(x, y) for x, y in zip(grads[precision], grads["highest"]))

    a = torch.from_numpy(abm).requires_grad_(True)
    _hr, lr = tcuda.tpsf_physics_fused(torch.from_numpy(depth), a, "default")
    (lr ** 2).sum().backward()
    _, own = physics_vjp_plain(torch.from_numpy(depth), torch.from_numpy(abm), None,
                               2 * lr.detach(), need_depth=False)
    assert torch.equal(a.grad, own)
    g_j = jax.grad(lambda x: jnp.sum(jax_kernel.tpsf_physics_fused(
        jnp.asarray(depth), x, precision=P.DEFAULT)[1] ** 2))(jnp.asarray(abm))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-6)
    a32 = torch.from_numpy(abm).requires_grad_(True)
    (physics_plain(torch.from_numpy(depth), a32)[1] ** 2).sum().backward()
    assert 0 < _max_rel(a.grad.numpy(), a32.grad.numpy()) < 1e-2


# ------------------------------------------------------------ the model and stage 1
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


def _toy_config(tmp, **kw):
    cfg = dict(jax_tpsf_config)
    cfg.update(save_dir=str(tmp), train_batch_size=8, compute_dtype="float32",
               matmul_precision="highest", inference_test=False)
    cfg.update(kw)
    return cfg


def _jax_losses(tmp, variables, lr, depth, cfg):
    t = jax_task.TPSFTrainer(
        config=cfg, model=jax_task.build_model(cfg),
        variables={"params": variables["params"], "batch_stats": {}},
        tx=jax_adam_l2(weight_decay=cfg["weight_decay"]),
        lr_schedule=JaxWarmup(JaxStepLR(cfg["lr"], 1, 0.8), by_epoch=True,
                              epoch_len=-(-len(lr) // 8)),
        train_arrays={"LR": lr, "depth": depth}, batch_size=8, max_epochs=1,
        work_dir=str(tmp), seed=7)
    t.train(auto_resume=False)
    return t.metric_storage["total_loss"].state_dict()["values"], t


def _port_losses(tmp, variables, lr, depth, cfg):
    model = tpsf_task.build_model(cfg)
    model.load_state_dict(tpsf_net_state_dict(variables), strict=True)
    t = tpsf_task.TPSFTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], 1, 0.8), by_epoch=True,
                                     epoch_len=-(-len(lr) // 8)),
        train_arrays={"LR": lr, "depth": depth}, batch_size=8, max_epochs=1,
        work_dir=str(tmp), seed=7, device="cpu")
    t.train(auto_resume=False)
    return t.metric_storage["total_loss"].state_dict()["values"], t


@pytest.mark.parametrize("use_pallas", ["true", "false"])
def test_stage1_three_steps_at_default_match_jax(tpu_dots, tmp_path, rng, use_pallas):
    """Three stage-1 steps at ``physics_precision: default`` from one JAX
    init, 20 samples at batch 8 (the last batch half padding), as
    tests/test_torch_tpsf_train.py::test_three_step_trajectory_matches_jax.
    With ``use_pallas_physics: true`` JAX runs the Pallas kernel (interpret
    mode, bf16 dots by the proxy) and the port the plain bf16 version; with
    false both run the f32 plain physics.  Losses at rtol 1e-5, parameters
    at atol 1e-6 (the bf16 forward moves only the loss's cotangent)."""
    variables = _jax_variables(seed=3)
    lr, depth = _batch(rng, 20)
    cfg = _toy_config(tmp_path, use_pallas_physics=use_pallas, physics_precision="default")
    lj, tj = _jax_losses(tmp_path / "jax", variables, lr, depth, cfg)
    lp, tp = _port_losses(tmp_path / "port", variables, lr, depth, cfg)
    assert tp.model.physics_precision == "default"
    assert tp.model.use_kernel == ("auto" if use_pallas == "true" else False)
    assert tp.step == 3 and len(lp) == 3
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    want = tpsf_net_state_dict(jax.device_get({"params": tj.state.params}))
    got = tp.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    l32, _ = _port_losses(tmp_path / "f32", variables, lr, depth,
                          _toy_config(tmp_path, use_pallas_physics=use_pallas))
    if use_pallas == "true":
        assert not np.array_equal(lp, l32)  # the bf16 physics really ran
    else:
        np.testing.assert_array_equal(lp, l32)  # false: f32 whatever the precision


def test_tpsf_net_forward_at_default_matches_jax(tpu_dots, rng):
    """TPSFNet(physics_precision="default") against JAX's
    TPSFNet(use_pallas=True, physics_precision=DEFAULT), one set of weights."""
    variables = _jax_variables(seed=5)
    lr, depth = _batch(rng, 5)
    lr_in, d4 = lr / 100.0, depth[:, None]
    hr_j, deg_j, _psf, ab_j = JaxTPSFNet(use_pallas=True, physics_precision=P.DEFAULT).apply(
        variables, jnp.asarray(lr_in), jnp.asarray(d4), return_psf=False)
    net = TPSFNet(physics_precision="default")
    net.load_state_dict(tpsf_net_state_dict(variables), strict=True)
    with torch.no_grad():
        hr, deg, _psf, ab = net(torch.from_numpy(lr_in), torch.from_numpy(d4), return_psf=False)
    np.testing.assert_allclose(ab.numpy(), np.asarray(ab_j), rtol=1e-5, atol=1e-6)
    assert _max_rel(hr.numpy(), hr_j) < REL_TOL
    assert _max_rel(deg.numpy(), deg_j) < REL_TOL


# ------------------------------------------------------------ generation
def test_generate_single_at_default_matches_jax(tpu_dots, tmp_path, capsys):
    """``generate single --physics-precision default --device cpu`` against
    JAX's ``generate_single_srdataset(use_pallas=True,
    physics_precision="default")`` (the Pallas kernel in interpret mode under
    the proxy), from one raw blob and one set of weights; and
    ``--use-pallas false`` is the f32 physics."""
    raw = tmp_path / "raw"
    write_raw_blob(str(raw / "C.npy"), n_taps=81, seed=0, seqs=24)
    params = _jax_variables(seed=2)
    jax_ckpt = str(tmp_path / "tpsf.ckpt")
    jax_save(jax_ckpt, {"num_devices": 1, "model": {"params": params["params"], "batch_stats": {}},
                        "epoch": 0})
    port_ckpt = save_checkpoint_file(str(tmp_path / "tpsf.pth"), tpsf_net_state_dict(params))
    pj = jax_generate.generate_single_srdataset(
        jax_ckpt, str(raw), str(tmp_path / "jax"), sample_cnt=2, use_pallas=True,
        physics_precision="default", batch=32)
    base = ["single", "--tpsf-checkpoint", port_ckpt, "--raw-dir", str(raw), "--sample-cnt", "2",
            "--batch", "32", "--device", "cpu"]
    torch_generate._cli(base + ["--out-dir", str(tmp_path / "bf16"), "--physics-precision",
                                "default"])
    torch_generate._cli(base + ["--out-dir", str(tmp_path / "off"), "--physics-precision",
                                "default", "--use-pallas", "false"])
    torch_generate._cli(base + ["--out-dir", str(tmp_path / "f32")])
    assert "test:" in capsys.readouterr().out
    for split, n in (("test", 8), ("validation", 8), ("train", 56)):  # 4 / 4 / 28 taps x 2
        name = f"SRdataset_{split}.npz"
        with np.load(pj[split]) as zj, np.load(tmp_path / "bf16" / name) as zt, \
                np.load(tmp_path / "off" / name) as zo, np.load(tmp_path / "f32" / name) as zf:
            assert zt["HR"].shape == (n, 1, 100, 100)
            np.testing.assert_array_equal(zt["LR"], zj["LR"])
            np.testing.assert_allclose(zt["alphaBeta"], zj["alphaBeta"], rtol=1e-5, atol=1e-6)
            assert _max_rel(zt["HR"], zj["HR"]) < REL_TOL
            assert _max_rel(zt["LR_degrade"], zj["LR_degrade"]) < REL_TOL
            assert 0 < _max_rel(zt["LR_degrade"], zf["LR_degrade"]) < 1e-2
            for k in ("HR", "LR_degrade"):
                np.testing.assert_array_equal(zo[k], zf[k])
    with pytest.raises(SystemExit):
        torch_generate._cli(base + ["--out-dir", str(tmp_path / "x"), "--physics-precision", "f16"])
    with pytest.raises(ValueError, match="use_pallas_physics"):
        torch_generate._cli(base + ["--out-dir", str(tmp_path / "x"), "--use-pallas", "maybe"])
    assert not os.path.exists(tmp_path / "x" / "SRdataset_test.npz")

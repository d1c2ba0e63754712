"""TactileSRCNN (the IROS-2022 baseline) and LeakyResBlock in the port
against the JAX package, on the CPU at toy size (scale 4, one MSRB unless
a test says otherwise): the eval and train forwards with their BatchNorm
statistics (f32 and bf16), the weight bridge's CNN tree, the fold with the
fused forward, ``SRPredictor(model_arch="TactileSRCNN")``, a 3-step
``SRTrainer`` trajectory and the recipe's CNN switch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_sr_config, toy_sr_data
from tactilesr_tpu.compat.export_torch import export_tactile_srcnn
from tactilesr_tpu.models.blocks import LeakyResBlock as JaxLeakyResBlock
from tactilesr_tpu.models.inference import fold_inference_params_cnn as jax_fold_cnn
from tactilesr_tpu.models.inference import tactile_sr_cnn_infer as jax_cnn_infer
from tactilesr_tpu.models.tactile_sr import TactileSRCNN as JaxTactileSRCNN
from tactilesr_tpu.runtime import LRWarmupSchedule as JaxLRWarmupSchedule
from tactilesr_tpu.runtime import StepLR as JaxStepLR
from tactilesr_tpu.runtime import adam_l2 as jax_adam_l2
from tactilesr_tpu.runtime.hooks import HookBase as JaxHookBase
from tactilesr_tpu.tasks import sr_task as jax_sr_task
from tactilesr_torch.compat.from_jax import tactile_srcnn_state_dict
from tactilesr_torch.models.blocks import LeakyResBlock
from tactilesr_torch.models.inference import fold_inference_params_cnn, tactile_sr_cnn_infer
from tactilesr_torch.models.tactile_sr import TactileSRCNN
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.runtime.hooks import HookBase
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.serving import SRPredictor
from tactilesr_torch.tasks import sr_task


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes: the suite runs several worker
    processes at once, and torch's one thread per core in each of them
    oversubscribes the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_cnn(msrb_cnt=1, dtype=jnp.float32, head_init="reference"):
    return JaxTactileSRCNN(scale_factor=4, msrb_cnt=msrb_cnt, dtype=dtype, head_init=head_init)


def _jax_variables(msrb_cnt=1, seed=0):
    """Weights from a non-negative head draw: a sign-random draw of the
    one-channel head can leave the ReLU output all zero, which would make
    the comparisons below vacuous."""
    v = jax.device_get(_jax_cnn(msrb_cnt, head_init="non_negative").init(
        jax.random.key(seed), jnp.zeros((1, 3, 4, 4)), train=False))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _perturbed(variables, rng):
    """BN running statistics off their init (mean 0, var 1), so the eval
    forward and the fold read real statistics."""
    def draw(path, a):
        if path[-1].key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])}


def _port_cnn(variables, msrb_cnt=1, dtype=torch.float32):
    model = TactileSRCNN(scale_factor=4, msrb_cnt=msrb_cnt, dtype=dtype)
    model.load_state_dict(tactile_srcnn_state_dict(variables), strict=True)
    return model


def test_bridge_matches_the_jax_exporter():
    """The port's CNN tree and the JAX package's torch exporter give the
    same keys, shapes and values, and the port's model takes them with
    strict=True (6 MSRBs, the reference's depth)."""
    variables = _jax_variables(msrb_cnt=6, seed=3)
    got = tactile_srcnn_state_dict(variables)
    want = export_tactile_srcnn(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert set(TactileSRCNN().state_dict()) == set(got)
    assert {k.split(".")[0] for k in got} == {"input_zyx", "msrb_layer", "output"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forwards_and_running_stats_match_jax(rng, dtype):
    """The eval forward (perturbed running statistics) and one train-mode
    forward with its BN update, from one set of weights.  f32: outputs
    atol 1e-5 x max|out|, statistics atol 1e-6.  bf16: outputs within 5e-2
    of the output range, statistics atol 1e-4 (bf16 keeps 8 significant
    bits; the TactileSR test's rule)."""
    variables = _perturbed(_jax_variables(seed=1), rng)
    x = (rng.random((8, 3, 4, 4)) * 4).astype(np.float32)
    jmodel = _jax_cnn(dtype=JAX_DTYPES[dtype])
    eval_j = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    train_j, mutated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    train_j = np.asarray(train_j)
    want = tactile_srcnn_state_dict({"params": variables["params"],
                                     "batch_stats": mutated["batch_stats"]})

    model = _port_cnn(variables, dtype=dtype)
    with torch.no_grad():
        eval_p = model.eval()(torch.from_numpy(x)).numpy()
        train_p = model.train()(torch.from_numpy(x)).numpy()
    f32 = dtype == torch.float32
    for got, ref in ((eval_p, eval_j), (train_p, train_j)):
        assert got.shape == ref.shape == (8, 1, 16, 16) and got.dtype == np.float32
        span = float(np.abs(ref).max())
        assert span > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=(1e-5 if f32 else 5e-2) * span)
    sd = model.state_dict()
    n_bn = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            n_bn += 1
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-6 if f32 else 1e-4,
                                       err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1
    assert n_bn == 2 * (3 + 4)  # mean and var: three input BNs, four in the MSRB


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_and_fused_forward_match_jax(rng, dtype):
    """fold_inference_params_cnn + tactile_sr_cnn_infer against the JAX fold
    and fused forward on perturbed statistics, 2 MSRBs.  f32: rtol 1e-5,
    atol 1e-5 x max|out|, and the fused f32 graph equals the port's own
    eval forward at the same tolerance.  bf16: within 5e-2 of the range."""
    variables = _perturbed(_jax_variables(msrb_cnt=2, seed=2), rng)
    x = (rng.random((5, 3, 4, 4)) * 4).astype(np.float32)
    want = np.asarray(jax_cnn_infer(jax_fold_cnn(variables, msrb_cnt=2, dtype=JAX_DTYPES[dtype]),
                                    jnp.asarray(x), scale_factor=4, msrb_cnt=2))
    folded = fold_inference_params_cnn(tactile_srcnn_state_dict(variables), msrb_cnt=2, dtype=dtype)
    got = tactile_sr_cnn_infer(folded, torch.from_numpy(x), scale_factor=4, msrb_cnt=2).numpy()
    span = float(np.abs(want).max())
    assert got.shape == (5, 1, 16, 16) and span > 0
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * span)
        with torch.no_grad():
            own = _port_cnn(variables, msrb_cnt=2).eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, own, rtol=1e-5, atol=1e-5 * span)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * span)
    with pytest.raises(ValueError, match="msrb_cnt=1"):
        fold_inference_params_cnn(tactile_srcnn_state_dict(variables), msrb_cnt=1)


def test_sr_predictor_serves_the_cnn(tmp_path, rng):
    """SRPredictor(model_arch="TactileSRCNN"), fused and unfused, f32, with
    a padded bucket: the JAX eval forward at rtol 1e-4 / atol 1e-5 (the
    STSR serving test's rule).  seqs_cnt 7 and an unknown arch raise; a
    TactileSR checkpoint is refused and the CNN's weights keep serving."""
    variables = _perturbed(_jax_variables(seed=4), rng)
    path = save_checkpoint_file(str(tmp_path / "cnn.pth"), tactile_srcnn_state_dict(variables))
    lr = (rng.random((5, 3, 4, 4)) * 4).astype(np.float32)
    want = np.asarray(_jax_cnn().apply(variables, jnp.asarray(lr), train=False))
    kw = dict(scale_factor=4, pattern_layers=1, compute_dtype="float32", buckets=(1, 8),
              device="cpu", model_arch="TactileSRCNN")
    for fused in (True, False):
        pred = SRPredictor(path, fused=fused, **kw)
        got = pred.predict(lr)
        assert got.shape == (5, 1, 16, 16)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    sr_path = save_checkpoint_file(str(tmp_path / "sr.pth"), sr_task.build_model(
        toy_sr_config(str(tmp_path))).state_dict())
    with pytest.raises((KeyError, ValueError)):
        pred.reload_checkpoint(sr_path)
    np.testing.assert_array_equal(pred.predict(lr), got)
    with pytest.raises(ValueError, match="single-frame"):
        SRPredictor(path, seqs_cnt=7, **kw)
    with pytest.raises(ValueError, match="model_arch"):
        SRPredictor(path, **dict(kw, model_arch="SRCNN"))


def test_leaky_res_block_matches_jax(rng):
    """Train-mode and eval-mode forwards and the BN update, f32: outputs
    atol 1e-5 x max|out|, statistics atol 1e-6.  Slope 1.0 inside (the
    identity) and 0.2 after the residual sum."""
    block_j = JaxLeakyResBlock(n_feats=8)
    x = rng.standard_normal((4, 6, 6, 8)).astype(np.float32)  # NHWC for JAX
    v = jax.device_get(block_j.init(jax.random.key(0), jnp.asarray(x), train=False))
    train_j, mutated = block_j.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    eval_j = block_j.apply({"params": v["params"], "batch_stats": mutated["batch_stats"]},
                           jnp.asarray(x), train=False)

    block = LeakyResBlock(n_feats=8)
    sd = {}
    for c in ("conv1", "conv2"):
        sd[f"{c}.weight"] = torch.from_numpy(np.asarray(v["params"][c]["conv"]["kernel"]).transpose(3, 2, 0, 1).copy())
    for b in ("bn1", "bn2"):
        sd[f"{b}.weight"] = torch.from_numpy(np.asarray(v["params"][b]["scale"]).copy())
        sd[f"{b}.bias"] = torch.from_numpy(np.asarray(v["params"][b]["bias"]).copy())
        sd[f"{b}.running_mean"] = torch.from_numpy(np.asarray(v["batch_stats"][b]["mean"]).copy())
        sd[f"{b}.running_var"] = torch.from_numpy(np.asarray(v["batch_stats"][b]["var"]).copy())
        sd[f"{b}.num_batches_tracked"] = torch.tensor(0)
    block.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        train_p = block.train()(xt).numpy().transpose(0, 2, 3, 1)
        eval_p = block.eval()(xt).numpy().transpose(0, 2, 3, 1)
    for got, ref in ((train_p, train_j), (eval_p, eval_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))
    for b in ("bn1", "bn2"):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(block.state_dict()[f"{b}.{ours}"].numpy(),
                                       np.asarray(mutated["batch_stats"][b][theirs]), rtol=0, atol=1e-6)
    assert bool((train_p < 0).any())  # the 0.2 slope passes negative values


def test_head_init_and_recipe_switch(tmp_path):
    """non_negative folds output.0 to |w| / sqrt(576) (fan_in 64 x 3 x 3),
    every other tensor bit for bit; sr_task.build_model builds the CNN for
    model_arch TactileSRCNN (6 MSRBs, as the JAX recipe) and raises
    ValueError unless seqsCnt is 1, or for an unknown arch."""
    def make(head_init):
        return TactileSRCNN(scale_factor=4, msrb_cnt=1, generator=torch.Generator().manual_seed(3),
                            head_init=head_init).state_dict()

    ref, nonneg = make("reference"), make("non_negative")
    for k in ref:
        if k == "output.0.weight":
            torch.testing.assert_close(nonneg[k], ref[k].abs() / 576 ** 0.5, rtol=1e-6, atol=0)
        else:
            assert torch.equal(nonneg[k], ref[k]), k
    cfg = toy_sr_config(str(tmp_path), model_arch="TactileSRCNN")
    model = sr_task.build_model(cfg)
    assert isinstance(model, TactileSRCNN) and len(model.msrb_layer) == 6
    assert type(jax_sr_task.build_model(cfg)).__name__ == "TactileSRCNN"
    with pytest.raises(ValueError, match="single-frame"):
        sr_task.build_model(dict(cfg, seqsCnt=7))
    with pytest.raises(ValueError, match="model_arch"):
        sr_task.build_model(dict(cfg, model_arch="SRCNN"))


class _Snaps:
    def __init__(self):
        self.states = []

    def jax_hook(self):
        outer = self

        class _Hook(JaxHookBase):
            def after_iter(self):
                outer.states.append(tactile_srcnn_state_dict(jax.device_get(
                    {"params": self.trainer.state.params, "batch_stats": self.trainer.state.batch_stats})))
        return _Hook()

    def port_hook(self):
        outer = self

        class _Hook(HookBase):
            def after_iter(self):
                outer.states.append({k: v.clone() for k, v in self.trainer.model.state_dict().items()})
        return _Hook()


def test_three_step_trajectory_matches_jax(tmp_path, rng):
    """20 samples at batch 8 (the last step half padding), lr 1e-3, weight
    decay 1e-2, f32, one MSRB, from one init.  Losses at rtol 1e-4; after
    step 1 the BN statistics at atol 1e-5, after step 3 at 5e-4; parameters
    per element: none beyond 2 x lr x steps, the conv biases ahead of a BN
    aside (their true gradient is 0, so Adam turns rounding into steps of
    lr), and all but a share within 1e-5 (tests/test_torch_sr_train.py's
    rule and its reason).  The share is 1% after step 1 and 5% after step
    3: the CNN's convs all feed BNs, and after 3 steps both packages' f32
    runs part from a float64 run of the same steps in 16-17% of the
    elements, and from each other in 3.1% (measured)."""
    lr, hr = toy_sr_data(rng, n=20)
    cfg = toy_sr_config(str(tmp_path / "jax"), model_arch="TactileSRCNN")
    init = _jax_variables(seed=7)
    sched = dict(by_epoch=True, epoch_len=3)
    tj = jax_sr_task.SRTrainer(
        config=cfg, model=_jax_cnn(), variables=init, tx=jax_adam_l2(weight_decay=cfg["weight_decay"]),
        lr_schedule=JaxLRWarmupSchedule(JaxStepLR(cfg["lr"], cfg["lr_scheduler_step_size"],
                                                  cfg["lr_scheduler_gamma"]), **sched),
        train_arrays={"LR": lr, "HR": hr}, batch_size=8, max_epochs=1, work_dir=cfg["save_dir"],
        seed=42)
    snap_j, snap_p = _Snaps(), _Snaps()
    tj.register_hooks([snap_j.jax_hook()])
    tj.train(auto_resume=False)

    model = _port_cnn(init)
    tp = sr_task.SRTrainer(
        config=dict(cfg, save_dir=str(tmp_path / "port")), model=model,
        optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], cfg["lr_scheduler_step_size"],
                                            cfg["lr_scheduler_gamma"]), **sched),
        train_arrays={"LR": lr, "HR": hr}, batch_size=8, max_epochs=1,
        work_dir=str(tmp_path / "port"), seed=42, device="cpu")
    tp.register_hooks([snap_p.port_hook()])
    tp.train(auto_resume=False)

    loss_j = tj.metric_storage["total_loss"].state_dict()["values"]
    loss_p = tp.metric_storage["total_loss"].state_dict()["values"]
    assert tp.step == 3 and len(loss_p) == 3 and len(snap_p.states) == len(snap_j.states) == 3
    np.testing.assert_allclose(loss_p, loss_j, rtol=1e-4)
    for step, stats_atol, share in ((1, 1e-5, 0.01), (3, 5e-4, 0.05)):
        got, want = snap_p.states[step - 1], snap_j.states[step - 1]
        over = total = 0
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == step, k
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=stats_atol, err_msg=k)
            else:
                d = (got[k] - v).abs()
                assert float(d.max()) <= 2 * cfg["lr"] * step, (k, float(d.max()))
                if not (k.startswith("msrb_layer.") and k.endswith(".0.bias")):
                    over, total = over + int((d > 1e-5).sum()), total + d.numel()
        assert over <= share * total, (step, over, total)
    start = tactile_srcnn_state_dict(init)
    assert max(float((v - start[k]).abs().max()) for k, v in snap_p.states[2].items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))) > 1e-4

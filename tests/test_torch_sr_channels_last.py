"""The SR networks trained channels-last (NHWC) in bf16, as the trainer
runs them on CUDA, against the same weights run NCHW: the layer rule of
``models/layers.py`` (a channels-last BatchNorm input goes to
``nn.BatchNorm2d`` as it is, an NCHW one through an f32 copy), its
counters, and the trainer's state across layouts (``state_digest``,
checkpoints, served outputs, a resume's Adam state).  On the CPU the tests
convert a model to channels-last themselves; the ``gpu`` tests check that
the trainer does so on the card and that its captured step runs every
BatchNorm on NHWC bf16 tensors.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_sr_channels_last.py -q

Tolerances.  bf16 NHWC and bf16 NCHW part by the order of their sums (the
same roundings to bf16, at the same places), so each is held to the
distance between the bf16 NCHW path and the same weights in f32: per
parameter, the NHWC gradient lies within 3x that distance of the NCHW one
(toy models, batch 8: at most 1.7x measured), the loss within 2e-3
relative (4e-4 measured, about a tenth of a bf16 ulp) and the running
statistics within 1e-4 (5e-6 measured; both paths take them in f32).
"""

import copy

import numpy as np
import pytest
import torch

from tactilesr_torch.config import tactileSR_config
from tactilesr_torch.models import layers
from tactilesr_torch.models.inference import fold_inference_params, tactile_sr_infer
from tactilesr_torch.models.tactile_sr import TactileSR, TactileSRCNN
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
from tactilesr_torch.serving import SRPredictor
from tactilesr_torch.tasks import sr_task

CL = torch.channels_last


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes (several test workers share
    the CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trainer converts to channels-last on CUDA only")
    return torch.device("cuda")


def _is_cl(t):
    return t.is_contiguous(memory_format=CL) and not t.is_contiguous()


# (model, convs fed by an NCHW upsample: each pattern branch's first and the force branch's)
MODELS = {
    "stsr": (lambda dt: TactileSR(4, 1, 3, 1, 1, dtype=dt, generator=torch.Generator().manual_seed(3)), 2),
    "mtsr2": (lambda dt: TactileSR(4, 2, 3, 1, 1, dtype=dt, generator=torch.Generator().manual_seed(3)), 3),
    "cnn": (lambda dt: TactileSRCNN(4, 1, 3, dtype=dt, generator=torch.Generator().manual_seed(3)), 1),
}


def _step(model, x, y):
    """One train-mode forward and backward: (loss, grads, buffers, the
    layer counters' gains, each BatchNorm's output)."""
    model.train()
    outs = []
    hooks = [m.register_forward_hook(lambda m, i, o: outs.append(o))
             for m in model.modules() if isinstance(m, layers.BatchNorm)]
    before = dict(layers.layer_counts)
    loss = ((model(x) - y) ** 2).mean()
    loss.backward()
    for h in hooks:
        h.remove()
    gains = {k: n - before[k] for k, n in layers.layer_counts.items()}
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, gains, outs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_channels_last_step_matches_nchw(name):
    """One train-mode step of the same weights NHWC and NCHW in bf16, held
    to the bf16 path's own distance from f32 (module docstring); every
    BatchNorm output stays bf16 in its input's layout, and the counters
    see every BatchNorm and every conv past the upsample take NHWC."""
    make, nchw_convs = MODELS[name]
    ref = make(torch.float32)
    nchw = make(torch.bfloat16)
    cl = copy.deepcopy(nchw).to(memory_format=CL)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((8, nchw.seqs_cnt * 3, 4, 4), generator=g) * 4
    y = torch.rand((8, 1, 16, 16), generator=g) * 10
    lf, gf, _, _, _ = _step(ref, x, y)
    la, ga, ba, na, oa = _step(nchw, x, y)
    lb, gb, bb, nb, ob = _step(cl, x, y)

    assert abs(float(lb - la)) <= 2e-3 * abs(float(la))
    for n, want in ga.items():
        noise = float((want - gf[n]).norm())
        assert float((gb[n] - want).norm()) <= 3 * noise, (n, float((gb[n] - want).norm()), noise)
    for n, want in ba.items():
        torch.testing.assert_close(bb[n], want, rtol=0, atol=1e-4, msg=n)

    assert len(ob) == na["sr_bn"] > 0
    assert all(o.dtype == torch.bfloat16 and _is_cl(o) for o in ob)
    assert all(o.dtype == torch.bfloat16 and not _is_cl(o) for o in oa)
    assert nb["sr_bn_nhwc"] == nb["sr_bn"] == na["sr_bn"] and na["sr_bn_nhwc"] == 0
    assert nb["sr_conv_nhwc"] == nb["sr_conv"] - nchw_convs and na["sr_conv_nhwc"] == 0


@pytest.mark.parametrize("shape", [(4, 8, 5, 5), (4, 8, 1, 1)], ids=["nchw", "one_pixel"])
def test_nchw_batchnorm_keeps_its_f32_path(shape):
    """An NCHW input (and one that is NHWC and NCHW at once) is normalised
    in an f32 copy and cast back, bit for bit as before, and is not counted
    as NHWC."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    if shape[2:] == (1, 1):
        x = x.contiguous(memory_format=CL)
    bn, plain = layers.BatchNorm(8), torch.nn.BatchNorm2d(8)
    before = dict(layers.layer_counts)
    got = bn(x)
    want = plain(x.float()).to(torch.bfloat16)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    assert torch.equal(bn.running_var, plain.running_var)
    assert layers.layer_counts["sr_bn"] == before["sr_bn"] + 1
    assert layers.layer_counts["sr_bn_nhwc"] == before["sr_bn_nhwc"]


def test_memory_format_follows_the_device():
    assert layers.memory_format("cuda") == layers.memory_format(torch.device("cuda", 1)) == CL
    assert layers.memory_format("cpu") == torch.contiguous_format


# ------------------------------------------------------------ the trainer
def _config(tmp_path, name):
    return dict(tactileSR_config, save_dir=str(tmp_path / name), train_batch_size=8, test_batch_size=4,
                patternFeatureExtraLayerCnt=1, scale_factor=4, warmup_t=0, compute_dtype="bfloat16",
                inference_test=False)


def _data(n=20):
    rng = np.random.default_rng(0)
    lr = (rng.random((n, 3, 4, 4)) * 4).astype(np.float32)
    hr = np.repeat(np.repeat(lr[:, 2:3], 25, axis=2), 25, axis=3).astype(np.float32)
    return lr, hr


def _trainer(tmp_path, name, device="cpu", channels_last=False, max_epochs=1, **kw):
    """A bf16 toy SRTrainer (20 rows at batch 8: 3 steps an epoch);
    ``channels_last`` True converts its model afterwards, as the trainer
    does on CUDA, False puts it in NCHW, None leaves the trainer's own."""
    cfg = _config(tmp_path, name)
    lr, hr = _data()
    model = sr_task.build_model(cfg)
    t = sr_task.SRTrainer(
        config=cfg, model=model, optimizer=adam_l2(model.parameters(), cfg["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(cfg["lr"], 2, 0.8), by_epoch=True, epoch_len=3),
        train_arrays={"LR": lr, "HR": hr}, batch_size=8, max_epochs=max_epochs,
        work_dir=cfg["save_dir"], seed=42, device=device, **kw)
    if channels_last is not None:
        t.model.to(memory_format=CL if channels_last else torch.contiguous_format)
    return t


def _assert_state_follows_params(t, cl):
    convs = [p for p in t.model.parameters() if p.dim() == 4]
    assert convs and all(p.is_contiguous(memory_format=CL if cl else torch.contiguous_format)
                         for p in convs)
    state = t.optimizer.optimizer.state
    for p in t.optimizer.params:
        for k in ("exp_avg", "exp_avg_sq"):
            assert state[p][k].stride() == p.stride(), k


def _nchw_copy(tmp_path, t, name):
    """An NCHW CPU trainer holding ``t``'s model and optimizer state."""
    u = _trainer(tmp_path, name)
    u.model.load_state_dict({k: v.cpu() for k, v in t.model.state_dict().items()})
    u.optimizer.load_state_dict(t.optimizer.state_dict())
    return u


def _served(path, device="cpu"):
    pred = SRPredictor(str(path), scale_factor=4, pattern_layers=1, force_layers=1, buckets=(8,),
                       device=device)
    return pred.predict(_data()[0][:8])


def test_channels_last_state_digest_checkpoint_and_serving(tmp_path):
    """A channels-last-trained state digests as the same state in NCHW;
    its checkpoint loads into a fresh NCHW model, whose fold computes what
    the checkpoint's own channels-last tensors fold to, and it serves what
    the same state written from NCHW parameters serves."""
    t = _trainer(tmp_path, "cl", channels_last=True)
    t.train(auto_resume=False)
    _assert_state_follows_params(t, cl=True)
    u = _nchw_copy(tmp_path, t, "nchw")
    _assert_state_follows_params(u, cl=False)
    assert u.state_digest() == t.state_digest()

    ckpt = tmp_path / "cl" / "checkpoints" / "latest.pth"
    saved = load_checkpoint_file(str(ckpt))["model"]
    assert any(_is_cl(v) for v in saved.values())
    fresh = sr_task.build_model(t.config)
    fresh.load_state_dict(saved)
    assert all(v.is_contiguous() for v in fresh.state_dict().values())
    x = torch.from_numpy(_data()[0][:8])
    fold = dict(pattern_layers=1, force_layers=1, dtype=torch.float32)
    infer = dict(scale_factor=4, pattern_layers=1, force_layers=1)
    want = tactile_sr_infer(fold_inference_params(saved, **fold), x, **infer)
    got = tactile_sr_infer(fold_inference_params(fresh.state_dict(), **fold), x, **infer)
    assert torch.equal(got, want)
    u.save_checkpoint("nchw.pth")
    np.testing.assert_array_equal(_served(ckpt), _served(tmp_path / "nchw" / "checkpoints" / "nchw.pth"))


@pytest.mark.parametrize("saved_cl", [False, True], ids=["nchw_into_cl", "cl_into_nchw"])
def test_resume_puts_adam_state_in_the_params_layout(tmp_path, saved_cl):
    """A resume loads the checkpoint's Adam moments in its own parameters'
    layout, whichever layout wrote them, and its state digests as a resume
    of the other layout."""
    first = _trainer(tmp_path, "w", channels_last=saved_cl)
    first.train(auto_resume=False)
    ckpt = str(tmp_path / "w" / "checkpoints" / "latest.pth")
    again = _trainer(tmp_path, "a", channels_last=not saved_cl, max_epochs=2)
    again.load_checkpoint(ckpt)
    _assert_state_follows_params(again, cl=not saved_cl)
    same = _trainer(tmp_path, "b", channels_last=saved_cl, max_epochs=2)
    same.load_checkpoint(ckpt)
    assert again.state_digest() == same.state_digest() == first.state_digest()
    again.train(resume_from_checkpoint=ckpt)
    assert again.step == 6 and np.isfinite(again.metric_storage["total_loss"].state_dict()["values"]).all()


def _losses(t):
    return t.metric_storage["total_loss"].state_dict()["values"]


@pytest.mark.gpu
def test_cuda_trainer_trains_channels_last(tmp_path, dev):
    """On CUDA the trainer makes the model's 4-D parameters channels-last.
    Over 2 scan epochs (3 eager steps, the capture, 3 replays) every
    BatchNorm call takes the NHWC path and every conv but the two fed by
    the upsample gets an NHWC input, replays counted; Adam's moments take
    the parameters' layout; the losses follow an NCHW run of the same
    weights on the card (bf16 trajectories part by rounding, which Adam
    turns into steps of up to lr on near-zero gradients: rtol 2e-2); the
    state digests as in an NCHW CPU trainer, and its checkpoint serves what
    that trainer's does."""
    before = dict(layers.layer_counts)
    t = _trainer(tmp_path, "cl", device=dev, channels_last=None, max_epochs=2, scan_epochs=True)
    t.train(auto_resume=False)
    gains = {k: n - before[k] for k, n in layers.layer_counts.items()}
    assert t._graph is not None and t.step == 6
    _assert_state_follows_params(t, cl=True)
    assert gains["sr_bn"] == 6 * 7 and gains["sr_bn_nhwc"] == gains["sr_bn"]
    assert gains["sr_conv"] == 6 * 13 and gains["sr_conv_nhwc"] == gains["sr_conv"] - 6 * 2

    u = _trainer(tmp_path, "nchw", device=dev, channels_last=False, max_epochs=2, scan_epochs=True)
    u.train(auto_resume=False)
    _assert_state_follows_params(u, cl=False)
    np.testing.assert_allclose(_losses(t), _losses(u), rtol=2e-2)

    copied = _nchw_copy(tmp_path, t, "copy")
    assert copied.state_digest() == t.state_digest()
    copied.save_checkpoint("nchw.pth")
    np.testing.assert_array_equal(_served(tmp_path / "cl" / "checkpoints" / "latest.pth"),
                                  _served(tmp_path / "copy" / "checkpoints" / "nchw.pth"))


@pytest.mark.gpu
def test_cuda_resume_from_an_nchw_checkpoint(tmp_path, dev):
    """A CPU-trained (NCHW) checkpoint resumes a CUDA scan run: Adam's
    moments come back channels-last, the state digests as the CPU
    trainer's, and the run trains on (epochs 1 and 2: 3 eager steps, then
    the capture)."""
    first = _trainer(tmp_path, "w")
    first.train(auto_resume=False)
    ckpt = str(tmp_path / "w" / "checkpoints" / "latest.pth")
    again = _trainer(tmp_path, "a", device=dev, channels_last=None, max_epochs=3, scan_epochs=True)
    again.load_checkpoint(ckpt)
    _assert_state_follows_params(again, cl=True)
    assert again.state_digest() == first.state_digest()
    again.train(resume_from_checkpoint=ckpt)
    _assert_state_follows_params(again, cl=True)
    assert again.step == 9 and again._graph is not None and np.isfinite(_losses(again)).all()

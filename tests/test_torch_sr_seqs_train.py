"""The MTSR recipe's trainer, ``sr_task.build_trainer(..., seqs=True)``, on
the CPU at toy widths (``seqsCnt`` 7, scale 2, 1 MSRB, 1 ResBlock, f32):
its first steps against the plain f32 reference
(``perfbench/reference/model.py::train_steps``) from the same transferred
state, the trunk transfer, the warm-up rule, both entries training through
it, the pattern-branch counters, and the ``mtsr7-train-b32`` cell at toy
size (a sound run is correct, runs with a planted fault are not)."""

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.reference.model import build as reference_model, train_steps
from tactilesr_torch.config import tactileSeqs_config
from tactilesr_torch.models import layers
from tactilesr_torch.models.tactile_sr import TactileSR
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.runtime.hooks import HookBase
from tactilesr_torch.tasks import sr_seqs_task, sr_task

SEED = 2**31 + 23
ROWS, BATCH = 12, 4  # three steps an epoch
TRUNK = ("patternFeatureExtra_layer.", "forceFeatureExtra_layer.")  # upstream tactileSRSeqs_train.py's transfer
ADAM_B1 = 0.9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes, as in test_torch_sr_train.py:
    the suite's worker processes would oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(tmp_path, **over):
    """tactileSeqs_config at toy widths, with a warm-up the seqs recipe must
    leave off (``fix`` from 1e-9: a first rate far from the base)."""
    return dict(tactileSeqs_config, scale_factor=2, patternFeatureExtraLayerCnt=1, forceFeatureExtraLayerCnt=1,
                compute_dtype="float32", train_batch_size=BATCH, device="cpu", random_seed=SEED,
                save_dir=str(tmp_path / "work"), load_checkpoint_dir=str(tmp_path / "stsr.pth"),
                warmup_t=100, warmup_mode="fix", warmup_init_lr=1e-9, inference_test=False, **over)


def _rows():
    g = torch.Generator().manual_seed(7)
    return (4 * torch.rand((ROWS, 21, 4, 4), generator=g)).numpy(), \
        (50 * torch.rand((ROWS, 1, 100, 100), generator=g)).numpy()


def _stsr_bundle(cfg) -> dict:
    """An STSR of the config's widths from another seed, written where
    ``load_checkpoint_dir`` points; its state_dict."""
    stsr = sr_task.build_model(dict(cfg, seqsCnt=1, random_seed=SEED + 1)).state_dict()
    save_checkpoint_file(cfg["load_checkpoint_dir"], stsr)
    return stsr


class _Watch(HookBase):
    """The first step's gradient with its decay term (Adam's first moment
    over 1 - b1) and, after the last step, the parameters and BN statistics."""

    def __init__(self, last: int):
        self.last, self.grad, self.params, self.stats = last, None, None, None

    def after_iter(self):
        t = self.trainer
        state = t.optimizer.optimizer.state
        with torch.no_grad():
            if t.step == 1:
                self.grad = {k: state[p]["exp_avg"] / (1 - ADAM_B1) for k, p in t.model.named_parameters()}
            if t.step == self.last:
                self.params = {k: p.detach().clone() for k, p in t.model.named_parameters()}
                self.stats = {k: b.clone() for k, b in t.model.named_buffers()
                              if k.endswith(("running_mean", "running_var"))}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def test_first_steps_follow_the_reference_from_the_transferred_state(tmp_path):
    """Three eager steps of ``build_trainer(seqs=True)`` (no warm-up: every
    step at the recipe's lr) against ``train_steps`` from the state that the
    upstream transfer rule gives, on the trainer's batches."""
    cfg = _config(tmp_path)
    lr, hr = _rows()
    stsr = _stsr_bundle(cfg)
    model = sr_task.build_model(cfg)
    start = {k: (stsr[k] if k.startswith(TRUNK) else v).clone() for k, v in model.state_dict().items()}
    trainer = sr_task.build_trainer(cfg, model, {"LR": lr, "HR": hr}, seqs=True, max_epochs=1)
    watch = _Watch(ROWS // BATCH)
    trainer.register_hooks([watch])
    trainer.train(auto_resume=False)
    losses = trainer.metric_storage["total_loss"].state_dict()["values"]

    ref = reference_model(cfg)
    ref.load_state_dict(start)
    order = np.random.default_rng(SEED).permutation(ROWS)  # the trainer's first draw
    batches = [torch.from_numpy(b) for b in np.split(order, ROWS // BATCH)]
    want_losses, want_grad = train_steps(ref, torch.from_numpy(lr), torch.from_numpy(hr), batches, cfg,
                                         [cfg["lr"]] * len(batches))

    # Both sides compute in f32 on the same weights and rows; they part only
    # by summation order (the port's labels are two resize matmuls, the
    # reference's F.interpolate; cuDNN-free CPU convs of one algorithm): a
    # few ulps, 1e-7 relative measured, so 1e-5.
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # The first gradient, decay term included, per leaf: the same rounding
    # through BN's backward, 1e-6 of a leaf's norm measured.  A conv bias
    # ahead of a train-mode BN has a true gradient of nought (BN removes any
    # per-channel constant), so its gradient is the decay term plus that
    # rounding: each leaf's gap is taken over the larger of its norm and the
    # median leaf's (as perfbench's ``leaf_gap``); 1e-4.
    assert set(watch.grad) == set(want_grad)
    norms = sorted(float(g.norm()) for g in want_grad.values())
    median = norms[len(norms) // 2]
    assert max(float((watch.grad[k] - g).norm()) / max(float(g.norm()), median)
               for k, g in want_grad.items()) < 1e-4
    # BN running statistics after the three steps: momentum sums of batch
    # moments of the same forward, 6e-6 measured; 1e-4.
    want_stats = {k: b for k, b in ref.named_buffers() if k in watch.stats}
    assert set(want_stats) == set(watch.stats)
    assert max(_rel(watch.stats[k] - start[k], b - start[k]) for k, b in want_stats.items()) < 1e-4
    # The parameters' change: Adam divides each gradient element by its own
    # size, so an element whose true gradient is rounding (the conv biases
    # ahead of a train-mode BN: BN removes any per-channel constant) steps by
    # ~lr with the rounding's sign.  Such leaves are held only to the
    # largest step Adam can take, 2 x lr x steps apart; every other leaf's
    # change within 1e-4 of its norm (1.1e-5 measured).
    params = dict(ref.named_parameters())
    for k, p in params.items():
        got, want = watch.params[k] - start[k], p.detach() - start[k]
        if k.startswith("patternFeatureExtra_layer.") and k.endswith(".0.bias"):
            assert float((got - want).abs().max()) <= 2 * cfg["lr"] * len(batches) * 1.01, k
        else:
            assert _rel(got, want) < 1e-4, k


@pytest.mark.parametrize("bundle", [True, False], ids=["bundle", "missing"])
def test_the_trunk_comes_from_the_stsr_bundle(tmp_path, bundle):
    """After ``build_trainer(seqs=True)`` every trunk tensor equals the STSR
    bundle's and every other tensor the MTSR's own; without the file the
    MTSR trains from scratch, with a warning."""
    cfg = _config(tmp_path)
    stsr = _stsr_bundle(cfg) if bundle else None
    model = sr_task.build_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.MonkeyPatch.context() as mp:
        warned = []
        mp.setattr(sr_task.logger, "warning", lambda msg, *a, **k: warned.append(msg % a))
        trainer = sr_task.build_trainer(cfg, model, dict(zip(("LR", "HR"), _rows())), seqs=True)
    got = trainer.model.state_dict()
    trunk = [k for k in got if k.startswith(TRUNK)]
    assert trunk and len(trunk) < len(got)
    for k, v in got.items():
        want = stsr[k] if bundle and k in trunk else before[k]
        assert torch.equal(v, want), k
    assert bool(warned) != bundle and all("training from scratch" in m for m in warned)


@pytest.mark.parametrize("seqs, opt_in, warm", [(True, False, False), (True, True, True), (False, False, True)],
                         ids=["seqs", "seqs_use_warmup", "stsr"])
def test_the_warm_up_is_off_for_the_seqs_recipe_unless_it_opts_in(tmp_path, seqs, opt_in, warm):
    cfg = _config(tmp_path, seqs_use_warmup=opt_in)
    if not seqs:
        cfg["seqsCnt"] = 1
    trainer = sr_task.build_trainer(cfg, sr_task.build_model(cfg), dict(zip(("LR", "HR"), _rows())), seqs=seqs)
    assert trainer.lr_schedule.warmup_t == (100 if warm else 0)
    assert trainer.epoch_len == ROWS // BATCH
    assert float(trainer.lr) == pytest.approx(cfg["warmup_init_lr"] if warm else cfg["lr"])


def _npz(path, lr, hr):
    np.savez(path, LR=lr, HR=hr)
    return str(path)


@pytest.mark.parametrize("seqs", [False, True], ids=["sr_task", "sr_seqs_task"])
def test_the_entries_train_through_build_trainer(tmp_path, seqs, monkeypatch):
    """``sr_task.main`` and ``sr_seqs_task`` build their trainer with
    ``build_trainer`` (``seqs`` passed on) and train it for the epoch."""
    lr, hr = _rows()
    if not seqs:
        lr = np.ascontiguousarray(lr[:, :3])
    data = [_npz(tmp_path / f"{s}.npz", lr[i:i + 8], hr[i:i + 8]) for s, i in (("train", 0), ("test", 4))]
    calls = []
    build = sr_task.build_trainer

    def spy(*a, **kw):
        calls.append(kw["seqs"])
        return build(*a, **kw)

    monkeypatch.setattr(sr_task, "build_trainer", spy)
    argv = ["--device", "cpu", "--train_dataset_dir", data[0], "--test_dataset_dir", data[1],
            "--save_dir", str(tmp_path / "w"), "--epochs", "1", "--scale_factor", "2",
            "--patternFeatureExtraLayerCnt", "1", "--train_batch_size", "4", "--test_batch_size", "4",
            "--compute_dtype", "float32", "--inference_test", "false"]
    if seqs:
        t = sr_seqs_task._cli(argv + ["--load_checkpoint_dir", str(tmp_path / "missing.pth")])
    else:
        t = sr_task._cli(argv)
    assert calls == [seqs] and t.step == 2 and t.model.seqs_cnt == (7 if seqs else 1)
    assert np.isfinite(t.metric_storage["test_loss"].latest)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("seqs", [1, 7])
def test_the_branch_counters_count_the_pattern_branch_convs(seqs, layout):
    """Two convs a pattern branch are counted in ``sr_branch_conv``; those
    whose input came channels-last in ``sr_branch_conv_nhwc``: none in NCHW,
    and channels-last each branch's second (the first takes the NCHW
    upsample's output)."""
    model = TactileSR(2, seqs, 3, 1, 1, generator=torch.Generator().manual_seed(3)).train()
    if layout == "channels_last":
        model = model.to(memory_format=torch.channels_last)
    x = 4 * torch.rand((2, 3 * seqs, 4, 4), generator=torch.Generator().manual_seed(1))
    before = dict(layers.layer_counts)
    model(x).sum().backward()
    gains = {k: n - before[k] for k, n in layers.layer_counts.items()}
    assert gains["sr_branch_conv"] == 2 * seqs
    assert gains["sr_branch_conv_nhwc"] == (seqs if layout == "channels_last" else 0)
    assert gains["sr_conv"] == 2 * seqs + 1 + 5 + 3 + 2  # contact, MSRB, force branch, head


# ------------------------------------------------------- the benchmark cell
CELL = "mtsr7-train-b32"
# toy widths and traffic, in f32: a sound run's gaps are f32 rounding
TOY = {"config": {"scale_factor": 2, "patternFeatureExtraLayerCnt": 1, "compute_dtype": "float32"},
       "traffic": {"batch": 4, "steps_per_epoch": 6, "traced_epochs": 1}}


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


def _no_transfer(monkeypatch):
    monkeypatch.setattr(sr_task, "transfer_trunk_params", lambda seqs_state, bundle: dict(seqs_state))


def _warm_up(monkeypatch):
    monkeypatch.setitem(sr_task.tactileSeqs_config, "seqs_use_warmup", True)


@pytest.mark.parametrize("fault", [None, _half_batch, _state_unchanged, _no_transfer, _warm_up],
                         ids=["sound", "half_batch", "state_unchanged", "no_transfer", "warm_up"])
def test_only_a_sound_run_of_the_cell_is_correct(fault, monkeypatch):
    if fault:
        fault(monkeypatch)
    line, out = core.run(CELL, SEED, 0.3, False, CPU, overrides=TOY)
    assert line["correct"] == (fault is None), line["checks"]
    assert out.attempted % 6 == 0 and out.attempted >= 6


def test_the_cells_control_and_half_batch_fail_its_limits():
    cell = core.make_cell(CELL, SEED + 1, 1, False, CPU, 0, TOY)
    readings = core.load_module("drivers", "seqs_train").control(cell)
    limits = cell.limits
    for kind in ("fp8", "half_batch"):
        assert any(v > limits[k] for k, v in readings[kind].items()), (kind, readings[kind])

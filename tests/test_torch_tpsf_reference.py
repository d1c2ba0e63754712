"""The port's tPSFNet against the benchmark's plain reference
(``perfbench/reference/tpsf.py``: float32, the published direct form) on
the CPU at B=4, on the benchmark's seeded weights and contact maps
(``perfbench/drivers/tpsf_train.py``): the forward (HR, LR, alpha, beta,
m), the loss's gradient for every MLP parameter, three eager steps of the
recipe's trainer as ``tpsf_task.build_trainer`` builds it, and the
reference's bf16-physics control, which must lie farther from the f32
reference than the port does."""

import math

import numpy as np
import pytest
import torch

from perfbench.drivers import tpsf_train as drv
from perfbench.reference import tpsf as ref
from tactilesr_torch.config import tPSFNet_config
from tactilesr_torch.ops.psf import physics_plain, physics_vjp_plain
from tactilesr_torch.runtime.trainer import masked_mse
from tactilesr_torch.tasks import tpsf_task

SEED = 2**31 + 41
B = 4


def _rel(a, b):
    return float((a.detach().double() - b.detach().double()).norm() / b.detach().double().norm())


def _inputs(seed=SEED, n=B):
    gen = torch.Generator().manual_seed(seed)
    readings = 4 * torch.rand((n, 3, 4, 4), generator=gen)
    return readings, drv.contact_maps(n, gen, "cpu")


def _recipe(tmp_path, **kw):
    return dict(tPSFNet_config, **{"compute_dtype": "float32", "device": "cpu", "random_seed": 0,
                                   "save_dir": str(tmp_path), **kw})


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_contact_maps_are_binary_and_partial():
    _, maps = _inputs(n=64)
    assert set(maps.unique().tolist()) == {0.0, 1.0}
    share = maps.mean(dim=(1, 2))
    assert (share > 0).all() and (share < 0.5).all()


def test_the_separable_physics_is_the_direct_form():
    """The port's plain physics (the kernels' reference, separable) against
    the reference's direct convolution and masks, at spread (alpha, beta,
    m), with the abm gradient under one LR cotangent.  Both in f32: the
    99x99 sums of the direct form and the banded products add in other
    orders, a few ulps of a 1e-7 relative rounding each; 1e-5 leaves room
    and is 100x under the bf16 control's gap (the last test)."""
    _, depth = _inputs()
    abm = 0.5 + torch.rand((B, 3), generator=torch.Generator().manual_seed(3)) * torch.tensor([2.0, 3.0, 2.0])
    g_lr = torch.randn((B, 4, 4), generator=torch.Generator().manual_seed(4))
    hr, lr = physics_plain(depth, abm)
    _, g = physics_vjp_plain(depth, abm, None, g_lr, need_depth=False)
    want_hr, want_lr, want_g = ref.physics_grad(depth, abm, g_lr)
    assert _rel(hr, want_hr) < 1e-5 and _rel(lr, want_lr) < 1e-5
    for c in range(3):  # alpha, beta, m: each column on its own scale
        assert _rel(g[:, c], want_g[:, c]) < 1e-5, c


def test_port_forward_and_mlp_gradients_match_the_reference(tmp_path):
    """The port's ``TPSFNet`` in f32 on the CPU (its plain physics) and the
    reference from one seeded state_dict: (alpha, beta, m), HR and LR to
    1e-5 (f32 rounding, as above), and the loss's gradient for every MLP
    weight and bias to 1e-5 as well: the backward's sums through the
    physics (the closed form against autograd of the direct form) and four
    layers add in other orders, each to a few 1e-7 relative."""
    state = drv.seeded_state_dict(SEED, "cpu")
    readings, depth = _inputs()
    x = readings / tPSFNet_config["scale_num"]
    port = tpsf_task.build_model(_recipe(tmp_path))
    port.load_state_dict(state)
    hr, lr, _psf, abm = port(x, depth[:, None], return_psf=False)
    want = ref.build()
    want.load_state_dict(state)
    want_hr, want_lr, want_abm = want(x, depth)
    assert _rel(abm[:, 0], want_abm) < 1e-6
    assert _rel(hr[:, 0], want_hr) < 1e-5 and _rel(lr[:, 0], want_lr) < 1e-5
    grads = torch.autograd.grad(masked_mse(x[:, 2:3], lr, torch.ones(B)), list(port.parameters()))
    want_grads = torch.autograd.grad(ref.loss(want_lr, x), list(want.parameters()))
    names = [k for k, _ in port.named_parameters()]
    assert names == [k for k, _ in want.named_parameters()]
    for k, g, w in zip(names, grads, want_grads):
        assert w.norm() > 0 and _rel(g, w) < 1e-5, k


def test_three_build_trainer_steps_match_the_reference(tmp_path):
    """Three eager steps of ``build_trainer``'s trainer (B=4, 12 rows, one
    epoch) against the reference's Adam with coupled L2 from the same state,
    on the same batches at the recipe's rate: the losses to 1e-5 (f32
    rounding, as above), and each parameter's change to 1e-4 of its norm.
    Adam divides each gradient by its own RMS, so an element whose gradient
    is near rounding moves by about lr either way: the change is held by
    its norm over every element, not element by element."""
    state = drv.seeded_state_dict(SEED, "cpu")
    rows, _ = _inputs(n=3 * B)
    _, maps = _inputs(SEED + 1, n=3)
    per = B  # each map the depth of 4 rows
    trainer = tpsf_task.build_trainer(
        _recipe(tmp_path, train_batch_size=B, epochs=1, random_seed=SEED),
        _loaded(tpsf_task.build_model(_recipe(tmp_path)), state),
        {"LR": rows.numpy(), "depth": maps.repeat_interleave(per, 0).numpy()})
    trainer.train(auto_resume=False)
    losses = trainer.metric_storage["total_loss"].state_dict()["values"]
    assert trainer.step == 3 and len(losses) == 3
    model = ref.build()
    model.load_state_dict(state)
    batches = [torch.from_numpy(b) for b in drv.first_batches(SEED, 3 * B, B, 3)]
    want, _ = ref.train_steps(model, rows, lambda idx: maps[idx // per], batches,
                              [tPSFNet_config["lr"]] * 3, tPSFNet_config["weight_decay"],
                              tPSFNet_config["scale_num"])
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for (k, p), (_, w) in zip(trainer.model.named_parameters(), model.named_parameters()):
        change, want_change = p.detach() - state[k], w.detach() - state[k]
        assert want_change.norm() > 0 and _rel(change, want_change) < 1e-4, k


def _loaded(model, state):
    model.load_state_dict(state)
    return model


def test_the_bf16_control_is_farther_than_the_port():
    """The reference's physics with its four products in one bf16 pass (the
    control of the cell's ``hr_gap`` and ``lr_gap``) lies at least 100x
    farther from the f32 reference than the port's f32 physics does, and
    above 1e-4 (bf16 keeps 8 bits: a product's operand moves by up to
    2^-9)."""
    _, depth = _inputs()
    abm = torch.full((B, 3), math.log(2.0))  # softplus(0): the seeded init's output
    want_hr, want_lr = ref.physics(depth, abm)
    hr, lr = physics_plain(depth, abm)
    ctl_hr, ctl_lr = ref.physics_bf16(depth, abm)
    for port, ctl, want in ((hr, ctl_hr, want_hr), (lr, ctl_lr, want_lr)):
        assert _rel(ctl, want) > max(1e-4, 100 * _rel(port, want))

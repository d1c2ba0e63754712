"""The optimizer kernel's CPU side (``tactilesr_torch/ops/cuda/adam.py``):
its plain version against ``torch.optim.Adam``, the grid's work list over
the recipes' parameter sets, the wrapper's checks, ``AdamL2`` on the CPU,
and the state between the kernel's form and torch's.  Imports no JAX.

Tolerance of the plain version against torch's host-side Adam: the two
compute the bias corrections in another order (torch's capturable form in
f32 against torch's host form in double), so parameters part by a few f32
roundings of a step (seen: 7e-7 on parameters of size ~3 after 20 steps).
"""

import io

import numpy as np
import pytest
import torch

from tactilesr_torch.config import tactileSR_config, tPSFNet_config
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.cuda import adam
from tactilesr_torch.runtime import optim
from tactilesr_torch.runtime.optim import AdamL2
from tactilesr_torch.tasks import sr_task, tpsf_task

SHAPES = [(8, 3, 3, 3), (8,), (5, 7), (1,), (16, 4, 1, 1), (3000,)]
LRS = [1e-3 * (1 + 0.1 * k) for k in range(20)]
WD = 1e-2


def _params(seed=0):
    """Parameters of SHAPES, the 4-D ones channels-last."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for shape in SHAPES:
        p = torch.randn(shape, generator=gen)
        if p.ndim == 4:
            p = p.contiguous(memory_format=torch.channels_last)
        out.append(torch.nn.Parameter(p))
    return out


def _grads(params, k):
    gen = torch.Generator().manual_seed(1000 + k)
    return [torch.randn(p.shape, generator=gen).contiguous(
        memory_format=torch.channels_last if p.ndim == 4 else torch.contiguous_format) for p in params]


def _kernel_form(opt: AdamL2, monkeypatch):
    """``opt`` stepping as ``make_capturable`` leaves it, on the CPU: the
    learning rate a tensor, each step through ``adam_l2_update``, here the
    plain version of the kernel's arithmetic (the kernel takes CUDA tensors
    only)."""
    monkeypatch.setattr(optim, "adam_l2_update",
                        lambda *a, ticket=None, **k: adam.adam_l2_plain(*a, **k))
    for group in opt.optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32)
    opt.capturable = True
    return opt


def _step(opt, params, k):
    for p, g in zip(params, _grads(params, k)):
        p.grad = g
    opt.step(LRS[k])


def test_plain_version_matches_torch_adam_over_20_steps():
    """Weight decay, a learning rate that changes each step, channels-last
    4-D and 1-D parameters: the plain version's parameters, moments and
    step counts against torch.optim.Adam's."""
    ours, ref = _params(), _params()
    torch_opt = torch.optim.Adam(ref, lr=0.0, weight_decay=WD)
    m = [torch.zeros_like(p) for p in ours]
    v = [torch.zeros_like(p) for p in ours]
    steps = [torch.zeros(()) for _ in ours]
    for k in range(20):
        grads = _grads(ours, k)
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        torch_opt.param_groups[0]["lr"] = LRS[k]
        torch_opt.step()
        with torch.no_grad():
            adam.adam_l2_plain([p.data for p in ours], grads, m, v, steps, torch.tensor(LRS[k]),
                               b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    for i, (p, q) in enumerate(zip(ours, ref)):
        st = torch_opt.state[q]
        torch.testing.assert_close(p.data, q.data, rtol=1e-6, atol=1e-6, msg=f"param {i}")
        torch.testing.assert_close(m[i], st["exp_avg"], rtol=1e-5, atol=1e-7, msg=f"exp_avg {i}")
        torch.testing.assert_close(v[i], st["exp_avg_sq"], rtol=1e-5, atol=1e-9, msg=f"exp_avg_sq {i}")
        assert float(steps[i]) == float(st["step"]) == 20
        assert p.stride() == q.stride() and m[i].stride() == p.stride()


def _recipe_params(name):
    if name == "tpsfnet":
        model = tpsf_task.build_model(tPSFNet_config)
    else:
        model = sr_task.build_model(dict(tactileSR_config, seqsCnt=7 if name == "mtsr7" else 1))
    return [p for p in model.parameters() if p.requires_grad]


@pytest.mark.parametrize("name,tensors,elements", [
    ("stsr", 124, 4_583_552), ("mtsr7", 160, 5_037_824), ("tpsfnet", 8, 538_883)])
def test_work_list_covers_every_element_once(name, tensors, elements):
    """The recipes' parameter sets at their published widths: the grid's
    chunks cover each element of each tensor exactly once, each chunk at
    most ``ADAM_CHUNK`` long and starting on a 16-byte boundary."""
    numels = [p.numel() for p in _recipe_params(name)]
    assert (len(numels), sum(numels)) == (tensors, elements)
    items = adam.work_list(numels)
    assert len(items) == adam.chunk_starts(numels)[-1]
    cover = [np.zeros(n, np.int32) for n in numels]
    for i, off, length in items:
        assert 0 < length <= adam.ADAM_CHUNK and off % 4 == 0
        cover[i][off:off + length] += 1
    assert all((c == 1).all() for c in cover)


def test_work_list_skips_empty_tensors():
    numels = [0, 5000, 0, 0, 2048, 3, 0]
    assert adam.chunk_starts(numels) == [0, 0, 3, 3, 3, 4, 5, 5]
    assert adam.work_list(numels) == [(1, 0, 2048), (1, 2048, 2048), (1, 4096, 904), (4, 0, 2048),
                                      (5, 0, 3)]


def _update_args():
    p = torch.randn(5, 7)
    return dict(params=[p], grads=[torch.randn(5, 7)], exp_avgs=[torch.zeros(5, 7)],
                exp_avg_sqs=[torch.zeros(5, 7)], steps=[torch.zeros(())], lr=torch.tensor(1e-3))


@pytest.mark.parametrize("fault", [
    "grad_transposed", "exp_avg_sq_channels_last", "param_strided", "grad_bf16", "exp_avg_f64",
    "lr_f64", "step_two_values", "lengths"])
def test_wrapper_raises_on_layout_dtype_and_length(fault):
    """The kernel walks storage: a gradient or moment in another layout
    than its parameter's, a parameter that is not dense, a tensor not f32,
    or lists of other lengths raise (before the device is looked at), and
    nothing is stepped."""
    args = _update_args()
    if fault == "grad_transposed":
        args["grads"] = [torch.randn(7, 5).t()]
    elif fault == "exp_avg_sq_channels_last":
        p = torch.randn(2, 3, 4, 4)
        args.update(params=[p], grads=[torch.randn_like(p)], exp_avgs=[torch.zeros_like(p)],
                    exp_avg_sqs=[torch.zeros_like(p).contiguous(memory_format=torch.channels_last)])
    elif fault == "param_strided":
        p = torch.randn(10, 7)[::2]
        args.update(params=[p], exp_avgs=[torch.zeros(5, 7)[::1]])
    elif fault == "grad_bf16":
        args["grads"] = [args["grads"][0].bfloat16()]
    elif fault == "exp_avg_f64":
        args["exp_avgs"] = [args["exp_avgs"][0].double()]
    elif fault == "lr_f64":
        args["lr"] = torch.tensor(1e-3, dtype=torch.float64)
    elif fault == "step_two_values":
        args["steps"] = [torch.zeros(2)]
    elif fault == "lengths":
        args["steps"] = []
    before = args["params"][0].clone()
    with pytest.raises(ValueError) as err:
        adam.adam_l2_update(**args, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    assert "CUDA tensors" not in str(err.value)
    assert torch.equal(args["params"][0], before)


def test_wrapper_takes_channels_last_and_size_one_dims():
    """Dense tensors of one layout pass the checks, whatever their order of
    storage: channels-last weights, and a 1x1 kernel whose size-1 dims
    carry strides of either layout.  On the CPU the call then refuses the
    device (the kernel takes CUDA tensors only), having stepped nothing."""
    p = torch.randn(16, 4, 1, 1).contiguous(memory_format=torch.channels_last)
    q = torch.randn(8, 3, 3, 3).contiguous(memory_format=torch.channels_last)
    params = [p, q]
    before = [x.clone() for x in params]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        adam.adam_l2_update(params, [torch.randn(16, 4, 1, 1), torch.randn_like(q)],
                            [torch.zeros_like(x) for x in params], [torch.zeros_like(x) for x in params],
                            [torch.zeros(()) for _ in params], torch.tensor(1e-3), b1=0.9, b2=0.999,
                            eps=1e-8, weight_decay=WD)
    assert all(torch.equal(a, b) for a, b in zip(params, before))


def test_wrapper_raises_on_more_tensors_than_one_launch_takes():
    """One launch takes ``ADAM_MAX_TENSORS`` tensors (the recipes have 8 to
    160); one more raises before anything is looked at or stepped."""
    n = adam.ADAM_MAX_TENSORS + 1
    params = [torch.zeros(3) for _ in range(n)]
    with pytest.raises(ValueError, match=f"at most {adam.ADAM_MAX_TENSORS}"):
        adam.adam_l2_update(params, [torch.ones(3) for _ in range(n)],
                            [torch.zeros(3) for _ in range(n)], [torch.zeros(3) for _ in range(n)],
                            [torch.zeros(()) for _ in range(n)], torch.tensor(1e-3), b1=0.9,
                            b2=0.999, eps=1e-8, weight_decay=WD)
    assert all(float(p.abs().sum()) == 0 for p in params)


def test_adam_l2_on_the_cpu_steps_through_torch_adam(monkeypatch):
    """On the CPU ``AdamL2`` keeps torch.optim.Adam (host-side, float
    learning rate): the optimizer kernel's path is never called, nothing
    counts as a kernel launch, and the learning rate stays a float."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path called adam_l2_update")

    monkeypatch.setattr(optim, "adam_l2_update", refuse)
    calls = []
    real = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    params = _params()
    opt = optim.adam_l2(params, weight_decay=WD)
    before = dict(tcuda.launch_counts)
    for k in range(3):
        _step(opt, params, k)
    assert len(calls) == 3 and not opt.capturable
    assert isinstance(opt.optimizer.param_groups[0]["lr"], float)
    assert tcuda.launch_counts == before
    with pytest.raises(ValueError):
        opt.make_capturable()


def _roundtrip(sd):
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=False)


@pytest.mark.parametrize("first,second", [("torch", "kernel"), ("kernel", "torch")])
def test_state_dict_round_trip_between_the_kernel_form_and_torchs(first, second, monkeypatch):
    """Five steps in one form, its ``state_dict`` through ``torch.save``
    into a new optimizer of the other form, five more steps there: the
    same parameters as five more steps in the first form (within the two
    forms' rounding), step counts 10, the saved state in the plain form
    (float learning rate, not capturable).  A state written before the
    kernel existed is the torch form's."""
    params, again = _params(), _params()
    opt = optim.adam_l2(params, weight_decay=WD)
    if first == "kernel":
        _kernel_form(opt, monkeypatch)
    for k in range(5):
        _step(opt, params, k)
    sd = _roundtrip(opt.state_dict())
    assert all(g["capturable"] is False and isinstance(g["lr"], float) for g in sd["param_groups"])
    assert sorted(sd["state"][0]) == ["exp_avg", "exp_avg_sq", "step"]
    with torch.no_grad():
        for p, q in zip(again, params):
            p.copy_(q)
    other = optim.adam_l2(again, weight_decay=WD)
    other.load_state_dict(sd)
    if second == "kernel":
        _kernel_form(other, monkeypatch)
    for k in range(5, 10):
        _step(opt, params, k)
        _step(other, again, k)
    for i, (p, q) in enumerate(zip(again, params)):
        torch.testing.assert_close(p.data, q.data, rtol=1e-6, atol=1e-6, msg=f"param {i}")
        assert p.stride() == q.stride()
        assert float(other.optimizer.state[p]["step"]) == float(opt.optimizer.state[q]["step"]) == 10


def test_kernel_form_creates_state_as_torch_does(monkeypatch):
    """The kernel form's first step creates torch's capturable state: a
    0-dim f32 step and zero moments in each parameter's layout; a parameter
    without a gradient is skipped and gets none."""
    params = _params()
    opt = _kernel_form(optim.adam_l2(params, weight_decay=WD), monkeypatch)
    for p, g in zip(params[1:], _grads(params, 0)[1:]):
        p.grad = g
    opt.step(LRS[0])
    assert not opt.optimizer.state[params[0]]
    for p in params[1:]:
        st = opt.optimizer.state[p]
        assert st["step"].shape == () and st["step"].dtype == torch.float32 and float(st["step"]) == 1
        assert st["exp_avg"].stride() == p.stride() and st["exp_avg_sq"].stride() == p.stride()

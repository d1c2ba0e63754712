"""The optimizer kernel (``ops/cuda/adam_kernel.cu``) on the GPU, against its
plain version and against torch's capturable foreach Adam, which it
replaces in the captured step: the full-width STSR's 124 parameters
channels-last, stepped eagerly and as replays of a ``CapturedGraph``; one
``adam_l2`` launch per replay; step counters; state whose
``exp_avg_sq`` is almost all denormal; misaligned views, and as many tensors
as one launch takes.  Every test needs an NVIDIA GPU
(and nvcc) and skips without one.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda_adam.py -q

Tolerances: the kernel computes torch's capturable Adam's operations in its
order, each sqrt and divide correctly rounded, so against torch it may
part only where a multiply and an add are fused differently: within 2
ulps on every element after 6 steps.  Against the plain version (torch's
per-tensor ops, whose ``addcmul`` multiplies in another order) within
f32 rounding of a step: parameters atol 1e-6, moments rtol 1e-5.
"""

import pytest
import torch

from tactilesr_torch.config import tactileSR_config
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.cuda import adam
from tactilesr_torch.ops.graph import CapturedGraph
from tactilesr_torch.runtime.optim import adam_l2
from tactilesr_torch.tasks import sr_task

pytestmark = pytest.mark.gpu

STEPS = 6
B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the optimizer kernel runs only on one)")
    return torch.device("cuda")


def _stsr_params(dev):
    """The full-width STSR's trainable parameters on the card, the 4-D ones
    channels-last, as the trainer lays them out."""
    model = sr_task.build_model(dict(tactileSR_config))
    out = []
    for p in model.parameters():
        if p.requires_grad:
            x = p.detach().to(dev)
            if x.ndim == 4:
                x = x.contiguous(memory_format=torch.channels_last)
            out.append(torch.nn.Parameter(x))
    return out


def _copies(params):
    return [torch.nn.Parameter(p.detach().clone(memory_format=torch.preserve_format)) for p in params]


def _grads(params, k):
    gen = torch.Generator(device=params[0].device).manual_seed(77 + k)
    return [torch.randn(p.shape, generator=gen, device=p.device).contiguous(
        memory_format=torch.channels_last if p.ndim == 4 else torch.contiguous_format) for p in params]


def _lr(k):
    return 3e-4 * (1 + 0.25 * k)


def _ulps(a, b):
    """Largest distance in f32 units in the last place between a and b."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g.clone(memory_format=torch.preserve_format)
        else:
            p.grad.copy_(g)


@pytest.mark.parametrize("mode", ["eager", "captured"])
def test_kernel_matches_torch_capturable_adam_and_the_plain_version(dev, mode):
    """Six steps of the STSR's parameters at a learning rate that changes
    each step: ``AdamL2`` made capturable (the kernel), torch's capturable
    foreach Adam and the plain version from the same start.  Captured: the
    first step eager (it creates the state), the second captured in a
    ``CapturedGraph`` and run by its replays with the next gradients and
    rates copied in, one ``adam_l2`` launch per replay."""
    ours = _stsr_params(dev)
    ref, plain = _copies(ours), _copies(ours)
    assert len(ours) == 124
    opt = adam_l2(ours, weight_decay=WD)
    opt.make_capturable()
    torch_opt = torch.optim.Adam(ref, lr=torch.tensor(0.0, device=dev), betas=(B1, B2), eps=EPS,
                                 weight_decay=WD, capturable=True, foreach=True)
    m = [torch.zeros_like(p) for p in plain]
    v = [torch.zeros_like(p) for p in plain]
    steps = [torch.zeros((), device=dev) for _ in plain]
    lr_dev = torch.tensor(0.0, device=dev)
    before = tcuda.launch_counts["adam_l2"]
    graph = None
    for k in range(STEPS):
        grads = _grads(ours, k)
        _set_grads(ours, grads)
        lr_dev.fill_(_lr(k))
        if mode == "eager" or k == 0:
            opt.step(lr_dev)
        else:
            if graph is None:
                graph = CapturedGraph()
                torch.cuda.synchronize()
                with graph.capture():
                    opt.step(lr_dev)
            graph.replay()
        for p, g in zip(ref, grads):
            p.grad = g.clone(memory_format=torch.preserve_format)
        torch_opt.param_groups[0]["lr"].fill_(_lr(k))
        torch_opt.step()
        adam.adam_l2_plain([p.data for p in plain], grads, m, v, steps, lr_dev, b1=B1, b2=B2,
                           eps=EPS, weight_decay=WD)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["adam_l2"] - before == STEPS
    if mode == "captured":
        assert graph.per_replay["adam_l2"] == 1
    worst = {"param": 0, "exp_avg": 0, "exp_avg_sq": 0}
    for i, (p, q, pp) in enumerate(zip(ours, ref, plain)):
        st, ts = opt.optimizer.state[p], torch_opt.state[q]
        assert float(st["step"]) == float(ts["step"]) == float(steps[i]) == STEPS
        assert st["exp_avg"].stride() == p.stride()
        for name, a, b in (("param", p.data, q.data), ("exp_avg", st["exp_avg"], ts["exp_avg"]),
                           ("exp_avg_sq", st["exp_avg_sq"], ts["exp_avg_sq"])):
            worst[name] = max(worst[name], _ulps(a, b))
        torch.testing.assert_close(p.data, pp.data, rtol=0, atol=1e-6, msg=f"param {i} vs plain")
        torch.testing.assert_close(st["exp_avg"], m[i], rtol=1e-5, atol=1e-12, msg=f"exp_avg {i}")
        torch.testing.assert_close(st["exp_avg_sq"], v[i], rtol=1e-5, atol=1e-20,
                                   msg=f"exp_avg_sq {i}")
    print(f"[adam {mode}] kernel vs torch capturable foreach Adam, ulps: {worst}")
    assert max(worst.values()) <= 2, worst


def test_denormal_state_steps_as_torch_does(dev):
    """``exp_avg_sq`` 99% denormal, ``exp_avg`` and the gradients denormal,
    ``eps`` 0 and parameters of ~1e-27, so that each element's update
    shows the sqrt of a denormal and the divide of a denormal: the
    kernel's f64 sqrt and divide give torch's IEEE f32 results (within 2
    ulps), and flush nothing to zero; the step counters advance once."""
    gen = torch.Generator(device=dev).manual_seed(5)
    sizes = (4099, 70000, 5)
    params = [torch.nn.Parameter(torch.randn(n, generator=gen, device=dev) * 1e-27) for n in sizes]
    ref = _copies(params)
    opt = adam_l2(params, weight_decay=0.0, eps=0.0)
    opt.make_capturable()
    torch_opt = torch.optim.Adam(ref, lr=torch.tensor(1e-4, device=dev), eps=0.0, weight_decay=0.0,
                                 capturable=True, foreach=True)
    for p, q in zip(params, ref):
        v = (torch.rand(p.shape, generator=gen, device=dev) + 0.01) * 1e-39
        v[::100] = 1e-6  # 1% normal
        state = {"step": torch.full((), 40.0, device=dev),
                 "exp_avg": (torch.rand(p.shape, generator=gen, device=dev) - 0.5) * 1e-41,
                 "exp_avg_sq": v}
        opt.optimizer.state[p] = {k: x.clone() for k, x in state.items()}
        torch_opt.state[q] = {k: x.clone() for k, x in state.items()}
        g = torch.randn(p.shape, generator=gen, device=dev) * 1e-42
        p.grad, q.grad = g.clone(), g.clone()
    denormal = sum(int((s["exp_avg_sq"] < 1.1754944e-38).sum()) for s in opt.optimizer.state.values())
    assert denormal / sum(sizes) > 0.98, denormal
    opt.step(1e-4)
    torch_opt.step()
    torch.cuda.synchronize()
    worst = 0
    for p, q in zip(params, ref):
        st, ts = opt.optimizer.state[p], torch_opt.state[q]
        assert float(st["step"]) == float(ts["step"]) == 41
        assert (st["exp_avg_sq"] > 0).all()  # nothing flushed to zero
        for a, b in ((p.data, q.data), (st["exp_avg"], ts["exp_avg"]), (st["exp_avg_sq"], ts["exp_avg_sq"])):
            worst = max(worst, _ulps(a, b))
    print(f"[adam denormal] kernel vs torch capturable foreach Adam: {worst} ulps")
    assert worst <= 2


def test_misaligned_and_ragged_tensors(dev):
    """Tensors whose pointers are not 16-byte aligned (views at an odd
    offset) take the kernel's scalar path, and sizes that are not a
    multiple of 4 or of a chunk its tail: the same result as aligned
    copies, against the plain version."""
    base = torch.randn(3 * 4099 + 1, device=dev)
    views = [base[1 + k * 4099:1 + (k + 1) * 4099] for k in range(3)]
    assert views[0].data_ptr() % 16 and views[1].data_ptr() % 16 == 0
    grads = [torch.randn(4099, device=dev) for _ in range(3)]
    m = [torch.zeros(4099, device=dev) for _ in range(3)]
    v = [torch.zeros(4099, device=dev) for _ in range(3)]
    steps = [torch.zeros((), device=dev) for _ in range(3)]
    copies = [x.clone() for x in views]
    m2, v2, s2 = [x.clone() for x in m], [x.clone() for x in v], [x.clone() for x in steps]
    lr = torch.tensor(1e-3, device=dev)
    for _ in range(3):
        adam.adam_l2_update(views, grads, m, v, steps, lr, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
        adam.adam_l2_plain(copies, grads, m2, v2, s2, lr, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    torch.cuda.synchronize()
    for a, b in zip(views, copies):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert [float(s) for s in steps] == [3.0] * 3


def test_more_tensors_than_one_launch_takes(dev):
    """``ADAM_MAX_TENSORS`` (512) tensors of 0 to 300 elements, empty ones
    included, take one launch: the plain version's result, every step
    counter advanced once.  One tensor more raises, launches nothing and
    steps nothing."""
    n = adam.ADAM_MAX_TENSORS
    gen = torch.Generator(device=dev).manual_seed(9)
    sizes = torch.randint(0, 301, (n,), generator=gen, device=dev).tolist()
    params = [torch.randn(k, generator=gen, device=dev) for k in sizes]
    grads = [torch.randn(k, generator=gen, device=dev) for k in sizes]
    copies = [p.clone() for p in params]
    m, v = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    m2, v2 = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    steps, steps2 = [torch.zeros((), device=dev) for _ in sizes], [torch.zeros((), device=dev) for _ in sizes]
    lr = torch.tensor(1e-3, device=dev)
    before = tcuda.launch_counts["adam_l2"]
    adam.adam_l2_update(params, grads, m, v, steps, lr, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    adam.adam_l2_plain(copies, grads, m2, v2, steps2, lr, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["adam_l2"] - before == 1
    assert all(float(s) == 1.0 for s in steps)
    for a, b in zip(params, copies):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    extra = torch.zeros(3, device=dev)
    snapshot = [p.clone() for p in params]
    with pytest.raises(ValueError, match=f"at most {n}"):
        adam.adam_l2_update(params + [extra], grads + [torch.ones(3, device=dev)],
                            m + [torch.zeros(3, device=dev)], v + [torch.zeros(3, device=dev)],
                            steps + [torch.zeros((), device=dev)], lr, b1=B1, b2=B2, eps=EPS,
                            weight_decay=WD)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["adam_l2"] - before == 1
    assert all(torch.equal(a, b) for a, b in zip(params, snapshot)) and float(extra.abs().sum()) == 0

"""The tPSF physics CUDA kernels (forward and backward), and their autograd
wrapper, against the plain PyTorch versions, on the GPU.  Every test here needs an NVIDIA GPU and nvcc
and skips without them.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py -q

Tolerances are the JAX kernel tests': HR rtol/atol 1e-4, LR rtol 1e-4 /
atol 1e-6, gradients rtol 1e-3 / atol 1e-6; the plain version runs with
TF32 off (f32 FMA, as the kernel).  The bf16 kernels (``precision``
default and high) are held against the plain version of their precision
at 1e-3 of the largest |HR| and |LR| (``BF16_REL``): both round T = A D to
bf16 as the next product's operand after f32 sums taken in different
orders, so an element on a rounding boundary can round to neighbouring
bf16 values.
"""

import numpy as np
import pytest
import torch

from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.psf import f32_matmul, physics_plain, physics_vjp_plain

pytestmark = pytest.mark.gpu

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_REL = 1e-3
BF16_KERNELS = {"default": "tpsf_physics_bf16", "high": "tpsf_physics_bf16x3"}
BF16_BLOCKS = 3  # resident blocks per SM both bf16 kernels are built for


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, dev, seed=0):
    """Rectangular contact maps, noise on every other one, the last map
    all-zero; abm = 0.5 + |N(0, 1)|."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((b, 100, 100), np.float32)
    for k in range(b):
        r0, c0 = rng.integers(10, 45, 2)
        r1, c1 = rng.integers(55, 95, 2)
        depth[k, r0:r1, c0:c1] = 1.0
    depth[::2] += 0.05 * rng.standard_normal(depth[::2].shape).astype(np.float32)
    depth[-1] = 0.0
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    return torch.from_numpy(depth).to(dev), torch.from_numpy(abm).to(dev)


def _plain(depth, abm):
    with f32_matmul():
        return physics_plain(depth, abm)


@pytest.mark.parametrize("b", [1, 5, 256])
def test_kernel_matches_plain(dev, b):
    depth, abm = _inputs(b, dev, seed=b)
    hr_p, lr_p = _plain(depth, abm)
    before = tcuda.launch_counts["tpsf_physics"]
    hr_k, lr_k = tcuda.tpsf_physics(depth, abm)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["tpsf_physics"] == before + 1
    torch.testing.assert_close(hr_k, hr_p, **HR_TOL)
    torch.testing.assert_close(lr_k, lr_p, **LR_TOL)
    assert torch.all(hr_k[-1] == 0) and torch.all(lr_k[-1] == 0)


def test_misaligned_and_strided_inputs(dev):
    depth, abm = _inputs(5, dev)
    hr, lr = tcuda.tpsf_physics(depth, abm)
    shifted = torch.empty(5 * 10000 + 1, device=dev)[1:].view(5, 100, 100)
    shifted.copy_(depth)
    hr_s, lr_s = tcuda.tpsf_physics(shifted, abm)
    hr_t, lr_t = tcuda.tpsf_physics(depth.transpose(1, 2).contiguous().transpose(1, 2), abm)
    assert torch.equal(hr_s, hr) and torch.equal(lr_s, lr)
    assert torch.equal(hr_t, hr) and torch.equal(lr_t, lr)


def test_empty_batch_launches_nothing(dev):
    before = tcuda.launch_counts["tpsf_physics"]
    hr, lr = tcuda.tpsf_physics(torch.zeros(0, 100, 100, device=dev), torch.ones(0, 3, device=dev))
    assert hr.shape == (0, 100, 100) and lr.shape == (0, 4, 4)
    assert tcuda.launch_counts["tpsf_physics"] == before


@pytest.mark.parametrize("b", [5, 256])
def test_fused_gradients_match_plain(dev, b):
    """Kernel forward + kernel backward against autograd through the
    plain physics, for depth and abm.  The loss reads the forward's LR, so
    the kernel's output feeds the cotangent; TF32 is allowed globally
    during the wrapper's run and must not reach its backward."""
    depth, abm = _inputs(b, dev, seed=b)
    g = torch.Generator().manual_seed(b)
    w_hr = torch.randn(b, 100, 100, generator=g).to(dev)
    target = torch.randn(b, 4, 4, generator=g).to(dev) * 1e-3

    def loss(hr, lr):
        return 0.5 * ((lr - target) ** 2).sum() + 1e-6 * (w_hr * hr).sum()

    d_k, a_k = depth.clone().requires_grad_(True), abm.clone().requires_grad_(True)
    before = dict(tcuda.launch_counts)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss(*tcuda.tpsf_physics_fused(d_k, a_k)).backward()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    assert tcuda.launch_counts["tpsf_physics_fused"] == before["tpsf_physics_fused"] + 1
    assert tcuda.launch_counts["tpsf_physics"] == before["tpsf_physics"] + 1

    d_p, a_p = depth.clone().requires_grad_(True), abm.clone().requires_grad_(True)
    with f32_matmul():
        loss(*physics_plain(d_p, a_p)).backward()
    torch.testing.assert_close(a_k.grad, a_p.grad, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(d_k.grad, d_p.grad, rtol=1e-3, atol=1e-6)


def _cotangents(b, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (1e-4 * torch.randn(b, 100, 100, generator=g)).to(dev), torch.randn(b, 4, 4, generator=g).to(dev)


def _autograd_plain(depth, abm, g_hr, g_lr, need_depth):
    d = depth.clone().requires_grad_(need_depth)
    a = abm.clone().requires_grad_(True)
    with f32_matmul():
        hr, lr = physics_plain(d, a)
        outs = [(o, g) for o, g in ((hr, g_hr), (lr, g_lr)) if g is not None]
        wanted = [d, a] if need_depth else [a]
        grads = torch.autograd.grad([o for o, _ in outs], wanted, [g for _, g in outs])
    return (grads[0] if need_depth else None), grads[-1]


@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("with_hr", [False, True], ids=["lr_only", "lr_and_hr"])
@pytest.mark.parametrize("need_depth", [False, True], ids=["abm_only", "depth_and_abm"])
def test_backward_kernel_matches_plain(dev, b, with_hr, need_depth):
    """The backward kernel against physics_vjp_plain and against autograd
    through the plain physics (TF32 off), at GRAD_TOL."""
    # at B=1 the last (all-zero) map would be the only one: take a contact map
    depth, abm = _inputs(b + 1, dev, seed=b) if b == 1 else _inputs(b, dev, seed=b)
    depth, abm = depth[:b], abm[:b]
    g_hr, g_lr = _cotangents(b, dev, seed=b + 1)
    g_hr = g_hr if with_hr else None
    before = tcuda.launch_counts["tpsf_physics_bwd"]
    gd_k, ga_k = tcuda.tpsf_physics_bwd(depth, abm, g_hr, g_lr, need_depth=need_depth)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["tpsf_physics_bwd"] == before + 1
    with f32_matmul():
        gd_p, ga_p = physics_vjp_plain(depth, abm, g_hr, g_lr, need_depth, True)
    gd_a, ga_a = _autograd_plain(depth, abm, g_hr, g_lr, need_depth)
    for want in (ga_p, ga_a):
        torch.testing.assert_close(ga_k, want, rtol=1e-3, atol=1e-6)
    assert b == 1 or torch.all(ga_k[-1] == 0)  # the all-zero map is all contact
    assert torch.all(ga_k[0] != 0)
    if need_depth:
        for want in (gd_p, gd_a):
            torch.testing.assert_close(gd_k, want, rtol=1e-3, atol=1e-6)
    else:
        assert gd_k is None


def test_backward_counts_one_launch_per_backward(dev):
    depth, abm = _inputs(5, dev)
    a = abm.clone().requires_grad_(True)
    before = dict(tcuda.launch_counts)
    for _ in range(3):
        hr, lr = tcuda.tpsf_physics_fused(depth, a)
        (lr ** 2).sum().backward()
    torch.cuda.synchronize()
    assert tcuda.launch_counts["tpsf_physics_bwd"] == before["tpsf_physics_bwd"] + 3
    assert tcuda.launch_counts["tpsf_physics_fused"] == before["tpsf_physics_fused"] + 3


def test_backward_empty_batch_launches_nothing(dev):
    before = tcuda.launch_counts["tpsf_physics_bwd"]
    gd, ga = tcuda.tpsf_physics_bwd(torch.zeros(0, 100, 100, device=dev), torch.ones(0, 3, device=dev),
                                    None, torch.zeros(0, 4, 4, device=dev))
    assert gd.shape == (0, 100, 100) and ga.shape == (0, 3)
    a = torch.ones(0, 3, device=dev, requires_grad=True)
    hr, lr = tcuda.tpsf_physics_fused(torch.zeros(0, 100, 100, device=dev), a)
    lr.sum().backward()
    assert a.grad.shape == (0, 3)
    assert tcuda.launch_counts["tpsf_physics_bwd"] == before


def test_backward_strided_and_misaligned_inputs(dev):
    """A g_lr that is not contiguous and a depth that is not 16-byte
    aligned give identical gradients."""
    depth, abm = _inputs(5, dev)
    g_hr, g_lr = _cotangents(5, dev, seed=9)
    gd, ga = tcuda.tpsf_physics_bwd(depth, abm, g_hr, g_lr)
    shifted = torch.empty(5 * 10000 + 1, device=dev)[1:].view(5, 100, 100)
    shifted.copy_(depth)
    g_lr_t = g_lr.transpose(1, 2).contiguous().transpose(1, 2)
    assert not g_lr_t.is_contiguous()
    gd_s, ga_s = tcuda.tpsf_physics_bwd(shifted, abm, g_hr, g_lr_t)
    assert torch.equal(gd_s, gd) and torch.equal(ga_s, ga)


def test_kernels_are_bitwise_reproducible(dev):
    """Two launches on the same inputs give the same bits: no atomics, and
    dbeta's partials are summed in a fixed order."""
    depth, abm = _inputs(256, dev, seed=31)
    g_hr, g_lr = _cotangents(256, dev, seed=32)
    hr1, lr1 = tcuda.tpsf_physics(depth, abm)
    hr2, lr2 = tcuda.tpsf_physics(depth, abm)
    gd1, ga1 = tcuda.tpsf_physics_bwd(depth, abm, g_hr, g_lr)
    gd2, ga2 = tcuda.tpsf_physics_bwd(depth, abm, g_hr, g_lr)
    torch.cuda.synchronize()
    assert torch.equal(hr1, hr2) and torch.equal(lr1, lr2)
    assert torch.equal(gd1, gd2) and torch.equal(ga1, ga2)


@pytest.mark.parametrize("b", [133, 265])
def test_kernels_match_plain_across_wave_counts(dev, b):
    """B = 133 and 265 put one sample beyond one and two full waves of the
    backward (two blocks on each of 132 SMs) and the forward (three)."""
    depth, abm = _inputs(b, dev, seed=b)
    hr_k, lr_k = tcuda.tpsf_physics(depth, abm)
    hr_p, lr_p = _plain(depth, abm)
    torch.testing.assert_close(hr_k, hr_p, **HR_TOL)
    torch.testing.assert_close(lr_k, lr_p, **LR_TOL)
    g_hr, g_lr = _cotangents(b, dev, seed=b + 1)
    gd_k, ga_k = tcuda.tpsf_physics_bwd(depth, abm, g_hr, g_lr)
    with f32_matmul():
        gd_p, ga_p = physics_vjp_plain(depth, abm, g_hr, g_lr, True, True)
    torch.testing.assert_close(ga_k, ga_p, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(gd_k, gd_p, rtol=1e-3, atol=1e-6)
    assert torch.all(ga_k[-1] == 0) and torch.all(hr_k[-1] == 0) and torch.all(lr_k[-1] == 0)


def test_occupancy_is_as_designed(dev):
    """The backward fits two blocks per SM (B <= 264 runs in one wave), the
    forward three."""
    info = tcuda.kernel_info()
    assert info["tpsf_physics_bwd"]["blocks_per_sm"] >= 2, info
    assert info["tpsf_physics"]["blocks_per_sm"] >= 3, info


def test_kernels_do_not_spill(dev):
    tcuda.build()
    ptxas = tcuda.ptxas_info(tcuda.build_log)
    info = tcuda.kernel_info()
    for name in ("tpsf_physics", "tpsf_physics_bwd"):
        assert ptxas[name]["spill_stores"] == 0 and ptxas[name]["spill_loads"] == 0, ptxas
        assert info[name]["local_bytes"] == 0, info


# ------------------------------------------------------------ the bf16 kernels
def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b", [1, 5, 256, 397, 8192])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_kernel_matches_plain(dev, precision, b):
    """One launch of the kernel of that precision (and none of another), at
    BF16_REL of its plain version; the all-zero map gives zero HR and LR."""
    depth, abm = _inputs(b + 1, dev, seed=b) if b == 1 else _inputs(b, dev, seed=b)
    depth, abm = depth[:b], abm[:b]
    with f32_matmul():
        hr_p, lr_p = physics_plain(depth, abm, precision)
    before = dict(tcuda.launch_counts)
    hr_k, lr_k = tcuda.tpsf_physics(depth, abm, precision)
    torch.cuda.synchronize()
    after = dict(tcuda.launch_counts)
    assert after.pop(BF16_KERNELS[precision]) == before.pop(BF16_KERNELS[precision]) + 1
    assert after == before
    assert _max_rel(hr_k, hr_p) < BF16_REL and _max_rel(lr_k, lr_p) < BF16_REL
    assert b == 1 or (torch.all(hr_k[-1] == 0) and torch.all(lr_k[-1] == 0))


def _edge_maps(dev, seed=0):
    """Contact maps at the kernel's edges: contacts on rows and columns 0
    and 99 (and the four corners) over noise, then maps where every pixel is
    in contact (the second max is 0, so HR and LR are exactly zero), then
    an ordinary map; returns depth, abm and the all-contact maps' indices."""
    rng = np.random.default_rng(seed)
    depth = 0.3 * rng.random((8, 100, 100)).astype(np.float32)
    depth[0, [0, -1], :] = 1.0
    depth[1, :, [0, -1]] = 1.0
    depth[2, [0, 0, -1, -1], [0, -1, 0, -1]] = 1.0
    depth[3, [0, -1], :] = 1.0
    depth[3, :, [0, -1]] = 1.0
    depth[4] = 0.7
    depth[5] = 2.0
    depth[6] = 0.7 + 4e-4 * rng.random((100, 100)).astype(np.float32)
    depth[7] = 0.0
    depth[7, 20:70, 30:80] = 1.0
    abm = (0.5 + np.abs(rng.standard_normal((8, 3)))).astype(np.float32)
    return torch.from_numpy(depth).to(dev), torch.from_numpy(abm).to(dev), [4, 5, 6]


@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_kernel_edge_maps(dev, precision):
    """Contacts on the map's border rows and columns, and all-contact maps:
    within BF16_REL of the plain version, and exactly zero where every pixel
    is in contact."""
    depth, abm, all_contact = _edge_maps(dev)
    with f32_matmul():
        hr_p, lr_p = physics_plain(depth, abm, precision)
    hr_k, lr_k = tcuda.tpsf_physics(depth, abm, precision)
    torch.cuda.synchronize()
    assert _max_rel(hr_k, hr_p) < BF16_REL and _max_rel(lr_k, lr_p) < BF16_REL
    assert torch.all(hr_k[all_contact] == 0) and torch.all(lr_k[all_contact] == 0)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_empty_batch_misaligned_strided_and_repeatable(dev, precision):
    """An empty batch launches nothing; a depth that is not 16-byte aligned
    and a strided one give the same bits; two launches give the same bits."""
    name = BF16_KERNELS[precision]
    before = tcuda.launch_counts[name]
    hr, lr = tcuda.tpsf_physics(torch.zeros(0, 100, 100, device=dev), torch.ones(0, 3, device=dev),
                                precision)
    assert hr.shape == (0, 100, 100) and lr.shape == (0, 4, 4)
    assert tcuda.launch_counts[name] == before
    depth, abm = _inputs(256, dev, seed=41)
    hr, lr = tcuda.tpsf_physics(depth, abm, precision)
    shifted = torch.empty(256 * 10000 + 1, device=dev)[1:].view(256, 100, 100)
    shifted.copy_(depth)
    strided = depth.transpose(1, 2).contiguous().transpose(1, 2)
    for d in (shifted, strided, depth):
        hr2, lr2 = tcuda.tpsf_physics(d, abm, precision)
        assert torch.equal(hr2, hr) and torch.equal(lr2, lr)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_fused_counts_and_f32_backward(dev, precision):
    """The autograd wrapper at a bf16 precision: one launch of that kernel,
    of the wrapper and of the f32 backward per step, none of the f32
    forward; for a given cotangent the gradient equals the one at f32."""
    depth, abm = _inputs(5, dev, seed=3)
    g_lr = torch.randn(5, 4, 4, generator=torch.Generator().manual_seed(4)).to(dev)
    grads = {}
    for prec in ("highest", precision):
        before = dict(tcuda.launch_counts)
        a = abm.clone().requires_grad_(True)
        for _ in range(3):
            _hr, lr = tcuda.tpsf_physics_fused(depth, a, prec)
            grads[prec] = torch.autograd.grad(lr, a, g_lr)[0]
        torch.cuda.synchronize()
        added = {k: tcuda.launch_counts[k] - before[k] for k in before}
    assert added == {"tpsf_physics": 0, "tpsf_physics_fused": 3, "tpsf_physics_bwd": 3,
                     "tpsf_physics_bf16": 3 if precision == "default" else 0,
                     "tpsf_physics_bf16x3": 3 if precision == "high" else 0}
    assert torch.equal(grads[precision], grads["highest"])


@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_kernels_do_not_spill(dev, precision):
    """No spills; each kernel fits BF16_BLOCKS blocks per SM, the
    three-pass one (two bf16 planes per operand) as the one-pass one."""
    tcuda.build()
    name = BF16_KERNELS[precision]
    ptxas = tcuda.ptxas_info(tcuda.build_log)[name]
    info = tcuda.kernel_info()[name]
    assert ptxas["spill_stores"] == 0 and ptxas["spill_loads"] == 0, ptxas
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= BF16_BLOCKS, info

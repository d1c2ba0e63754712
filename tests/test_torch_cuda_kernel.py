"""The tPSF physics CUDA kernel, and its autograd wrapper, against the plain
PyTorch version, on the GPU.  Every test here needs an NVIDIA GPU and nvcc
and skips without them.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py -q

Tolerances are the JAX kernel tests': HR rtol/atol 1e-4, LR rtol 1e-4 /
atol 1e-6, gradients rtol 1e-3 / atol 1e-6; the plain version runs with
TF32 off (f32 FMA, as the kernel).
"""

import numpy as np
import pytest
import torch

from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.psf import f32_matmul, physics_plain

pytestmark = pytest.mark.gpu

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)


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
    """Kernel forward + recompute backward against autograd through the
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

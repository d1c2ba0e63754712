"""Port tPSF physics (tactilesr_torch.ops.psf and its CUDA kernel's wrapper)
vs the JAX package: the XLA separable path and the Pallas kernel in
interpret mode.  Tolerances are the JAX kernel test's: HR rtol/atol 1e-4,
LR rtol 1e-4 / atol 1e-6 (f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tactilesr_tpu.ops import psf as jax_psf
from tactilesr_tpu.ops.pallas.tpsf_kernel import tpsf_physics_pallas_raw
from tactilesr_torch.ops import cuda as torch_cuda
from tactilesr_torch.ops import psf as torch_psf

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs(rng, b=3, zero_last=False):
    """Rectangular contact maps, as in tests/test_pallas_kernels.py."""
    depth = np.zeros((b, 100, 100), np.float32)
    for k in range(b):
        depth[k, 20 + 5 * k: 60, 30: 70 + 3 * k] = 1.0
    if zero_last:
        depth[-1] = 0.0
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    return depth, abm


def _port(depth, abm):
    hr, lr = torch_cuda.tpsf_physics(torch.from_numpy(depth), torch.from_numpy(abm))
    return hr.numpy(), lr.numpy()


def test_plain_matches_jax_xla(rng):
    depth, abm = _inputs(rng)
    hr, lr = _port(depth, abm)
    hr_x, lr_x, _ = jax_psf.tpsf_forward_physics(jnp.asarray(depth), jnp.asarray(abm), return_psf=False)
    np.testing.assert_allclose(hr, np.asarray(hr_x), **HR_TOL)
    np.testing.assert_allclose(lr, np.asarray(lr_x), **LR_TOL)


def test_plain_matches_pallas_interpret(rng):
    depth, abm = _inputs(rng)
    hr, lr = _port(depth, abm)
    hr_p, lr_p = tpsf_physics_pallas_raw(jnp.asarray(depth), jnp.asarray(abm), interpret=True)
    np.testing.assert_allclose(hr, np.asarray(hr_p), **HR_TOL)
    np.testing.assert_allclose(lr, np.asarray(lr_p), **LR_TOL)


def test_odd_batch_no_leakage(rng):
    """B=5 (the JAX kernel pads this to its tile): batched == one by one,
    and == the Pallas kernel run with a padded tile of 2."""
    depth, abm = _inputs(rng, b=5)
    hr, lr = _port(depth, abm)
    assert hr.shape == (5, 100, 100) and lr.shape == (5, 4, 4)
    for k in range(5):
        hr1, lr1 = _port(depth[k:k + 1], abm[k:k + 1])
        np.testing.assert_allclose(hr[k], hr1[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lr[k], lr1[0], rtol=1e-5, atol=1e-7)
    hr_p, lr_p = tpsf_physics_pallas_raw(jnp.asarray(depth), jnp.asarray(abm), interpret=True, tile=2)
    np.testing.assert_allclose(hr, np.asarray(hr_p), **HR_TOL)
    np.testing.assert_allclose(lr, np.asarray(lr_p), **LR_TOL)


def test_all_zero_depth_gives_zero(rng):
    """The second max has a 0 floor: an all-zero map renders an all-zero HR
    and LR, in the port and in JAX alike."""
    depth, abm = _inputs(rng, b=2, zero_last=True)
    hr, lr = _port(depth, abm)
    assert np.all(hr[-1] == 0.0) and np.all(lr[-1] == 0.0)
    hr_x, lr_x, _ = jax_psf.tpsf_forward_physics(jnp.asarray(depth), jnp.asarray(abm), return_psf=False)
    np.testing.assert_allclose(hr, np.asarray(hr_x), **HR_TOL)
    np.testing.assert_allclose(lr, np.asarray(lr_x), **LR_TOL)


def test_empty_batch(rng):
    hr, lr = _port(np.zeros((0, 100, 100), np.float32), np.ones((0, 3), np.float32))
    assert hr.shape == (0, 100, 100) and lr.shape == (0, 4, 4)


def _blob(rng):
    depth = np.zeros((2, 100, 100), np.float32)
    depth[:, 30:70, 40:80] = 1.0
    depth += 0.001 * rng.standard_normal((2, 100, 100)).astype(np.float32)
    return depth


def test_separable_hr_matches_direct_conv(rng):
    """Golden: the banded matmuls equal the padded 99x99 conv (1e-4)."""
    depth = torch.from_numpy(_blob(rng))
    alpha, beta = torch.tensor([1.2, 0.7]), torch.tensor([1.05, 1.6])
    got = torch_psf.depth_to_hr(depth, alpha, beta)
    want = torch_psf.depth_to_hr_direct(depth, alpha, beta)
    torch.testing.assert_close(got, want, **HR_TOL)
    # and the port's direct form is the JAX direct form
    want_jax = np.asarray(jax_psf.depth_to_hr_direct(jnp.asarray(depth[0].numpy()), 1.2, 1.05))
    np.testing.assert_allclose(want[0].numpy(), want_jax, **HR_TOL)


@pytest.mark.parametrize("m", [0.5, 1.0, 3.7])
def test_separable_degradation_matches_direct(rng, m):
    hr = torch.from_numpy(rng.random((2, 100, 100)).astype(np.float32))
    mm = torch.full((2,), m)
    got = torch_psf.degradation(hr, mm)
    want = torch_psf.degradation_direct(hr, mm)
    torch.testing.assert_close(got, want, **LR_TOL)
    want_jax = np.asarray(jax_psf.degradation_direct(jnp.asarray(hr[1].numpy()), m))
    np.testing.assert_allclose(want[1].numpy(), want_jax, **LR_TOL)


def test_psf_kernel_matches_jax():
    got = torch_psf.psf_kernel(torch.tensor([1.3]), torch.tensor([1.1]))[0].numpy()
    want = np.asarray(jax_psf.psf_kernel(1.3, 1.1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_forward_physics_return_psf_and_option(rng):
    depth, abm = _inputs(rng, b=2)
    hr, lr, psf = torch_psf.tpsf_forward_physics(torch.from_numpy(depth), torch.from_numpy(abm))
    assert psf.shape == (2, 99, 99)
    hr2, lr2, none = torch_psf.tpsf_forward_physics(
        torch.from_numpy(depth), torch.from_numpy(abm), return_psf=False, use_kernel=False
    )
    assert none is None
    torch.testing.assert_close(hr, hr2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="use_kernel"):
        torch_psf.tpsf_forward_physics(torch.from_numpy(depth), torch.from_numpy(abm), use_kernel="yes")


def test_second_max_gradient_is_detached(rng):
    """Contact pixels carry the detached non-contact max: d sum(HR)/d alpha
    is the sum of the non-contact HR at alpha = 1 (as the JAX golden)."""
    depth = torch.from_numpy(_blob(rng)[:1])
    alpha = torch.tensor([1.0], requires_grad=True)
    hr = torch_psf.depth_to_hr(depth, alpha, torch.tensor([1.0]))
    hr.sum().backward()
    mask = torch_psf.contact_mask(depth)
    manual = hr.detach()[~mask].sum()
    torch.testing.assert_close(alpha.grad[0], manual, rtol=1e-4, atol=0)


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError, match="depth"):
        torch_cuda.tpsf_physics(torch.zeros(2, 50, 50), torch.ones(2, 3))
    with pytest.raises(ValueError, match="abm"):
        torch_cuda.tpsf_physics(torch.zeros(2, 100, 100), torch.ones(3, 3))


def test_cpu_path_does_not_count_launches(rng):
    torch_cuda.reset_launch_counts()
    depth, abm = _inputs(rng, b=1)
    _port(depth, abm)
    assert torch_cuda.launch_counts["tpsf_physics"] == 0

"""The physics' closed-form backward (``ops/psf.py::physics_vjp_plain``, the
plain version of the backward CUDA kernel) on the CPU: against torch
autograd through ``physics_plain``, against JAX's ``jax.vjp`` of
``_physics_single`` and of ``tpsf_physics_fused`` (Pallas interpret
forward), and its wrapper ``tpsf_physics_bwd`` on CPU tensors.

Tolerances: against autograd, which differentiates the same f32 function
with its sums in another order, rtol 1e-5 with atol 1e-5 of the largest
gradient; against JAX, the JAX kernel tests' GRAD_TOL (rtol 1e-3, atol
1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesr_tpu.ops.pallas.tpsf_kernel import tpsf_physics_fused as jax_fused
from tactilesr_tpu.ops.psf import _physics_single as jax_physics
from tactilesr_torch.ops import cuda as tcuda
from tactilesr_torch.ops.psf import physics_plain, physics_vjp_plain

GRAD_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_pallas_kernels.py:45


def _inputs(rng, b=4):
    """Rectangular contact maps, the first with sensor-like noise, the
    second-to-last constant (all contact) and the last all-zero; abm =
    0.5 + |N(0, 1)|; seeded cotangents, the HR one at the scale of the
    LR one's pull-back (c U^T g_lr U, c ~ 1e-4)."""
    depth = np.zeros((b, 100, 100), np.float32)
    for k in range(b):
        depth[k, 20 + 5 * k:60, 30:70 + 3 * k] = 1.0
    depth[0] += 0.01 * rng.standard_normal((100, 100)).astype(np.float32)
    depth[-2] = 0.7
    depth[-1] = 0.0
    abm = (0.5 + np.abs(rng.standard_normal((b, 3)))).astype(np.float32)
    g_lr = rng.standard_normal((b, 4, 4)).astype(np.float32)
    g_hr = (1e-4 * rng.standard_normal((b, 100, 100))).astype(np.float32)
    return depth, abm, g_hr, g_lr


def _autograd(depth, abm, g_hr, g_lr):
    d = torch.from_numpy(depth).requires_grad_(True)
    a = torch.from_numpy(abm).requires_grad_(True)
    hr, lr = physics_plain(d, a)
    outs = [(o, torch.from_numpy(g)) for o, g in ((hr, g_hr), (lr, g_lr)) if g is not None]
    return torch.autograd.grad([o for o, _ in outs], [d, a], [g for _, g in outs])


def _close_to_autograd(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("with_hr", [False, True], ids=["lr_only", "lr_and_hr"])
@pytest.mark.parametrize("need_depth", [True, False], ids=["depth_and_abm", "abm_only"])
def test_vjp_matches_autograd(rng, with_hr, need_depth):
    depth, abm, g_hr, g_lr = _inputs(rng)
    g_hr = g_hr if with_hr else None
    gd_ref, ga_ref = _autograd(depth, abm, g_hr, g_lr)
    gd, ga = physics_vjp_plain(torch.from_numpy(depth), torch.from_numpy(abm),
                               None if g_hr is None else torch.from_numpy(g_hr),
                               torch.from_numpy(g_lr), need_depth=need_depth)
    _close_to_autograd(ga, ga_ref)
    if need_depth:
        _close_to_autograd(gd, gd_ref)
        assert float(gd_ref.abs().max()) > 0
    else:
        assert gd is None
    # all contact (constant) and all zero: HR is 0 and no pixel passes a gradient
    assert torch.all(ga[-2:] == 0) and torch.all(ga_ref[-2:] == 0)
    assert float(ga[:-2].abs().min()) > 0


def test_vjp_hr_cotangent_alone(rng):
    """Only HR's cotangent: the LR path adds nothing and m gets no gradient."""
    depth, abm, g_hr, _ = _inputs(rng)
    gd_ref, ga_ref = _autograd(depth, abm, g_hr, None)
    gd, ga = physics_vjp_plain(torch.from_numpy(depth), torch.from_numpy(abm),
                               torch.from_numpy(g_hr), None)
    _close_to_autograd(ga, ga_ref)
    _close_to_autograd(gd, gd_ref)
    assert torch.all(ga[:, 2] == 0)


def test_vjp_depth_only_and_empty_batch(rng):
    depth, abm, _, g_lr = _inputs(rng, b=3)
    gd, ga = physics_vjp_plain(torch.from_numpy(depth), torch.from_numpy(abm), None,
                               torch.from_numpy(g_lr), need_depth=True, need_abm=False)
    assert ga is None
    _close_to_autograd(gd, _autograd(depth, abm, None, g_lr)[0])
    gd, ga = physics_vjp_plain(torch.zeros(0, 100, 100), torch.ones(0, 3), None, torch.zeros(0, 4, 4))
    assert gd.shape == (0, 100, 100) and ga.shape == (0, 3)


@pytest.mark.parametrize("with_hr", [False, True], ids=["lr_only", "lr_and_hr"])
def test_vjp_matches_jax_xla(rng, with_hr):
    """jax.vjp of the vmapped XLA physics at f32 HIGHEST: the function the
    JAX package's custom_vjp backward differentiates."""
    depth, abm, g_hr, g_lr = _inputs(rng)
    g_hr = g_hr if with_hr else np.zeros_like(g_hr)
    _out, vjp = jax.vjp(jax_physics, jnp.asarray(depth), jnp.asarray(abm))
    gd_j, ga_j = vjp((jnp.asarray(g_hr), jnp.asarray(g_lr)))
    gd, ga = physics_vjp_plain(torch.from_numpy(depth), torch.from_numpy(abm),
                               torch.from_numpy(g_hr) if with_hr else None, torch.from_numpy(g_lr))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_j), **GRAD_TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(gd_j), **GRAD_TOL)
    assert np.abs(np.asarray(gd_j)).max() > 1e-4


def test_vjp_matches_jax_fused_custom_vjp(rng):
    """jax.vjp of tpsf_physics_fused (Pallas interpret forward, the
    custom_vjp backward) against the port's kernel wrapper on CPU tensors."""
    depth, abm, g_hr, g_lr = _inputs(rng, b=3)
    _out, vjp = jax.vjp(jax_fused, jnp.asarray(depth), jnp.asarray(abm))
    gd_j, ga_j = vjp((jnp.asarray(g_hr), jnp.asarray(g_lr)))
    gd, ga = tcuda.tpsf_physics_bwd(torch.from_numpy(depth), torch.from_numpy(abm),
                                    torch.from_numpy(g_hr), torch.from_numpy(g_lr))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_j), **GRAD_TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(gd_j), **GRAD_TOL)


def test_bwd_wrapper_on_cpu_launches_nothing_and_checks_shapes(rng):
    depth, abm, g_hr, g_lr = _inputs(rng, b=2)
    d, a = torch.from_numpy(depth), torch.from_numpy(abm)
    before = dict(tcuda.launch_counts)
    gd, ga = tcuda.tpsf_physics_bwd(d, a, None, torch.from_numpy(g_lr), need_depth=False)
    assert gd is None and ga.shape == (2, 3)
    assert tcuda.launch_counts == before
    with pytest.raises(ValueError, match="g_lr"):
        tcuda.tpsf_physics_bwd(d, a, None, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="g_hr"):
        tcuda.tpsf_physics_bwd(d, a, torch.zeros(3, 100, 100), None)


def test_fused_backward_with_both_cotangents_matches_autograd(rng):
    """Through TPSFPhysicsFn with a loss that reads HR and LR: the HR
    cotangent reaches the closed form, and the gradients equal autograd."""
    depth, abm, g_hr, g_lr = _inputs(rng, b=3)
    gd_ref, ga_ref = _autograd(depth, abm, g_hr, g_lr)
    d = torch.from_numpy(depth).requires_grad_(True)
    a = torch.from_numpy(abm).requires_grad_(True)
    hr, lr = tcuda.tpsf_physics_fused(d, a)
    torch.autograd.backward([hr, lr], [torch.from_numpy(g_hr), torch.from_numpy(g_lr)])
    _close_to_autograd(a.grad, ga_ref)
    _close_to_autograd(d.grad, gd_ref)

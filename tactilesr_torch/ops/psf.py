"""tPSF physics in plain PyTorch: PSF synthesis, depth -> HR rendering and
taxel degradation, batched over samples.

Reference behavior (model/tPSFNet.py of the original torch code): the PSF is
``alpha * exp(-sdf^2 / beta^2)`` on a 99x99 distance field min-max scaled to
[0, 10]; the depth map is zero-padded by 48 and convolved with it (padding
1) to a (100, 100) HR map whose contact pixels (depth > max - 1e-3) take
the max of the non-contact HR; 16 Gaussian taxel masks, jointly min-max
normalized, degrade HR to a (4, 4) reading scaled by 1e-4.

Every Gaussian here is separable, so per sample

    HR0 = alpha * (A @ D @ A^T)      A[i, j] = g[j - i + 49], |j - i| <= 49
    LR  = (U @ HR @ U^T - mn * sum(HR)) * 1e-4 / (1 - mn)

with ``g[t] = exp(-C_PSF (t-49)^2 / beta^2)``, ``U[t, x] = exp(-C_MASK
(x - 12 - 25t)^2 / m)`` and ``mn = exp(-100 / m)``.  This module is the
plain version of the CUDA kernels in ``ops/cuda/tpsf_kernel.cu``, which
compute the same function; ``depth_to_hr_direct`` and
``degradation_direct`` keep the direct forms for golden tests.

``precision`` selects the arithmetic of the four products (A D, T A^T,
U HR and (U HR) U^T), as ``physics_precision`` selects the in-kernel dots
of ``tactilesr_tpu/ops/pallas/tpsf_kernel.py::_sample_body``:
``highest`` multiplies in f32; ``default`` rounds both operands of each
product to bf16 and accumulates in f32 (one bf16 pass); ``high`` splits
each operand x into bf16 parts hi = bf16(x), lo = bf16(x - hi) and sums
hi.hi + hi.lo + lo.hi in f32 (three passes).  The rounding happens at the
products only: T and U HR are f32 sums rounded as the next product's
operand, and the contact mask, the second max, sum(HR) and the alpha
scale see unrounded f32 values.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = [
    "PSF_SIZE",
    "HR_SIZE",
    "psf_kernel",
    "contact_mask",
    "depth_to_hr",
    "depth_to_hr_direct",
    "degradation",
    "degradation_direct",
    "PHYSICS_PRECISIONS",
    "resolve_physics_precision",
    "resolve_use_kernel",
    "physics_plain",
    "physics_vjp_plain",
    "f32_matmul",
    "tpsf_forward_physics",
]

PSF_SIZE = 99
PSF_CENTER = PSF_SIZE // 2  # 49
HR_SIZE = 100
PAD = 48  # ZeroPad2d(48): 100 + 96 = 196, conv pad 1 -> out 100
TAXELS = 4
TAXEL_CENTER_0 = 12
TAXEL_PITCH = 25
DISTURBANCE = 1e-3
DEGRADE_SCALE = 1e-4

# sdf fields are min-max scaled to [0, 10]; distances scale linearly, so the
# scaled squared distance is C * ((x-cx)^2 + (y-cy)^2) with:
_PSF_DMAX = PSF_CENTER * math.sqrt(2.0)  # corner of the 99x99 field
C_PSF = (10.0 / _PSF_DMAX) ** 2
_MASK_DMAX = (HR_SIZE - 1 - TAXEL_CENTER_0) * math.sqrt(2.0)  # (12,12) -> (99,99)
C_MASK = (10.0 / _MASK_DMAX) ** 2

PHYSICS_PRECISIONS = ("highest", "high", "default")


def resolve_physics_precision(val) -> str:
    """``physics_precision`` -> "highest", "high" or "default" (any case;
    None means "highest", the f32 parity default).  Anything else raises, as
    JAX's ``resolve_physics_precision`` does."""
    if val is None:
        return "highest"
    if isinstance(val, str) and val.lower() in PHYSICS_PRECISIONS:
        return val.lower()
    raise ValueError(f"physics_precision={val!r}: expected highest|high|default")


def resolve_use_kernel(val):
    """``use_pallas_physics`` (``--use-pallas`` in generation): auto or true
    -> "auto" (the kernel's autograd wrapper on CUDA tensors, its plain
    version on CPU tensors); false -> False (the plain f32 physics under
    autograd everywhere).  Typos raise."""
    if isinstance(val, str):
        low = val.lower()
        if low in ("auto", "1", "true", "yes", "on"):
            return "auto"
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"use_pallas_physics={val!r}: expected auto|true|false "
                         "(or on/off/yes/no/1/0)")
    return "auto" if val else False


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in f32 with the operands rounded as ``precision`` says (the
    module docstring).  bf16 x bf16 products are exact in f32, so only the
    order of the f32 sums can differ from the tensor cores'."""
    if precision == "highest":
        return torch.matmul(a, b)
    if precision == "default":
        return torch.matmul(_bf16(a), _bf16(b))
    a_hi, b_hi = _bf16(a), _bf16(b)
    a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def _col(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1) for broadcasting per-sample scalars."""
    return v.reshape(-1, 1, 1)


def _psf_profile(beta: torch.Tensor) -> torch.Tensor:
    """(B,) beta -> (B, 99) factors g[t] = exp(-C_PSF (t - 49)^2 / beta^2)."""
    t = torch.arange(PSF_SIZE, dtype=torch.float32, device=beta.device)
    d2 = (t - PSF_CENTER) ** 2
    b = beta.reshape(-1, 1)
    return torch.exp(-C_PSF * d2 / (b * b))


def psf_kernel(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(B,) alpha, beta -> (B, 99, 99) PSF = alpha * g (outer) g."""
    g = _psf_profile(beta)
    return _col(alpha) * g[:, :, None] * g[:, None, :]


def _band_matrix(beta: torch.Tensor) -> torch.Tensor:
    """(B,) beta -> (B, 100, 100) banded A with A @ D @ A^T == depth (x) PSF.

    Output row i of the padded conv draws from raw rows j with
    -49 <= j - i <= 49, weighted g[j - i + 49]; the 48-pad adds only zeros.
    """
    idx = torch.arange(HR_SIZE, device=beta.device)
    u = idx[None, :] - idx[:, None] + PSF_CENTER  # kernel tap index
    valid = (u >= 0) & (u < PSF_SIZE)
    d2 = (u.to(torch.float32) - PSF_CENTER) ** 2
    b = _col(beta)
    g = torch.exp(-C_PSF * d2 / (b * b))
    return torch.where(valid, g, torch.zeros((), device=beta.device))


def contact_mask(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> contact region depth > max - 1e-3, per sample."""
    mx = depth.amax(dim=(-2, -1), keepdim=True)
    return depth > (mx - DISTURBANCE)


def _second_max_fixup(hr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Contact pixels take the max of the detached non-contact HR (the
    reference's "second max"); the 0 floor means an all-contact map is 0."""
    zero = torch.zeros((), dtype=hr.dtype, device=hr.device)
    non_contact_max = torch.where(mask, zero, hr).amax(dim=(-2, -1), keepdim=True)
    return torch.where(mask, non_contact_max.detach(), hr)


def depth_to_hr(depth: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                precision: str = "highest") -> torch.Tensor:
    """(B, 100, 100) depth -> HR maps through the separable matmuls."""
    a = _band_matrix(beta)
    d = depth.to(torch.float32)
    hr = _col(alpha) * _dot(_dot(a, d, precision), a.transpose(-2, -1), precision)
    return _second_max_fixup(hr, contact_mask(d))


def depth_to_hr_direct(depth: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Direct conv formulation (golden reference for ``depth_to_hr``)."""
    d = depth.to(torch.float32)
    b = d.shape[0]
    psf = psf_kernel(alpha, beta)  # (B, 99, 99)
    padded = F.pad(d, (PAD, PAD, PAD, PAD))[None]  # (1, B, 196, 196)
    out = F.conv2d(padded, psf[:, None], padding=1, groups=b)[0]
    return _second_max_fixup(out, contact_mask(d))


def _taxel_profiles(m: torch.Tensor) -> torch.Tensor:
    """(B,) m -> (B, 4, 100) per-taxel factors exp(-C_MASK (t - c_i)^2 / m)."""
    t = torch.arange(HR_SIZE, dtype=torch.float32, device=m.device)[None, :]
    c = (
        torch.arange(TAXELS, dtype=torch.float32, device=m.device)[:, None] * TAXEL_PITCH
        + TAXEL_CENTER_0
    )
    return torch.exp(-C_MASK * (t - c) ** 2 / _col(m))


def degradation(hr: torch.Tensor, m: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """(B, 100, 100) HR -> (B, 4, 4) degraded readings, separable form.

    The joint min-max of the 16 masks has min mn = exp(-100/m) and max 1,
    so the normalized sum is (U @ HR @ U^T - mn * sum(HR)) / (1 - mn).
    """
    u = _taxel_profiles(m)
    mn = _col(torch.exp(-100.0 / m))
    hrf = hr.to(torch.float32)
    t = _dot(_dot(u, hrf, precision), u.transpose(-2, -1), precision)
    total = hrf.sum(dim=(-2, -1), keepdim=True)
    return (t - mn * total) / (1.0 - mn) * DEGRADE_SCALE


def degradation_direct(hr: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Direct 16-mask formulation (golden reference for ``degradation``)."""
    x = torch.arange(HR_SIZE, dtype=torch.float32, device=hr.device)
    cx = torch.arange(TAXELS, dtype=torch.float32, device=hr.device) * TAXEL_PITCH + TAXEL_CENTER_0
    d2 = (x[None, None, :, None] - cx[:, None, None, None]) ** 2 + (
        x[None, None, None, :] - cx[None, :, None, None]
    ) ** 2  # (4, 4, 100, 100)
    masking = torch.exp(-C_MASK * d2[None] / m.reshape(-1, 1, 1, 1, 1))
    lo = masking.amin(dim=(1, 2, 3, 4), keepdim=True)
    hi = masking.amax(dim=(1, 2, 3, 4), keepdim=True)
    masking = (masking - lo) / (hi - lo)
    return torch.einsum("bhw,bijhw->bij", hr.to(torch.float32), masking) * DEGRADE_SCALE


@contextlib.contextmanager
def f32_matmul():
    """TF32 off for CUDA matmuls inside the block, restored after it.

    Uses the same flag as ``torch.backends.cuda.matmul.allow_tf32`` readers
    elsewhere in the port (mixing it with ``torch.get_float32_matmul_precision``
    raises in recent torch)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def physics_plain(depth: torch.Tensor, abm: torch.Tensor, precision: str = "highest"):
    """Plain batched physics: depth (B,100,100), abm (B,3) -> (HR, LR).

    The CUDA kernels' reference, the products at ``precision`` (the module
    docstring); they accumulate in f32, so set TF32 off on a GPU to
    compare with the kernels."""
    precision = resolve_physics_precision(precision)
    abm = abm.to(torch.float32)
    hr = depth_to_hr(depth, abm[:, 0], abm[:, 1], precision)
    return hr, degradation(hr, abm[:, 2], precision)


def physics_vjp_plain(depth, abm, g_hr, g_lr, need_depth: bool = True, need_abm: bool = True):
    """Closed-form vector-Jacobian product of ``physics_plain``, batched.

    depth (B,100,100), abm (B,3) and the cotangents g_hr (B,100,100) and
    g_lr (B,4,4), either of which may be None -> (g_depth or None, g_abm or
    None) in f32.  The plain version of the backward kernel in
    ``ops/cuda/tpsf_kernel.cu``; per sample, with T = A D, HR0 = alpha T A
    (A is symmetric), U the taxel profiles, c = 1e-4 / (1 - mn):

        G      = c (U^T g_lr U - mn sum(g_lr)) + g_hr,  G0 = where(mask, 0, G)
        d_alpha = sum(G0 * T A)
        d_beta  = sum(dL/dA * dA/dbeta),  dL/dA = alpha (G0 A D^T + G0^T T)
        d_m     = sum(c (g_lr W + g_lr^T V) * dU/dm)
                  + sum(g_lr * 1e-4 (T2 - S) / (1 - mn)^2) * dmn/dm
        g_depth = alpha A G0 A

    with V = U HR, W = U HR^T, T2 = V U^T and S = sum(HR).  The contact
    pixels take the detached second max, so they pass no gradient.  The
    kernel sums dL/dA along its diagonals (the row and column correlations
    h1 and h2) before weighting by dg/dbeta; that is the same sum.
    """
    d = depth.to(torch.float32)
    abm = abm.to(torch.float32)
    alpha, beta, m = _col(abm[:, 0]), _col(abm[:, 1]), _col(abm[:, 2])
    a = _band_matrix(abm[:, 1])
    t = torch.matmul(a, d)
    hr0_a = torch.matmul(t, a)  # HR0 / alpha
    mask = contact_mask(d)
    mn = torch.exp(-100.0 / m)
    c = DEGRADE_SCALE / (1.0 - mn)
    u = _taxel_profiles(abm[:, 2])
    g = torch.zeros_like(d)
    if g_lr is not None:
        gam = g_lr.to(torch.float32)
        ut = u.transpose(-2, -1)
        g = c * (torch.matmul(torch.matmul(ut, gam), u) - mn * gam.sum(dim=(-2, -1), keepdim=True))
    if g_hr is not None:
        g = g + g_hr.to(torch.float32)
    g0 = torch.where(mask, torch.zeros((), device=d.device), g)
    q = torch.matmul(g0, a)
    g_depth = alpha * torch.matmul(a, q) if need_depth else None
    if not need_abm:
        return g_depth, None

    d_alpha = (g0 * hr0_a).sum(dim=(-2, -1))
    d_a = alpha * (torch.matmul(q, d.transpose(-2, -1)) + torch.matmul(g0.transpose(-2, -1), t))
    idx = torch.arange(HR_SIZE, dtype=torch.float32, device=d.device)
    o2 = (idx[None, :] - idx[:, None]) ** 2  # (k - i)^2; A is 0 off the band
    d_beta = (d_a * a * (2.0 * C_PSF) * o2 / beta ** 3).sum(dim=(-2, -1))
    d_m = torch.zeros_like(d_alpha)
    if g_lr is not None:
        hr = _second_max_fixup(alpha * hr0_a, mask)
        v = torch.matmul(u, hr)
        w = torch.matmul(u, hr.transpose(-2, -1))
        t2 = torch.matmul(v, u.transpose(-2, -1))
        total = hr.sum(dim=(-2, -1), keepdim=True)
        g_u = c * (torch.matmul(gam, w) + torch.matmul(gam.transpose(-2, -1), v))
        centers = torch.arange(TAXELS, dtype=torch.float32, device=d.device) * TAXEL_PITCH + TAXEL_CENTER_0
        du_dm = u * C_MASK * (idx[None, :] - centers[:, None]) ** 2 / (m * m)
        dlr_dmn = DEGRADE_SCALE * (t2 - total) / (1.0 - mn) ** 2
        dmn_dm = mn * 100.0 / (m * m)
        d_m = (g_u * du_dm).sum(dim=(-2, -1)) + (gam * dlr_dmn * dmn_dm).sum(dim=(-2, -1))
    return g_depth, torch.stack([d_alpha, d_beta, d_m], dim=-1)


def tpsf_forward_physics(depth, alpha_beta_m, return_psf: bool = True, use_kernel="auto",
                         precision=None):
    """Batched physics: depth (B,100,100), alpha_beta_m (B,3) ->
    (HR (B,100,100), LR_degrade (B,4,4), psf (B,99,99) or None).

    ``use_kernel``: "auto" (the default) goes through the kernel's
    differentiable wrapper ``tpsf_physics_fused`` at ``precision``
    (``resolve_physics_precision``), which launches the CUDA kernel of that
    precision when the tensors lie on a CUDA device and runs its plain
    version when they lie on the CPU; False runs the plain f32 physics
    under autograd anywhere, whatever ``precision`` says (the JAX
    package's XLA path ignores it too).  On a GPU "auto" never falls back:
    a failed build or launch raises.
    """
    if use_kernel not in ("auto", False):
        raise ValueError(f"use_kernel must be 'auto' or False, got {use_kernel!r}")
    precision = resolve_physics_precision(precision)
    if use_kernel == "auto":
        from .cuda import tpsf_physics_fused

        hr, lr = tpsf_physics_fused(depth, alpha_beta_m, precision)
    else:
        hr, lr = physics_plain(depth, alpha_beta_m)
    psf = None
    if return_psf:
        abm = alpha_beta_m.to(torch.float32)
        psf = psf_kernel(abm[:, 0], abm[:, 1])
    return hr, lr, psf

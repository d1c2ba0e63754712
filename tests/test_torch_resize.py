"""Port resize (tactilesr_torch.ops.resize) vs the JAX package's resize."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from tactilesr_tpu.ops import resize as jax_resize
from tactilesr_torch.ops import resize as torch_resize


@pytest.mark.parametrize("size_in,size_out", [(4, 40), (100, 40), (7, 3)])
def test_resize_matrix_identical(size_in, size_out):
    np.testing.assert_array_equal(
        torch_resize.bilinear_resize_matrix(size_in, size_out),
        jax_resize.bilinear_resize_matrix(size_in, size_out),
    )


@pytest.mark.parametrize("size_in,size_out", [(4, 40), (100, 40)])
def test_resize_matches_jax(rng, size_in, size_out):
    """Both are f32 matmuls over the same matrices: agree to f32 roundoff
    (rtol/atol 1e-6)."""
    x = (rng.random((3, 2, size_in, size_in)) * 4).astype(np.float32)  # NCHW
    got = torch_resize.resize_bilinear_nchw(torch.from_numpy(x), (size_out, size_out)).numpy()
    want = np.asarray(jax_resize.resize_bilinear_nchw(jnp.asarray(x), (size_out, size_out)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the JAX NHWC entry point gives the same maps
    want_nhwc = np.asarray(
        jax_resize.resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), (size_out, size_out))
    )
    np.testing.assert_allclose(got, want_nhwc.transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size_in,size_out", [(4, 40), (100, 40)])
def test_resize_matches_f_interpolate(rng, size_in, size_out):
    """F.interpolate(bilinear, align_corners=False) is the semantics being
    reproduced; 1e-5 covers its different accumulation order."""
    x = torch.from_numpy(rng.random((2, 3, size_in, size_in)).astype(np.float32))
    got = torch_resize.resize_bilinear(x, (size_out, size_out))
    want = F.interpolate(x, size=(size_out, size_out), mode="bilinear", align_corners=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_upsample_keeps_dtype_and_identity(rng):
    x = torch.from_numpy(rng.random((1, 3, 4, 4)).astype(np.float32)).to(torch.bfloat16)
    up = torch_resize.upsample_bilinear(x, 10)
    assert up.shape == (1, 3, 40, 40) and up.dtype == torch.bfloat16
    assert torch_resize.resize_bilinear(x, (4, 4)) is x

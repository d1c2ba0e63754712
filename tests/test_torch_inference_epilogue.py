"""The fused serving graph written as convolutions with epilogues
(``tactilesr_torch/models/inference.py``: ``_conv``'s bias, added tensor
and ReLU), on the CPU, where every convolution runs as the decomposition
(``F.conv2d``, then the adds and the ReLU), at the two smallest batch
shapes a caller sends (1 and 5 frames): STSR, the 7-reading MTSR in every
branch layout, and TactileSRCNN, each against JAX's fused graph of the same
layout and the port's layer-by-layer NCHW eval model, f32.  The forwards
count their conv calls, none of them fused on the CPU.

Tolerances are the fused-graph tests' own: TactileSR rtol 1e-4 / atol 1e-5
(``tests/test_torch_inference_branch.py``, ``tests/test_torch_models.py``);
TactileSRCNN rtol 1e-5 / atol 1e-5 of the output's range
(``tests/test_torch_sr_cnn.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesr_tpu.models import inference as jax_inference
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict, tactile_srcnn_state_dict
from tactilesr_torch.models.inference import (
    fold_inference_params,
    fold_inference_params_cnn,
    tactile_sr_cnn_infer,
    tactile_sr_infer,
)
from tactilesr_torch.models.tactile_sr import TactileSR
from test_torch_inference_branch import ARCH, JAX_TOL, _frames, _variables
from test_torch_sr_cnn import _jax_variables, _perturbed, _port_cnn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("seqs_cnt,mode", [(1, "per_seq"), (7, "per_seq"), (7, "dense"), (7, "grouped"),
                                           (7, "mixed")])
def test_tactile_sr_matches_jax_and_the_eval_model(tmp_path, seqs_cnt, mode, batch):
    v = _variables(tmp_path, seqs_cnt, 1)
    sd = tactile_sr_state_dict(v)
    x = _frames(3, batch, seqs_cnt)
    kw = dict(ARCH, seqs_cnt=seqs_cnt, pattern_layers=1)
    jf = jax_inference.fold_inference_params(v, seqs_cnt=seqs_cnt, pattern_layers=1, dtype=jnp.float32,
                                             branch_mode=mode)
    want = np.asarray(jax_inference.tactile_sr_infer(jf, jnp.asarray(x), branch_mode=mode, **kw))
    folded = fold_inference_params(sd, seqs_cnt=seqs_cnt, pattern_layers=1, dtype=torch.float32,
                                   branch_mode=mode)
    counts = {}
    got = tactile_sr_infer(folded, torch.from_numpy(x), branch_mode=mode, counts=counts, **kw).numpy()
    assert got.shape == (batch, 1, 16, 16) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **JAX_TOL)
    model = TactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                      force_feature_extra_layer_cnt=1)
    model.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(got, model.eval()(torch.from_numpy(x)).numpy(), **JAX_TOL)
    branches = 3 * seqs_cnt if mode == "per_seq" else 3  # two convs and the fuse conv's part a branch
    assert counts == {"convs": branches + 5 + 6, "fused_convs": 0}


@pytest.mark.parametrize("batch", [1, 5])
def test_tactile_sr_cnn_matches_jax_and_the_eval_model(rng, batch):
    variables = _perturbed(_jax_variables(msrb_cnt=1, seed=4), rng)
    x = (rng.random((batch, 3, 4, 4)) * 4).astype(np.float32)
    want = np.asarray(jax_inference.tactile_sr_cnn_infer(
        jax_inference.fold_inference_params_cnn(variables, msrb_cnt=1, dtype=jnp.float32),
        jnp.asarray(x), scale_factor=4, msrb_cnt=1))
    folded = fold_inference_params_cnn(tactile_srcnn_state_dict(variables), msrb_cnt=1, dtype=torch.float32)
    counts = {}
    got = tactile_sr_cnn_infer(folded, torch.from_numpy(x), scale_factor=4, msrb_cnt=1, counts=counts).numpy()
    span = float(np.abs(want).max())
    assert got.shape == (batch, 1, 16, 16) and span > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * span)
    with torch.no_grad():
        own = _port_cnn(variables, msrb_cnt=1).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, own, rtol=1e-5, atol=1e-5 * span)
    assert counts == {"convs": 3 + 5 + 1, "fused_convs": 0}


def test_fold_keeps_its_keys_shapes_dtypes_and_the_cpu_layout(tmp_path):
    """Kernels in the compute dtype, biases f32, NCHW-contiguous on the CPU
    (the layout is channels-last on CUDA only)."""
    sd = tactile_sr_state_dict(_variables(tmp_path, 1, 1))
    folded = fold_inference_params(sd, pattern_layers=1)
    assert sorted(folded) == sorted(
        ["inputLayer_pattern_0_conv0/k", "inputLayer_pattern_0_conv0/b", "inputLayer_pattern_0_conv1/k",
         "inputLayer_pattern_0_conv1/b", "inputContact/k0", "inputContact/b", "force_in/k",
         "res_0/conv1/k", "res_0/conv1/b", "res_0/conv2/k", "res_0/conv2/b", "head0/kf", "head0/kp",
         "head1/k"]
        + [f"msrb_0/{c}" for c in ("stage1/k", "stage1/b", "conv32/k", "conv32/b", "conv52/k", "conv52/b",
                                   "conf/k32", "conf/k52", "conf/b")])
    for k, v in folded.items():
        kernel = k.rsplit("/", 1)[-1].startswith("k")
        assert v.dtype == (torch.bfloat16 if kernel else torch.float32), k
        assert v.ndim == (4 if kernel else 1) and v.is_contiguous(), k
    assert folded["msrb_0/conv52/k"].shape == (128, 128, 5, 5)
    assert folded["msrb_0/conf/k32"].shape == (64, 128, 1, 1)
    assert folded["head1/k"].shape == (1, 128, 3, 3)

"""Port STSR model and fused serving graph vs the JAX package, in f32 on
the CPU, on weights from ``make_sr_checkpoint`` sent through the bridge.

Tolerance: rtol 1e-4 / atol 1e-5 on outputs of O(0.1-10) -- two f32 conv
stacks (XLA CPU vs oneDNN) summing in different orders through ~12 layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sr_checkpoint
from tactilesr_tpu.compat.export_torch import export_tactile_sr
from tactilesr_tpu.models.inference import fold_inference_params as jax_fold
from tactilesr_tpu.models.inference import tactile_sr_infer as jax_infer
from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.models.inference import fold_inference_params, tactile_sr_infer
from tactilesr_torch.models.tactile_sr import TactileSR

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(scale_factor=4, pattern_layers=1, force_layers=1)


def _perturb_stats(tree, rng):
    """Non-trivial BN running stats, so the fold is really exercised."""
    if isinstance(tree, dict):
        return {k: _perturb_stats(v, rng) if k not in ("mean", "var") else (
            (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32) if k == "mean"
            else (0.5 + rng.random(np.shape(v))).astype(np.float32)
        ) for k, v in tree.items()}
    return tree


def _variables(tmp_path, rng, pattern_layers=1):
    path = make_sr_checkpoint(tmp_path / f"sr{pattern_layers}.ckpt", pattern_layers=pattern_layers)
    model = jax_load(path)["model"]
    return {"params": model["params"], "batch_stats": _perturb_stats(model["batch_stats"], rng)}


def _port_model(variables, pattern_layers=1):
    m = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=pattern_layers,
                  force_feature_extra_layer_cnt=1)
    m.load_state_dict(tactile_sr_state_dict(variables), strict=True)
    return m.eval()


def _lr(rng, n=5):
    return (rng.random((n, 3, 4, 4)) * 4).astype(np.float32)


def test_state_dict_keys_match_reference_export(tmp_path, rng):
    variables = _variables(tmp_path, rng)
    ours = tactile_sr_state_dict(variables)
    ref = export_tactile_sr(variables)
    assert list(ours) == list(ref)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    # the port's module tree has exactly those names
    assert set(TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1).state_dict()) == set(ref)


def test_stsr_eval_forward_matches_jax(tmp_path, rng):
    variables = _variables(tmp_path, rng)
    x = _lr(rng)
    want = np.asarray(JaxTactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1,
                                   force_feature_extra_layer_cnt=1)
                      .apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port_model(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 1, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_fold_infer_matches_jax_infer(tmp_path, rng):
    variables = _variables(tmp_path, rng)
    x = _lr(rng)
    folded_j = jax_fold(variables, pattern_layers=1, force_layers=1, dtype=jnp.float32)
    want = np.asarray(jax_infer(folded_j, jnp.asarray(x), **ARCH))
    folded = fold_inference_params(tactile_sr_state_dict(variables), pattern_layers=1,
                                   force_layers=1, dtype=torch.float32)
    got = tactile_sr_infer(folded, torch.from_numpy(x), **ARCH).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # every folded tensor is the JAX one, transposed HWIO -> OIHW
    for k, v in folded_j.items():
        ref = np.asarray(v)
        ref = ref.transpose(3, 2, 0, 1) if ref.ndim == 4 else ref
        np.testing.assert_allclose(folded[k].numpy(), ref, rtol=1e-6, atol=1e-7, err_msg=k)


def test_fused_matches_unfused_f32(tmp_path, rng):
    variables = _variables(tmp_path, rng)
    x = torch.from_numpy(_lr(rng))
    folded = fold_inference_params(tactile_sr_state_dict(variables), pattern_layers=1,
                                   force_layers=1, dtype=torch.float32)
    with torch.no_grad():
        want = _port_model(variables)(x)
    torch.testing.assert_close(tactile_sr_infer(folded, x, **ARCH), want, **TOL)


def test_fold_dtypes(tmp_path, rng):
    folded = fold_inference_params(tactile_sr_state_dict(_variables(tmp_path, rng)),
                                   pattern_layers=1, force_layers=1)
    assert folded["msrb_0/stage1/k"].dtype == torch.bfloat16
    assert folded["msrb_0/stage1/k"].shape == (128, 64, 5, 5)
    assert folded["msrb_0/stage1/b"].dtype == torch.float32
    assert folded["head0/kf"].shape == (128, 64, 3, 3)


def test_fold_refuses_unconsumed_modules(tmp_path, rng):
    """A 2-MSRB checkpoint folded as 1 MSRB would serve a truncated net."""
    sd = tactile_sr_state_dict(_variables(tmp_path, rng, pattern_layers=2))
    with pytest.raises(ValueError, match="patternFeatureExtra_layer.1"):
        fold_inference_params(sd, pattern_layers=1, force_layers=1)
    with pytest.raises(KeyError):
        fold_inference_params(sd, pattern_layers=3, force_layers=1)


def test_bf16_model_forward_is_close(tmp_path, rng):
    """bf16 activations (params f32, BN in f32) stay near the f32 forward."""
    variables = _variables(tmp_path, rng)
    x = torch.from_numpy(_lr(rng))
    m32 = _port_model(variables)
    m16 = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        a, b = m32(x), m16.eval()(x)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) <= 0.05 * float(a.abs().max()) + 1e-3


def test_init_is_seeded():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1, generator=g())
    b = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1, generator=g())
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert float(a.inputContact_layer[1].weight.detach()[0]) == pytest.approx(0.1)
    # Kaiming fan_out: std sqrt(2 / (64 * 5 * 5)) for a 5x5 conv to 64 channels
    w = a.patternFeatureExtra_layer[0].conv_5_1[0].weight.detach()
    assert float(w.std()) == pytest.approx((2.0 / (64 * 25)) ** 0.5, rel=0.05)

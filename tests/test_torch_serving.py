"""Port SRPredictor vs the JAX package's, in f32 on the CPU, on one
``make_sr_checkpoint`` bundle exported to the port's ``.pth`` format.

Tolerance: rtol 1e-4 / atol 1e-5, as for the fused graph (f32 convs in
another order); padding and chunking must not change any row.  The
pipelined ``predict`` (staging slots, chunk k fetched after chunk k+1 is
enqueued) is held bit for bit against a chunk-by-chunk forward of the same
padded chunks."""

import json

import numpy as np
import pytest
import torch

from conftest import make_sr_checkpoint
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.serving import SRPredictor as JaxSRPredictor
from tactilesr_torch import serving as torch_serving
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.models.tactile_sr import TactileSR
from tactilesr_torch.parallel import make_mesh
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.serving import SRPredictor

TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(scale_factor=4, pattern_layers=1, force_layers=1, compute_dtype="float32")


def _ckpts(tmp_path, seed=0, pattern_layers=1):
    jax_path = make_sr_checkpoint(tmp_path / f"m{seed}_{pattern_layers}.ckpt", seed=seed,
                                  pattern_layers=pattern_layers)
    m = jax_load(jax_path)["model"]
    port_path = save_checkpoint_file(
        str(tmp_path / f"m{seed}_{pattern_layers}.pth"),
        tactile_sr_state_dict({"params": m["params"], "batch_stats": m["batch_stats"]}),
    )
    return jax_path, port_path


@pytest.mark.parametrize("n", [1, 9, 70])
def test_predict_matches_jax(tmp_path, rng, n):
    jax_path, port_path = _ckpts(tmp_path)
    buckets = (1, 8, 64)  # 9 pads into 64; 70 splits into 64 + 8 (padded)
    lr = (rng.random((n, 3, 4, 4)) * 4).astype(np.float32)
    want = JaxSRPredictor(jax_path, buckets=buckets, **KW).predict(lr)
    for fused in (True, False):
        got = SRPredictor(port_path, buckets=buckets, fused=fused, device="cpu", **KW).predict(lr)
        assert got.shape == (n, 1, 16, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


def _chunk_by_chunk(pred, lr):
    """What ``predict`` serves, one chunk at a time: each chunk zero-padded
    to its bucket, split into a shard a replica, each shard's forward
    fetched at once."""
    outs, i = [], 0
    while i < len(lr):
        b = pred._bucket(len(lr) - i)
        chunk = np.zeros((b,) + lr.shape[1:], np.float32)
        take = min(b, len(lr) - i)
        chunk[:take] = lr[i:i + take]
        shards = np.split(chunk, len(pred._replicas))
        outs.append(torch.cat([pred._forward(w, torch.from_numpy(x).to(d)).cpu()
                               for w, x, d in zip(pred._replicas, shards, pred.devices)])[:take].numpy())
        i += take
    return np.concatenate(outs)


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 3000, 8192])
def test_pipelined_predict_is_the_chunk_by_chunk_forward(tmp_path, n, replicas):
    """At the default buckets, on one CPU device or a two-device mesh of
    the CPU (each shard through its own slots)."""
    torch.manual_seed(0)
    model = TactileSR(scale_factor=2, pattern_feature_extra_layer_cnt=1, force_feature_extra_layer_cnt=1)
    path = save_checkpoint_file(str(tmp_path / "m.pth"), model.state_dict())
    mesh = make_mesh(["cpu"] * replicas) if replicas > 1 else None
    pred = SRPredictor(path, scale_factor=2, pattern_layers=1, force_layers=1, compute_dtype="float32",
                       device="cpu", mesh=mesh)
    lr = (np.random.default_rng(n).random((n, 3, 4, 4)) * 4).astype(np.float32)
    got = pred.predict(lr)
    assert got.shape == (n, 1, 8, 8) and got.dtype == np.float32 and got.flags.owndata
    np.testing.assert_array_equal(got, _chunk_by_chunk(pred, lr))


def test_padding_does_not_leak(tmp_path, rng):
    _, port_path = _ckpts(tmp_path)
    pred = SRPredictor(port_path, buckets=(4, 16), device="cpu", **KW)
    pred.warmup()
    lr = (rng.random((10, 3, 4, 4)) * 4).astype(np.float32)
    out = pred.predict(lr)
    np.testing.assert_allclose(pred.predict(lr[:1])[0], out[0], rtol=1e-5, atol=1e-5)
    assert pred.predict(lr[:0]).shape == (0, 1, 16, 16)
    with pytest.raises(ValueError, match="expected"):
        pred.predict(np.zeros((2, 5, 4, 4), np.float32))


@pytest.mark.parametrize("fused", [True, False])
def test_hot_swap_and_refusal(tmp_path, rng, fused):
    _, a = _ckpts(tmp_path, seed=0)
    _, b = _ckpts(tmp_path, seed=1)
    _, bigger = _ckpts(tmp_path, seed=2, pattern_layers=2)
    pred = SRPredictor(a, fused=fused, device="cpu", buckets=(8,), **KW)
    lr = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
    before = pred.predict(lr)
    pred.reload_checkpoint(b)
    swapped = pred.predict(lr)
    assert not np.allclose(swapped, before)
    np.testing.assert_allclose(
        swapped, SRPredictor(b, fused=fused, device="cpu", buckets=(8,), **KW).predict(lr),
        rtol=0, atol=0,
    )
    with pytest.raises((KeyError, ValueError)):
        pred.reload_checkpoint(bigger)
    np.testing.assert_allclose(pred.predict(lr), swapped, rtol=0, atol=0)  # old weights serve


def test_fingerprint_refusal_keeps_serving(tmp_path, rng):
    """A bundle with every expected key but another shape (a 5x5 head) is
    refused by the shape fingerprint; the old weights keep serving."""
    _, path = _ckpts(tmp_path)
    sd = torch.load(path, weights_only=True)["model"]
    sd["output_layer.2.weight"] = torch.zeros(1, 128, 5, 5)
    odd = save_checkpoint_file(str(tmp_path / "odd.pth"), sd)
    pred = SRPredictor(path, device="cpu", buckets=(8,), **KW)
    lr = (rng.random((2, 3, 4, 4)) * 4).astype(np.float32)
    before = pred.predict(lr)
    with pytest.raises(ValueError, match="previous weights keep serving"):
        pred.reload_checkpoint(odd)
    np.testing.assert_allclose(pred.predict(lr), before, rtol=0, atol=0)


def test_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, port_path = _ckpts(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        SRPredictor(port_path, **KW)
    with pytest.raises(ValueError, match="compute_dtype"):
        SRPredictor(port_path, device="cpu", **{**KW, "compute_dtype": "float16"})


def test_serving_cli(tmp_path, rng, capsys):
    _, port_path = _ckpts(tmp_path)
    lr = (rng.random((5, 3, 4, 4)) * 4).astype(np.float32)
    np.savez(tmp_path / "in.npz", LR=lr)
    torch_serving._cli([
        "--checkpoint", port_path, "--input", str(tmp_path / "in.npz"), "--output",
        str(tmp_path / "out.npz"), "--scale-factor", "4", "--pattern-layers", "1",
        "--compute-dtype", "float32", "--device", "cpu",
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 5 and report["output_shape"] == [5, 1, 16, 16]
    with np.load(tmp_path / "out.npz") as z:
        np.testing.assert_allclose(
            z["SR"], SRPredictor(port_path, device="cpu", **KW).predict(lr), rtol=0, atol=0
        )

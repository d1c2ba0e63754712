"""The SR network's training-side pieces in the port against the JAX
package, on the CPU at toy size (scale 4, 1 MSRB, 1 ResBlock): the
train-mode forward and its BatchNorm running statistics (STSR and MTSR, f32
and bf16), ``head_init``, the label preparation, the SR dataset readers and
MTSR serving through ``SRPredictor``'s ``per_seq`` fold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sr_checkpoint, toy_sr_config
from tactilesr_tpu.data.datasets import TactileSRDataset as JaxSRDataset
from tactilesr_tpu.data.datasets import TactileSRDatasetSeq as JaxSRDatasetSeq
from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.serving import SRPredictor as JaxSRPredictor
from tactilesr_tpu.tasks import sr_task as jax_sr_task
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.data import generate as torch_generate
from tactilesr_torch.data.datasets import TactileSRDataset, TactileSRDatasetSeq
from tactilesr_torch.models.tactile_sr import TactileSR
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.serving import SRPredictor
from tactilesr_torch.tasks import sr_task

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes: the suite runs several worker
    processes at once, and torch's one thread per core in each of them
    oversubscribes the CPU (this file's tests ran 20-70x slower so)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_variables(seqs_cnt, seed=0):
    model = JaxTactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                         force_feature_extra_layer_cnt=1)
    return jax.device_get(model.init(jax.random.key(seed), jnp.zeros((1, 3 * seqs_cnt, 4, 4)),
                                     train=False))


@pytest.mark.parametrize("seqs_cnt", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_forward_and_running_stats_match_jax(rng, seqs_cnt, dtype):
    """One train-mode forward from one init.  f32: output atol 1e-5 x
    max|out|, running stats atol 1e-6 (measured 3.8e-5 on 9.3 and 3.0e-7 at
    STSR).  bf16: output within 5e-2 of the output range, stats atol 1e-4
    (measured 0.13 on 9.25 and 4.6e-5: bf16 keeps 8 significant bits)."""
    variables = _jax_variables(seqs_cnt, seed=seqs_cnt)
    x = (rng.random((8, 3 * seqs_cnt, 4, 4)) * 4).astype(np.float32)
    out_j, mutated = JaxTactileSR(
        scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
        force_feature_extra_layer_cnt=1, dtype=JAX_DTYPES[dtype],
    ).apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = tactile_sr_state_dict({"params": variables["params"], "batch_stats": mutated["batch_stats"]})

    model = TactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                      force_feature_extra_layer_cnt=1, dtype=dtype)
    model.load_state_dict(tactile_sr_state_dict(variables), strict=True)
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    out_j = np.asarray(out_j)
    assert out.shape == out_j.shape == (8, 1, 16, 16) and out.dtype == np.float32
    span = float(np.abs(out_j).max())
    assert span > 0
    out_atol, stats_atol = (1e-5 * span, 1e-6) if dtype == torch.float32 else (5e-2 * span, 1e-4)
    np.testing.assert_allclose(out, out_j, rtol=0, atol=out_atol)
    got = model.state_dict()
    n_bn = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            n_bn += 1
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=stats_atol, err_msg=k)
            assert not torch.equal(got[k], torch.zeros_like(got[k])) and not torch.equal(
                got[k], torch.ones_like(got[k])), f"{k} did not move off its init"
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1
    assert n_bn == 2 * (2 * seqs_cnt + 1 + 4)  # mean and var: branches, inputContact, one MSRB


def test_head_init():
    """non_negative folds the reference draw of output_layer.2 to
    |w| / sqrt(1152) (fan_in 128 x 3 x 3); every other tensor is the
    reference draw, bit for bit.  An unknown name raises."""
    def make(head_init):
        return TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1,
                         generator=torch.Generator().manual_seed(3), head_init=head_init)

    ref, nonneg = make("reference").state_dict(), make("non_negative").state_dict()
    assert list(ref) == list(nonneg)
    for k in ref:
        if k == "output_layer.2.weight":
            assert bool((nonneg[k] >= 0).all())
            torch.testing.assert_close(nonneg[k], ref[k].abs() / 1152 ** 0.5, rtol=1e-6, atol=0)
        else:
            assert torch.equal(nonneg[k], ref[k]), k
    with pytest.raises(ValueError, match="head_init"):
        make("positive")


@pytest.mark.parametrize("hw", [100, 16])
def test_prepare_sr_labels_matches_jax(rng, tmp_path, hw):
    """100 -> 16 (scale 4) through the resize matrices, and an HR already
    at 16 x 16 (scaled only): rtol 1e-6."""
    cfg = toy_sr_config(str(tmp_path))
    hr = (rng.random((5, 1, hw, hw)) * 80).astype(np.float32)
    got = sr_task.prepare_sr_labels(hr, cfg)
    assert got.shape == (5, 1, 16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_sr_task.prepare_sr_labels(hr, cfg), rtol=1e-6, atol=0)


def _pairs(rng, n, channels):
    lr = (rng.random((n, channels, 4, 4)) * 4).astype(np.float32)
    hr = (rng.random((n, 1, 100, 100)) * 50).astype(np.float32)
    return lr, hr


@pytest.mark.parametrize("fmt", ["npz", "npy", "npy_torch"])
def test_sr_datasets_match_jax_loader(rng, tmp_path, fmt):
    """The stacked .npz, the reference's object .npy and legacy records
    holding torch tensors give exactly the JAX loader's arrays."""
    for cls, jax_cls, channels in ((TactileSRDataset, JaxSRDataset, 3),
                                   (TactileSRDatasetSeq, JaxSRDatasetSeq, 21)):
        lr, hr = _pairs(rng, 6, channels)
        name = f"SRdataset_{channels}"
        if fmt == "npz":
            path = str(tmp_path / f"{name}.npz")
            np.savez(path, LR=lr, HR=hr)
        else:
            path = str(tmp_path / f"{name}.npy")
            if fmt == "npy":
                torch_generate._save_split(str(tmp_path), name, {"LR": lr, "HR": hr}, legacy=True)
            else:
                recs = np.empty(len(lr), dtype=object)
                for i in range(len(lr)):
                    recs[i] = {"LR": torch.from_numpy(lr[i]), "HR": torch.from_numpy(hr[i])}
                np.save(path, recs, allow_pickle=True)
        a, b = cls(path).stacked()
        aj, bj = jax_cls(path).stacked()
        assert a.dtype == b.dtype == np.float32 and len(cls(path)) == 6
        np.testing.assert_array_equal(a, aj)
        np.testing.assert_array_equal(b, bj)
        np.testing.assert_array_equal(a, lr)
        np.testing.assert_array_equal(b, hr)


def test_sr_dataset_missing_names_the_port_generator(tmp_path):
    with pytest.raises(FileNotFoundError, match="tactilesr_torch.data.generate single"):
        TactileSRDataset(str(tmp_path / "none.npz"))


def test_mtsr_serving_matches_jax_per_seq(tmp_path, rng):
    """SRPredictor(seqs_cnt=7) on the per_seq fold and unfused vs the JAX
    predictor pinned to per_seq, f32, at the STSR serving test's rtol 1e-4
    / atol 1e-5, with a padded bucket."""
    jax_path = make_sr_checkpoint(tmp_path / "mtsr.ckpt", seed=5, seqs_cnt=7)
    m = jax_load(jax_path)["model"]
    port_path = save_checkpoint_file(str(tmp_path / "mtsr.pth"), tactile_sr_state_dict(
        {"params": m["params"], "batch_stats": m["batch_stats"]}))
    kw = dict(scale_factor=4, seqs_cnt=7, pattern_layers=1, force_layers=1, compute_dtype="float32",
              buckets=(1, 8))
    lr = (rng.random((5, 21, 4, 4)) * 4).astype(np.float32)
    want = JaxSRPredictor(jax_path, branch_mode="per_seq", **kw).predict(lr)
    assert float(np.abs(want).max()) > 0
    for fused in (True, False):
        got = SRPredictor(port_path, fused=fused, device="cpu", **kw).predict(lr)
        assert got.shape == (5, 1, 16, 16)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

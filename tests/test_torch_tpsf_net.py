"""Port TPSFNet and SR-dataset generation vs the JAX package, in f32 on the
CPU (the physics through its plain version, as the wrapper does there)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesr_tpu.data import generate as jax_generate
from tactilesr_tpu.data.synthetic import write_raw_blob as jax_write_raw_blob
from tactilesr_tpu.models.tpsf_net import TPSFNet as JaxTPSFNet
from tactilesr_tpu.runtime.checkpoint import save_checkpoint_file as jax_save
from tactilesr_torch.compat.from_jax import tpsf_net_state_dict
from tactilesr_torch.data import generate as torch_generate
from tactilesr_torch.data.synthetic import write_raw_blob
from tactilesr_torch.models.tpsf_net import TPSFNet
from tactilesr_torch.runtime.checkpoint import load_checkpoint_file, save_checkpoint_file

HR_TOL = dict(rtol=1e-4, atol=1e-4)
LR_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_params(seed=0):
    lr = jnp.zeros((1, 3, 4, 4))
    depth = jnp.zeros((1, 1, 100, 100))
    return jax.device_get(JaxTPSFNet().init(jax.random.key(seed), lr, depth, return_psf=False))


def _port_net(params):
    net = TPSFNet()
    net.load_state_dict(tpsf_net_state_dict(params), strict=True)
    return net.eval()


def test_tpsf_net_forward_matches_jax(rng):
    params = _jax_params()
    lr = (rng.random((3, 3, 4, 4)) * 3).astype(np.float32)
    depth = (rng.random((3, 1, 100, 100)) > 0.7).astype(np.float32)
    hr_j, deg_j, _, ab_j = JaxTPSFNet().apply(params, jnp.asarray(lr), jnp.asarray(depth),
                                              return_psf=False)
    with torch.no_grad():
        hr, deg, psf, ab = _port_net(params)(torch.from_numpy(lr), torch.from_numpy(depth),
                                             return_psf=False)
    assert psf is None and hr.shape == (3, 1, 100, 100) and ab.shape == (3, 1, 3)
    np.testing.assert_allclose(ab.numpy(), np.asarray(ab_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hr.numpy(), np.asarray(hr_j), **HR_TOL)
    np.testing.assert_allclose(deg.numpy(), np.asarray(deg_j), **LR_TOL)


def test_tpsf_net_psf_output(rng):
    params = _jax_params()
    lr = rng.random((2, 3, 4, 4)).astype(np.float32)
    depth = np.zeros((2, 1, 100, 100), np.float32)
    _, _, psf_j, _ = JaxTPSFNet().apply(params, jnp.asarray(lr), jnp.asarray(depth))
    with torch.no_grad():
        _, _, psf, _ = _port_net(params)(torch.from_numpy(lr), torch.from_numpy(depth))
    np.testing.assert_allclose(psf.numpy(), np.asarray(psf_j), rtol=1e-5, atol=1e-6)


def test_synthetic_blob_is_byte_identical(tmp_path):
    a = write_raw_blob(str(tmp_path / "a.npy"), n_taps=9, seed=4, seqs=24)
    b = jax_write_raw_blob(str(tmp_path / "b.npy"), n_taps=9, seed=4, seqs=24)
    ra, rb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    for x, y in zip(ra, rb):
        x, y = x.item(), y.item()
        assert x["sample_idx"] == y["sample_idx"]
        np.testing.assert_array_equal(x["depth"], y["depth"])
        np.testing.assert_array_equal(x["LRs"], y["LRs"])


def test_checkpoint_roundtrip_and_precision_refusal(tmp_path):
    net = TPSFNet(generator=torch.Generator().manual_seed(1))
    path = save_checkpoint_file(str(tmp_path / "t.pth"), net.state_dict(), epoch=3)
    bundle = load_checkpoint_file(path)
    assert bundle["epoch"] == 3 and bundle["num_devices"] == 1
    assert set(bundle["model"]) == {f"MLP_layer.{i}.{p}" for i in (1, 3, 5, 7) for p in ("weight", "bias")}
    for prec in ("default", "HIGH", "highest"):
        model = torch_generate.load_tpsf(path, physics_precision=prec, device="cpu")
        assert model.physics_precision == prec.lower() and model.use_kernel == "auto"
    assert torch_generate.load_tpsf(path, device="cpu", use_pallas="false").use_kernel is False
    with pytest.raises(ValueError, match="physics_precision"):
        torch_generate.load_tpsf(path, physics_precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="use_pallas_physics"):
        torch_generate.load_tpsf(path, device="cpu", use_pallas="ture")


def test_generate_single_matches_jax(tmp_path):
    """The slice end to end: both packages generate the single-frame
    SRdataset from one raw directory and one set of weights."""
    raw = tmp_path / "raw"
    write_raw_blob(str(raw / "C.npy"), n_taps=18, seed=0, seqs=24)
    params = _jax_params(seed=2)
    jax_ckpt = str(tmp_path / "tpsf.ckpt")
    jax_save(jax_ckpt, {"num_devices": 1, "model": {"params": params["params"], "batch_stats": {}},
                        "epoch": 0})
    port_ckpt = save_checkpoint_file(str(tmp_path / "tpsf.pth"), tpsf_net_state_dict(params))
    splits = {"test": [0, 6], "validation": [9, 15]}
    pj = jax_generate.generate_single_srdataset(
        jax_ckpt, str(raw), str(tmp_path / "jax"), sample_cnt=4, splits=splits,
        use_pallas=False, batch=3)
    pt = torch_generate.generate_single_srdataset(
        port_ckpt, str(raw), str(tmp_path / "torch"), sample_cnt=4, splits=splits,
        batch=3, device="cpu", legacy_npy=True)
    assert set(pj) == set(pt) == set(splits)
    for split in splits:
        with np.load(pj[split]) as zj, np.load(pt[split]) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            assert zt["LR"].shape == (8, 3, 4, 4)
            np.testing.assert_array_equal(zt["LR"], zj["LR"])
            np.testing.assert_array_equal(zt["depth"], zj["depth"])
            np.testing.assert_allclose(zt["alphaBeta"], zj["alphaBeta"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(zt["HR"], zj["HR"], **HR_TOL)
            np.testing.assert_allclose(zt["LR_degrade"], zj["LR_degrade"], **LR_TOL)
    rows = np.load(os.path.join(str(tmp_path / "torch"), "SRdataset_test.npy"), allow_pickle=True)
    assert rows[0].item()["LR"].shape == (3, 4, 4)


def test_generate_cli_synthetic_and_single(tmp_path, capsys):
    raw = str(tmp_path / "raw")
    torch_generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "--taps-per-blob", "81",
                         "--seqs", "24"])
    ckpt = save_checkpoint_file(str(tmp_path / "t.pth"), TPSFNet().state_dict())
    torch_generate._cli(["single", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir",
                         str(tmp_path / "sr"), "--sample-cnt", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "test:" in out and os.path.exists(tmp_path / "sr" / "SRdataset_test.npz")
    with pytest.raises(SystemExit):
        torch_generate._cli(["seqs"])

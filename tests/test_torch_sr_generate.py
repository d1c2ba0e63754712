"""``generate seqs`` in the port against the JAX package's
``generate_seqs_srdataset`` (its XLA physics, ``use_pallas=False``), on the
CPU at toy size: one raw directory, one set of tPSFNet weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tactilesr_tpu.data import generate as jax_generate
from tactilesr_tpu.models.tpsf_net import TPSFNet as JaxTPSFNet
from tactilesr_tpu.runtime.checkpoint import save_checkpoint_file as jax_save
from tactilesr_torch.compat.from_jax import tpsf_net_state_dict
from tactilesr_torch.data import generate as torch_generate
from tactilesr_torch.data.datasets import TactileSRDatasetSeq
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file

HR_TOL = dict(rtol=1e-4, atol=1e-4)  # as generate single's test


def test_generate_seqs_matches_jax(tmp_path, capsys):
    """2 contacts x 3 translations x 2 press depths = 12 rows, 4 per split
    (translation 0 test, 1 validation, 2 train).  LR identical, depth
    identical, HR at rtol/atol 1e-4; the legacy .npy reads back the same."""
    raw = str(tmp_path / "raw")
    torch_generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "I", "--taps-per-blob", "27",
                         "--seqs", "24"])
    params = jax.device_get(JaxTPSFNet().init(jax.random.key(2), jnp.zeros((1, 3, 4, 4)),
                                              jnp.zeros((1, 1, 100, 100)), return_psf=False))
    jax_ckpt = str(tmp_path / "tpsf.ckpt")
    jax_save(jax_ckpt, {"num_devices": 1, "model": {"params": params["params"], "batch_stats": {}},
                        "epoch": 0})
    port_ckpt = save_checkpoint_file(str(tmp_path / "tpsf.pth"), tpsf_net_state_dict(params))
    pj = jax_generate.generate_seqs_srdataset(
        jax_ckpt, raw, str(tmp_path / "jax"), sample_cnt=2, n_contacts=2, n_translations=3,
        use_pallas=False, batch=3)
    out = str(tmp_path / "torch")
    torch_generate._cli(["seqs", "--tpsf-checkpoint", port_ckpt, "--raw-dir", raw, "--out-dir", out,
                         "--sample-cnt", "2", "--n-contacts", "2", "--n-translations", "3",
                         "--batch", "3", "--legacy-npy", "--device", "cpu"])
    assert "test:" in capsys.readouterr().out
    assert sorted(pj) == ["test", "train", "validation"]
    for split in pj:
        path = os.path.join(out, f"SRdataset_{split}_32.npz")
        with np.load(pj[split]) as zj, np.load(path) as zt:
            assert sorted(zj.files) == sorted(zt.files) == ["HR", "LR", "depth"]
            assert zt["LR"].shape == (4, 21, 4, 4) and zt["HR"].shape == (4, 1, 100, 100)
            np.testing.assert_array_equal(zt["LR"], zj["LR"])
            np.testing.assert_array_equal(zt["depth"], zj["depth"])
            np.testing.assert_allclose(zt["HR"], zj["HR"], **HR_TOL)
            assert float(np.abs(zt["HR"]).max()) > 0
            lr_legacy, hr_legacy = TactileSRDatasetSeq(path[:-4] + ".npy").stacked()
            np.testing.assert_array_equal(lr_legacy, zt["LR"])
            np.testing.assert_array_equal(hr_legacy, zt["HR"])


def test_generate_seqs_frame_order(tmp_path):
    """Deepest-first: channel block 0 is the 30-degree frame at this row's
    press depth, blocks 1-6 the 25..0-degree frames at the deepest press."""
    raw = str(tmp_path / "raw")
    torch_generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "--taps-per-blob", "9",
                         "--seqs", "24"])
    from tactilesr_torch.data.datasets import TPSFNetDataset
    from tactilesr_torch.models.tpsf_net import TPSFNet

    ckpt = save_checkpoint_file(str(tmp_path / "t.pth"), TPSFNet().state_dict())
    paths = torch_generate.generate_seqs_srdataset(ckpt, raw, str(tmp_path / "s"), sample_cnt=3,
                                                   n_contacts=1, n_translations=1, device="cpu")
    assert list(paths) == ["test"]  # translation 0 only; the other splits are empty
    lr_all = TPSFNetDataset(raw, sample_cnt=3, is_sample_idx=list(range(9)),
                            is_aug_data=False).stacked()[0] / 100.0
    with np.load(paths["test"]) as z:
        lr = z["LR"]
    assert lr.shape == (3, 21, 4, 4)
    for seq in range(3):
        np.testing.assert_array_equal(lr[seq, :3], lr_all[3 * 6 + seq])
        for k, rot in enumerate(range(5, -1, -1)):
            np.testing.assert_array_equal(lr[seq, 3 * (k + 1):3 * (k + 2)], lr_all[3 * rot + 2])
    # the bf16 precision is accepted (LR rows are the same rows), a typo is not
    bf16 = torch_generate.generate_seqs_srdataset(ckpt, raw, str(tmp_path / "b"), sample_cnt=3,
                                                  n_contacts=1, n_translations=1, device="cpu",
                                                  physics_precision="default")
    with np.load(bf16["test"]) as z:
        np.testing.assert_array_equal(z["LR"], lr)
        assert np.isfinite(z["HR"]).all()
    with pytest.raises(SystemExit):
        torch_generate._cli(["seqs", "--tpsf-checkpoint", ckpt, "--raw-dir", raw, "--out-dir",
                             str(tmp_path / "x"), "--physics-precision", "bf16", "--device", "cpu"])

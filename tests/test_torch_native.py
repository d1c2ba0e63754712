"""The port's raw preprocessing against the JAX package's, on the CPU: its
native (C++) library against JAX's and against its own numpy versions (the
cases of tests/test_native.py), the ``TACTILESR_NATIVE`` switch, and
``scale_depth_by_force`` / ``load_seq_dataset_sr`` (the cases of
tests/test_data.py)."""

import numpy as np
import pytest

from tactilesr_tpu import native as jax_native
from tactilesr_tpu.data import raw_process as jax_raw
from tactilesr_tpu.data.synthetic import make_tap_record
from tactilesr_torch import native
from tactilesr_torch.data import load_seq_dataset_sr, raw_process, scale_depth_by_force
from tactilesr_torch.data.synthetic import write_raw_blob
from tactilesr_torch.ops.resize import bilinear_resize_matrix


# JAX's library is built with -march=native, which lets g++ fuse a*b + c
# into one FMA in the bilinear taps: one f32 rounding apart
JAX_NATIVE_TOL = dict(rtol=1e-6, atol=1e-6)


def test_native_builds_into_the_port(rng):
    """g++ exists here: the library builds into the port's own directory,
    and each entry point counts its calls."""
    assert native.available(), native.build_error
    lib = native._load()
    assert lib._name.startswith(native.BUILD_DIR) and "tactilesr_tpu" not in lib._name
    native.reset_calls()
    native.binarize_depth_native(rng.random((64, 64)).astype(np.float32))
    assert native.calls == {"resize_bilinear": 0, "binarize_depth": 1, "extract_contact_seqs": 0}


def test_resize_matches_matrix_path_and_jax(rng):
    src = rng.random((64, 80)).astype(np.float32)
    got = native.resize_bilinear_native(src, (100, 100))
    want = bilinear_resize_matrix(64, 100) @ src @ bilinear_resize_matrix(80, 100).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_native.resize_bilinear_native(src, (100, 100)),
                               **JAX_NATIVE_TOL)


@pytest.mark.parametrize("shape", [(100, 100), (64, 64)])
def test_binarize_matches_numpy_and_jax(rng, monkeypatch, shape):
    d = np.where(rng.random(shape) > 0.6, 4.0, 0.0).astype(np.float32)
    d += 0.05 * np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = raw_process.binarize_depth(d, 100)  # the native path
    np.testing.assert_array_equal(got, native.binarize_depth_native(d, 100))
    np.testing.assert_allclose(got, jax_native.binarize_depth_native(d, 100), **JAX_NATIVE_TOL)
    monkeypatch.setenv("TACTILESR_NATIVE", "0")
    np.testing.assert_allclose(got, raw_process.binarize_depth(d, 100), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale,cnt", [(0.1, -1), (0.3, 16), (0.3, 4), (0.9, 8)])
def test_extract_matches_numpy_and_jax(rng, monkeypatch, scale, cnt):
    rec = make_tap_record(0, rng, seqs=50)
    native.reset_calls()
    got = raw_process.extract_contact_seqs(rec["LRs"], scale, cnt)
    assert native.calls["extract_contact_seqs"] == 1
    np.testing.assert_array_equal(got, jax_native.extract_contact_seqs_native(rec["LRs"], scale, cnt))
    monkeypatch.setenv("TACTILESR_NATIVE", "0")
    want = raw_process.extract_contact_seqs(rec["LRs"], scale, cnt)
    assert native.calls["extract_contact_seqs"] == 1  # numpy ran
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dispatch_toggles(tmp_path, monkeypatch):
    """load_raw_dataset gives the same samples with the native path on and
    off, and the same as the JAX package's in both."""
    path = write_raw_blob(str(tmp_path / "X.npy"), n_taps=3, seed=5, seqs=30)
    a = raw_process.load_raw_dataset(path, sample_cnt=6, is_sample_idx=[0, 2])
    aj = jax_raw.load_raw_dataset(path, sample_cnt=6, is_sample_idx=[0, 2])
    monkeypatch.setenv("TACTILESR_NATIVE", "0")
    b = raw_process.load_raw_dataset(path, sample_cnt=6, is_sample_idx=[0, 2])
    bj = jax_raw.load_raw_dataset(path, sample_cnt=6, is_sample_idx=[0, 2])
    assert len(a) == len(b) == len(aj) == len(bj) == 12
    for sa, sb, sj, sk in zip(a, b, aj, bj):
        np.testing.assert_allclose(sa["LR"], sb["LR"], rtol=1e-6)
        np.testing.assert_allclose(sa["depth"], sb["depth"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(sa["LR"], sj["LR"])
        np.testing.assert_allclose(sa["depth"], sj["depth"], **JAX_NATIVE_TOL)
        np.testing.assert_array_equal(sb["depth"], sk["depth"])


def test_scale_depth_by_force_matches_jax():
    """depth *= sum(LR_z) * 0.01 in place (tests/test_data.py::test_scale_depth_by_force)."""
    rng = np.random.default_rng(3)
    samples = [{"LR": rng.random((3, 4, 4)).astype(np.float32),
                "depth": rng.random((100, 100)).astype(np.float32)} for _ in range(3)]
    expected = [s["depth"] * s["LR"][2].sum() * 0.01 for s in samples]
    copies = [dict(s) for s in samples]
    got = scale_depth_by_force(samples)
    want = jax_raw.scale_depth_by_force(copies)
    assert got is samples  # in place, the same list back
    for g, w, e in zip(got, want, expected):
        np.testing.assert_array_equal(g["depth"], w["depth"])
        np.testing.assert_allclose(g["depth"], e, rtol=1e-6)


@pytest.mark.parametrize("use_native", ["1", "0"])
def test_load_seq_dataset_sr_matches_jax(tmp_path, monkeypatch, use_native):
    """The rot0/rot30 pairs over the 9-position grid (36 taps), as
    tests/test_data.py::test_load_seq_dataset_sr, row for row against JAX."""
    monkeypatch.setenv("TACTILESR_NATIVE", use_native)
    path = write_raw_blob(str(tmp_path / "G.npy"), n_taps=36, seed=9, seqs=30)
    out = load_seq_dataset_sr(path, sample_cnt=4)
    want = jax_raw.load_seq_dataset_sr(path, sample_cnt=4)
    assert len(out) == len(want) > 0
    assert out[0]["LR_0"].shape == (3, 4, 4) and out[0]["LR_1"].shape == (3, 4, 4)
    assert out[0]["depth"].shape == (100, 100)
    for row, ref in zip(out, want):
        assert sorted(row) == sorted(ref) == ["LR_0", "LR_1", "depth"]
        for k in row:
            np.testing.assert_array_equal(row[k], ref[k])

"""The MTSR branch layouts of the port's fused serving graph
(``tactilesr_torch/models/inference.py``, rewrite 4), the ``auto`` of
``SRPredictor``, ``export_program`` and the serving CLI's
``--branch-mode`` and ``--evaluate``, on the CPU at toy size (scale 4, 1-2
MSRB, S=3 and S=7).

Tolerances: a layout against JAX's same layout on the same weights, f32,
rtol 1e-4 / atol 1e-5 (f32 convolutions in another order); a batched layout
against the port's ``per_seq``, and an exported program against the
forward it was made from, rtol 1e-5 / atol 1e-5; PSNR and SSIM against
the JAX CLI's arithmetic within 1e-4."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sr_checkpoint
from tactilesr_tpu.metrics import batched_psnr as jax_psnr
from tactilesr_tpu.metrics import batched_ssim as jax_ssim
from tactilesr_tpu.models import inference as jax_inference
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.runtime.checkpoint import save_checkpoint_file as jax_save
from tactilesr_tpu.serving import SRPredictor as JaxSRPredictor
from tactilesr_tpu.tasks.sr_task import prepare_sr_labels as jax_prepare_sr_labels
from tactilesr_torch import serving
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.models.inference import (
    BRANCH_MODES,
    fold_inference_params,
    resolve_branch_mode,
    tactile_sr_infer,
)
from tactilesr_torch.models.tactile_sr import TactileSR, TactileSRCNN
from tactilesr_torch.runtime.checkpoint import save_checkpoint_file
from tactilesr_torch.serving import SRPredictor, export_program

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
SAME_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = dict(scale_factor=4, force_layers=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _variables(tmp_path, seqs_cnt, pattern_layers, seed=0):
    """Random-init JAX TactileSR variables with BN running statistics drawn
    off their init, so the fold reads real statistics."""
    path = make_sr_checkpoint(tmp_path / f"s{seqs_cnt}_{pattern_layers}_{seed}.ckpt", seed=seed,
                              seqs_cnt=seqs_cnt, pattern_layers=pattern_layers)
    m = jax_load(path)["model"]
    rng = np.random.default_rng(100 + seed)

    def draw(p, a):
        if p[-1].key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": m["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(draw, m["batch_stats"])}


def _bundles(tmp_path, seqs_cnt, pattern_layers, seed=0):
    """The same weights as a JAX ``.ckpt`` and a port ``.pth``."""
    v = _variables(tmp_path, seqs_cnt, pattern_layers, seed)
    stem = str(tmp_path / f"b{seqs_cnt}_{pattern_layers}_{seed}")
    jax_save(stem + ".ckpt", {"num_devices": 1, "model": v, "epoch": 0})
    return v, stem + ".ckpt", save_checkpoint_file(stem + ".pth", tactile_sr_state_dict(v))


def _frames(seed, n, seqs_cnt):
    return (np.random.default_rng(seed).random((n, 3 * seqs_cnt, 4, 4)) * 4).astype(np.float32)


@pytest.mark.parametrize("mode", ["dense", "grouped", "mixed"])
@pytest.mark.parametrize("seqs_cnt,pattern_layers", [(3, 1), (7, 2)])
def test_branch_mode_matches_jax_and_per_seq(tmp_path, seqs_cnt, pattern_layers, mode):
    v = _variables(tmp_path, seqs_cnt, pattern_layers)
    sd = tactile_sr_state_dict(v)
    x = _frames(1, 5, seqs_cnt)
    kw = dict(ARCH, seqs_cnt=seqs_cnt, pattern_layers=pattern_layers)
    jf = jax_inference.fold_inference_params(v, seqs_cnt=seqs_cnt, pattern_layers=pattern_layers,
                                             dtype=jnp.float32, branch_mode=mode)
    want = np.asarray(jax_inference.tactile_sr_infer(jf, jnp.asarray(x), branch_mode=mode, **kw))

    def port(m):
        folded = fold_inference_params(sd, seqs_cnt=seqs_cnt, pattern_layers=pattern_layers,
                                       dtype=torch.float32, branch_mode=m)
        return tactile_sr_infer(folded, torch.from_numpy(x), branch_mode=m, **kw).numpy()

    got = port(mode)
    assert got.shape == (5, 1, 16, 16) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **JAX_TOL)
    np.testing.assert_allclose(got, port("per_seq"), **SAME_TOL)


@pytest.mark.parametrize("seqs_cnt", [3, 7])
def test_fold_structure(tmp_path, seqs_cnt):
    """Dense kernels are block-diagonal with every off-diagonal tap exactly
    zero; the grouped kernel is the dense diagonal, compacted; mixed is
    dense k0 and grouped k1; the branch fuse is the unsplit 64S->64 kernel
    (the per_seq split, concatenated)."""
    sd = tactile_sr_state_dict(_variables(tmp_path, seqs_cnt, 1))
    fold = {m: fold_inference_params(sd, seqs_cnt=seqs_cnt, pattern_layers=1, dtype=torch.float32,
                                     branch_mode=m) for m in BRANCH_MODES}
    s = seqs_cnt
    assert fold["dense"]["branches/k0"].shape == (64 * s, 3 * s, 3, 3)
    assert fold["dense"]["branches/k1"].shape == (64 * s, 64 * s, 3, 3)
    assert fold["grouped"]["branches/k0"].shape == (64 * s, 3, 3, 3)
    assert fold["grouped"]["branches/k1"].shape == (64 * s, 64, 3, 3)
    for idx, ci in ((0, 3), (1, 64)):
        dense, grouped = fold["dense"][f"branches/k{idx}"], fold["grouped"][f"branches/k{idx}"]
        mask = torch.zeros_like(dense, dtype=torch.bool)
        for b in range(s):
            mask[64 * b:64 * (b + 1), ci * b:ci * (b + 1)] = True
            torch.testing.assert_close(dense[64 * b:64 * (b + 1), ci * b:ci * (b + 1)],
                                       grouped[64 * b:64 * (b + 1)], rtol=0, atol=0)
            per_seq = fold["per_seq"][f"inputLayer_pattern_{b}_conv{idx}/k"]
            torch.testing.assert_close(grouped[64 * b:64 * (b + 1)], per_seq, rtol=0, atol=0)
        assert torch.count_nonzero(dense[~mask]) == 0
        np.testing.assert_array_equal(fold["grouped"][f"branches/b{idx}"].numpy(),
                                      fold["dense"][f"branches/b{idx}"].numpy())
    torch.testing.assert_close(fold["mixed"]["branches/k0"], fold["dense"]["branches/k0"], rtol=0, atol=0)
    torch.testing.assert_close(fold["mixed"]["branches/k1"], fold["grouped"]["branches/k1"], rtol=0, atol=0)
    split = torch.cat([fold["per_seq"][f"inputContact/k{b}"] for b in range(s)], dim=1)
    for m in ("dense", "grouped", "mixed"):
        assert fold[m]["inputContact/k"].shape == (64, 64 * s, 3, 3)
        torch.testing.assert_close(fold[m]["inputContact/k"], split, rtol=0, atol=0)
        assert not any(k.startswith("inputLayer_pattern") for k in fold[m])


@pytest.mark.parametrize("mode,seqs_cnt,want", [
    ("auto", 1, "per_seq"), ("auto", 7, "grouped"), ("per_seq", 7, "per_seq"),
    ("dense", 3, "dense"), ("grouped", 1, "grouped"), ("mixed", 7, "mixed"),
])
def test_resolve_branch_mode(mode, seqs_cnt, want):
    assert resolve_branch_mode(mode, seqs_cnt) == want
    assert jax_inference.resolve_branch_mode(mode, seqs_cnt) == want


def test_resolve_branch_mode_refuses_unknown(tmp_path):
    with pytest.raises(ValueError, match="branch_mode"):
        resolve_branch_mode("blocked", 7)
    _, _, path = _bundles(tmp_path, 3, 1)
    with pytest.raises(ValueError, match="branch_mode"):
        SRPredictor(path, seqs_cnt=3, pattern_layers=1, device="cpu", branch_mode="blocked", **ARCH)


def test_predictor_auto_serves_grouped(tmp_path):
    """``auto`` on a fused MTSR folds and serves the ``grouped`` layout at
    every bucket; its output equals per_seq's and JAX's (pinned to
    per_seq).  A hot swap refolds it; a bundle that does not fit is refused
    and the old weights keep serving."""
    _, jax_a, a = _bundles(tmp_path, 3, 1, seed=0)
    _, _, b = _bundles(tmp_path, 3, 1, seed=1)
    kw = dict(ARCH, seqs_cnt=3, pattern_layers=1, compute_dtype="float32", buckets=(4, 8, 16),
              device="cpu")
    pred = SRPredictor(a, **kw)
    assert pred.branch_mode == "grouped"
    assert pred._weights["branches/k1"].shape == (64 * 3, 64, 3, 3)
    assert not any(k.startswith("inputLayer_pattern") for k in pred._weights)
    x = _frames(2, 27, 3)  # 16 + 8 + 3 (padded to 4): every bucket serves
    np.testing.assert_array_equal(pred.predict(x), SRPredictor(a, branch_mode="grouped", **kw).predict(x))
    per_seq = SRPredictor(a, branch_mode="per_seq", **kw)
    np.testing.assert_allclose(pred.predict(x), per_seq.predict(x), **SAME_TOL)
    jax_kw = {k: v for k, v in kw.items() if k != "device"}
    np.testing.assert_allclose(pred.predict(x), JaxSRPredictor(jax_a, branch_mode="per_seq",
                                                               **jax_kw).predict(x), **JAX_TOL)

    pred.reload_checkpoint(b)
    np.testing.assert_array_equal(pred.predict(x), SRPredictor(b, branch_mode="grouped", **kw).predict(x))

    served = pred.predict(x)
    sd = torch.load(b, weights_only=True)["model"]
    odd_branch = dict(sd, **{"inputLayer_pattern_list.1.1.weight": torch.zeros(64, 3, 5, 5)})
    odd_head = dict(sd, **{"output_layer.2.weight": torch.zeros(1, 128, 5, 5)})
    for name, bad in (("odd_branch", odd_branch), ("odd_head", odd_head)):
        path = save_checkpoint_file(str(tmp_path / f"{name}.pth"), bad)
        with pytest.raises(ValueError):
            pred.reload_checkpoint(path)
        np.testing.assert_array_equal(pred.predict(x), served)
    # the per_seq layout folds the odd branch; its fingerprint refuses it
    with pytest.raises(ValueError, match="previous weights keep serving"):
        per_seq.reload_checkpoint(str(tmp_path / "odd_branch.pth"))


def test_predictor_auto_resolves_per_arch(tmp_path):
    """``auto`` is ``resolve_branch_mode``'s: per_seq for an STSR, grouped
    for an MTSR, fused or not; an explicit mode pins the layout."""
    _, _, stsr = _bundles(tmp_path, 1, 1)
    _, _, mtsr = _bundles(tmp_path, 3, 1)
    kw = dict(ARCH, pattern_layers=1, compute_dtype="float32", buckets=(4, 8), device="cpu")
    assert SRPredictor(stsr, **kw).branch_mode == "per_seq"
    assert SRPredictor(mtsr, seqs_cnt=3, **kw).branch_mode == "grouped"
    assert SRPredictor(mtsr, seqs_cnt=3, fused=False, **kw).branch_mode == "grouped"
    pinned = SRPredictor(mtsr, seqs_cnt=3, branch_mode="dense", **kw)
    assert pinned.branch_mode == "dense"
    assert pinned._weights["branches/k1"].shape == (64 * 3, 64 * 3, 3, 3)


def _cnn_bundle(tmp_path):
    g = torch.Generator().manual_seed(3)
    m = TactileSRCNN(scale_factor=4, msrb_cnt=1, generator=g)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.3 * torch.randn(mod.num_features, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.num_features, generator=g))
    return save_checkpoint_file(str(tmp_path / "cnn.pth"), m.state_dict())


@pytest.mark.parametrize("case", ["stsr", "stsr_unfused", "mtsr_grouped", "cnn"])
def test_export_program_round_trip(tmp_path, case):
    """The saved program, reloaded, gives the output of the forward the
    predictor serves at that bucket; it owns every weight as a buffer or
    parameter, and its one lifted constant is the resize matrix."""
    seqs_cnt = 3 if case == "mtsr_grouped" else 1
    if case == "cnn":
        path = _cnn_bundle(tmp_path)
        kw = dict(scale_factor=4, pattern_layers=1, model_arch="TactileSRCNN")
    else:
        path = _bundles(tmp_path, seqs_cnt, 1)[2]
        kw = dict(ARCH, seqs_cnt=seqs_cnt, pattern_layers=1, fused=case != "stsr_unfused",
                  branch_mode="grouped" if case == "mtsr_grouped" else "auto")
    kw.update(compute_dtype="float32", device="cpu")
    out = export_program(path, str(tmp_path / "p.pt2"), batch=4, **kw)
    program = torch.export.load(out)
    assert [tuple(c.shape) for c in program.constants.values()] == [(16, 4)]
    x = _frames(5, 4, seqs_cnt)
    got = program.module()(torch.from_numpy(x)).numpy()
    want = SRPredictor(path, buckets=(4,), **kw).predict(x)
    assert got.shape == (4, 1, 16, 16) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **SAME_TOL)
    if case == "stsr_unfused":  # the eval model itself
        model = TactileSR(seqs_cnt=1, pattern_feature_extra_layer_cnt=1,
                          force_feature_extra_layer_cnt=1, scale_factor=4)
        model.load_state_dict(torch.load(path, weights_only=True)["model"])
        with torch.no_grad():
            np.testing.assert_allclose(got, model.eval()(torch.from_numpy(x)).numpy(), **SAME_TOL)


@pytest.mark.parametrize("mode", ["per_seq", "dense", "grouped", "mixed"])
def test_cli_branch_mode(tmp_path, capsys, mode):
    _, _, path = _bundles(tmp_path, 3, 1)
    x = _frames(6, 6, 3)
    np.savez(tmp_path / "in.npz", LR=x)
    serving._cli(["--checkpoint", path, "--input", str(tmp_path / "in.npz"), "--output",
                  str(tmp_path / "out.npz"), "--seqs-cnt", "3", "--scale-factor", "4",
                  "--pattern-layers", "1", "--compute-dtype", "float32", "--device", "cpu",
                  "--branch-mode", mode])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["branch_mode"] == mode and "psnr_db" not in report
    want = SRPredictor(path, seqs_cnt=3, pattern_layers=1, compute_dtype="float32", device="cpu",
                       branch_mode="per_seq", **ARCH).predict(x)
    with np.load(tmp_path / "out.npz") as z:
        np.testing.assert_allclose(z["SR"], want, **SAME_TOL)


def test_cli_evaluate_matches_jax(tmp_path, capsys):
    """``--evaluate`` reports PSNR and SSIM against the input's HR, as the
    JAX CLI computes them (``tactilesr_tpu/serving.py``'s ``--evaluate``
    branch, on the JAX predictor's output for the same weights)."""
    _, jax_path, path = _bundles(tmp_path, 1, 1)
    rng = np.random.default_rng(7)
    lr = _frames(7, 9, 1)
    hr = (40.0 * rng.random((9, 1, 100, 100))).astype(np.float32)
    np.savez(tmp_path / "test.npz", LR=lr, HR=hr)
    argv = ["--checkpoint", path, "--input", str(tmp_path / "test.npz"), "--scale-factor", "4",
            "--pattern-layers", "1", "--compute-dtype", "float32", "--device", "cpu", "--evaluate",
            "--hr-scale-num", "8", "--max-value", "50"]
    serving._cli(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    sr = JaxSRPredictor(jax_path, scale_factor=4, pattern_layers=1, force_layers=1,
                        compute_dtype="float32").predict(lr)
    label = jax_prepare_sr_labels(hr, {"scale_factor": 4, "HR_scale_num": 8.0})
    psnr = float(np.asarray(jax_psnr(jnp.asarray(sr[:, 0]), jnp.asarray(label[:, 0]), 50.0)).mean())
    ssim = float(np.asarray(jax_ssim(jnp.asarray(sr[:, 0]), jnp.asarray(label[:, 0]))).mean())
    assert abs(report["psnr_db"] - psnr) <= 1e-4
    assert abs(report["ssim"] - ssim) <= 1e-4
    serving._cli(argv[:-5])  # without --evaluate: no metrics
    assert "psnr_db" not in json.loads(capsys.readouterr().out.strip().splitlines()[-1])

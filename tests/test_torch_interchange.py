"""Checkpoint interchange between the port and the JAX package, and the
reference's ``.pth`` forms: the port's flax-msgpack codec
(``runtime/checkpoint.py::read_ckpt``/``write_ckpt``) against flax byte for
byte, JAX ``.ckpt`` files loaded and served by the port, port files loaded
by JAX, both packages' converters from one ``.pth``, and the weights-only
default with its ``allow_pickle`` opt-in.  Forwards in f32 at rtol 1e-4 /
atol 1e-5 on the CPU."""

import os
import subprocess
import sys

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_toy_trainer, toy_sr_config, toy_sr_data
from tactilesr_tpu.compat.torch_convert import convert_checkpoint_file as jax_convert
from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR
from tactilesr_tpu.models.tactile_sr import TactileSRCNN as JaxTactileSRCNN
from tactilesr_tpu.models.tpsf_net import TPSFNet as JaxTPSFNet
from tactilesr_tpu.runtime.checkpoint import load_checkpoint_file as jax_load
from tactilesr_tpu.runtime.checkpoint import save_checkpoint_file as jax_save
from tactilesr_torch.compat import export_torch, torch_convert
from tactilesr_torch.models.tactile_sr import TactileSR, TactileSRCNN
from tactilesr_torch.models.tpsf_net import TPSFNet
from tactilesr_torch.runtime import checkpoint as ck
from tactilesr_torch.runtime.history import MetricStorage
from tactilesr_torch.serving import SRPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread at these toy shapes (the suite runs several
    worker processes at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _assert_trees_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if hasattr(x, "shape") or hasattr(y, "shape"):
            xa = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            ya = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            assert xa.dtype == ya.dtype and xa.shape == ya.shape, k
            np.testing.assert_array_equal(xa, ya, err_msg=k)
        else:
            assert x == y, k


# ------------------------------------------------------------------ codec
def _tree(rng):
    return {
        "model": {"params": {"w": rng.random((3, 4)).astype(np.float32),
                             "i": np.arange(6, dtype=np.int32).reshape(2, 3)},
                  "batch_stats": {}},
        "epoch": 3, "lr": 1e-3, "name": "x", "flag": True, "none": None,
        "list": [1, 2.5, "a"], "np_scalar": np.float32(0.25), "np_int": np.int64(7),
        "complex": 1.5 - 2j, "optimizer": {"0": {"count": np.int32(4)}, "1": {}},
    }


def test_write_ckpt_is_flax_byte_for_byte(tmp_path, rng):
    """Scalars, strings, lists, None, numpy arrays and scalars, a complex:
    the port writes the bytes flax writes, and reads them back as flax."""
    tree = _tree(rng)
    path = ck.write_ckpt(str(tmp_path / "t.ckpt"), tree)
    with open(path, "rb") as f:
        assert f.read() == flax_ser.msgpack_serialize(tree)
    _assert_trees_equal(ck.read_ckpt(path), flax_ser.msgpack_restore(flax_ser.msgpack_serialize(tree)))


def test_torch_leaves_write_as_their_numpy_twins(tmp_path, rng):
    a = rng.random((5, 2)).astype(np.float32)
    path = ck.write_ckpt(str(tmp_path / "t.ckpt"), {"a": torch.from_numpy(a), "b": 1})
    with open(path, "rb") as f:
        assert f.read() == flax_ser.msgpack_serialize({"a": a, "b": 1})


def test_bf16_leaf(tmp_path, rng):
    """A bf16 leaf written by flax reads as a torch bf16 tensor of the same
    values, and writes back to flax's bytes."""
    x = jnp.asarray(rng.random((3, 5)), dtype=jnp.bfloat16)
    data = flax_ser.msgpack_serialize({"w": x, "s": x[0, 0]})
    src = tmp_path / "b.ckpt"
    src.write_bytes(data)
    got = ck.read_ckpt(str(src))
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (3, 5)
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(x, np.float32))
    assert float(got["s"]) == float(np.asarray(x[0, 0], np.float32))
    out = ck.write_ckpt(str(tmp_path / "back.ckpt"), got)
    with open(out, "rb") as f:
        assert f.read() == data


def test_chunked_arrays(tmp_path, rng, monkeypatch):
    """An array over MAX_CHUNK_SIZE: flax writes it as flat chunks and the
    port reads it whole; the port chunks as flax does."""
    big = rng.random((9, 7)).astype(np.float32)  # 252 B, 4 chunks of 64 B
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    data = flax_ser.msgpack_serialize({"p": {"big": big, "small": np.ones(2, np.float32)}})
    assert b"__msgpack_chunked_array__" in data
    src = tmp_path / "c.ckpt"
    src.write_bytes(data)
    got = ck.read_ckpt(str(src))
    np.testing.assert_array_equal(got["p"]["big"], big)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    out = ck.write_ckpt(str(tmp_path / "mine.ckpt"), {"p": {"big": big, "small": np.ones(2, np.float32)}})
    with open(out, "rb") as f:
        assert f.read() == data


def test_unknown_ext_type_raises(tmp_path):
    import msgpack

    path = tmp_path / "x.ckpt"
    path.write_bytes(msgpack.packb({"a": msgpack.ExtType(9, b"zz")}))
    with pytest.raises(ValueError, match="ext type 9"):
        ck.read_ckpt(str(path))


def test_tuples_raise_as_in_flax(tmp_path):
    with pytest.raises(TypeError):
        ck.write_ckpt(str(tmp_path / "t.ckpt"), {"a": (1, 2)})


# ---------------------------------------------------- JAX .ckpt -> port
def _mtsr_data(rng, n=16, seqs=7):
    lr = (rng.random((n, 3 * seqs, 4, 4)) * 4).astype(np.float32)
    hr = np.repeat(np.repeat(lr[:, 2:3], 25, axis=2), 25, axis=3).astype(np.float32)
    return lr, hr


@pytest.mark.parametrize("seqs", [1, 7])
def test_jax_trainer_ckpt_serves_in_the_port(tmp_path, rng, seqs):
    """A JAX SRTrainer (STSR or MTSR, toy widths, f32) trains one epoch and
    writes ``latest.ckpt`` (weights, optax state, schedule, metrics); the
    port reads it, drops the optimizer state, and its eval forward and
    ``SRPredictor`` match JAX's eval forward on the same file."""
    lr, hr = toy_sr_data(rng, n=16) if seqs == 1 else _mtsr_data(rng)
    cfg = toy_sr_config(str(tmp_path), seqsCnt=seqs, head_init="non_negative")
    tj = make_toy_trainer(cfg, lr, hr, max_epochs=1)
    tj.train(auto_resume=False)
    path = os.path.join(tj.ckpt_dir, "latest.ckpt")
    assert "optimizer" in jax_load(path)
    bundle = ck.load_checkpoint_file(path)
    assert bundle["epoch"] == 0 and bundle["num_devices"] == jax.device_count()
    assert set(bundle) == {"model", "epoch", "num_devices", "num_processes", "step"}
    model = TactileSR(scale_factor=4, seqs_cnt=seqs, pattern_feature_extra_layer_cnt=1,
                      force_feature_extra_layer_cnt=1)
    model.load_state_dict(bundle["model"], strict=True)
    x = lr[:5]
    want = np.asarray(tj.model_apply(jnp.asarray(x), train=False))
    assert want.max() > 0
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    pred = SRPredictor(path, scale_factor=4, seqs_cnt=seqs, pattern_layers=1, compute_dtype="float32",
                       buckets=(8,), device="cpu")
    np.testing.assert_allclose(pred.predict(x), want, **TOL)


def test_jax_cnn_and_tpsf_ckpts_load_in_the_port(tmp_path, rng):
    """TactileSRCNN and tPSFNet bundles written by JAX's
    ``save_checkpoint_file``: the port tells the architecture from the
    tree, and its forwards match JAX's."""
    jcnn = JaxTactileSRCNN(scale_factor=4, msrb_cnt=1, head_init="non_negative")
    v = jax.device_get(jcnn.init(jax.random.key(1), jnp.zeros((1, 3, 4, 4)), train=False))
    jax_save(str(tmp_path / "cnn.ckpt"), {"model": dict(v), "epoch": 2, "num_devices": 1})
    cnn = TactileSRCNN(scale_factor=4, msrb_cnt=1)
    cnn.load_state_dict(ck.load_checkpoint_file(str(tmp_path / "cnn.ckpt"))["model"], strict=True)
    x = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
    want = np.asarray(jcnn.apply(v, jnp.asarray(x), train=False))
    assert want.max() > 0
    with torch.no_grad():
        np.testing.assert_allclose(cnn.eval()(torch.from_numpy(x)).numpy(), want, **TOL)

    jnet = JaxTPSFNet()
    depth = (rng.random((3, 1, 100, 100)) > 0.7).astype(np.float32)
    p = jax.device_get(jnet.init(jax.random.key(2), jnp.zeros((1, 3, 4, 4)), jnp.zeros((1, 1, 100, 100)),
                                 return_psf=False))
    jax_save(str(tmp_path / "tpsf.ckpt"), {"model": {"params": p["params"], "batch_stats": {}},
                                           "epoch": 0, "num_devices": 1})
    net = TPSFNet()
    net.load_state_dict(ck.load_checkpoint_file(str(tmp_path / "tpsf.ckpt"))["model"], strict=True)
    _, _, _, ab_j = jnet.apply(p, jnp.asarray(x), jnp.asarray(depth), return_psf=False)
    with torch.no_grad():
        _, _, _, ab = net.eval()(torch.from_numpy(x), torch.from_numpy(depth), return_psf=False)
    np.testing.assert_allclose(ab.numpy(), np.asarray(ab_j), **TOL)


def test_bf16_params_in_a_jax_ckpt(tmp_path):
    """bf16 leaves in a JAX tree become f32 tensors of the same values."""
    model = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1)
    tree = torch_convert.convert_tactile_sr(model.state_dict(), pattern_layers=1)
    k = tree["params"]["output_conv1"]["conv"]["kernel"]
    tree["params"]["output_conv1"]["conv"]["kernel"] = jnp.asarray(k, dtype=jnp.bfloat16)
    jax_save(str(tmp_path / "b.ckpt"), {"model": tree, "epoch": 0, "num_devices": 1})
    sd = ck.load_checkpoint_file(str(tmp_path / "b.ckpt"))["model"]
    want = model.state_dict()["output_layer.2.weight"].to(torch.bfloat16).float()
    assert sd["output_layer.2.weight"].dtype == torch.float32
    assert torch.equal(sd["output_layer.2.weight"], want)


# ---------------------------------------------------- port -> JAX .ckpt
def _port_models():
    g = torch.Generator().manual_seed(3)
    return {
        "tactileSR": (TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=2, generator=g,
                                head_init="non_negative"), dict(pattern_layers=2)),
        "tactileSRCNN": (TactileSRCNN(scale_factor=4, msrb_cnt=1, generator=g, head_init="non_negative"),
                         dict(msrb_cnt=1)),
        "tPSFNet": (TPSFNet(generator=g), {}),
    }


def _perturb_bn(model):
    """Running statistics away from their init, so the conversion of each
    one shows in the forward."""
    g = torch.Generator().manual_seed(5)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(1 + 0.2 * torch.rand(m.running_var.shape, generator=g))
            m.num_batches_tracked.fill_(17)


@pytest.mark.parametrize("arch", ["tactileSR", "tactileSRCNN", "tPSFNet"])
def test_port_ckpt_loads_in_jax(tmp_path, rng, arch):
    """A port ``.pth`` -> ``.ckpt`` (the port's converter) -> JAX's
    ``load_checkpoint_file``: JAX's forward on that file matches the
    port's; JAX's own converter from the same ``.pth`` gives the same
    tree, leaf for leaf; and the port's export brings the weights back."""
    model, kw = _port_models()[arch]
    _perturb_bn(model)
    pth = ck.save_checkpoint_file(str(tmp_path / "m.pth"), model.state_dict(), epoch=4)
    mine = torch_convert.convert_checkpoint_file(pth, str(tmp_path / "mine.ckpt"), arch=arch, **kw)
    jax_kw = kw if arch == "tactileSR" else ({"msrb_cnt": 1} if arch == "tactileSRCNN" else {})
    theirs = jax_convert(pth, str(tmp_path / "theirs.ckpt"), arch=arch, **jax_kw)
    _assert_trees_equal(jax_load(mine), jax_load(theirs))
    variables = jax_load(mine)["model"]
    x = (rng.random((3, 3, 4, 4)) * 4).astype(np.float32)
    if arch == "tPSFNet":
        depth = (rng.random((3, 1, 100, 100)) > 0.7).astype(np.float32)
        want = JaxTPSFNet().apply({"params": variables["params"]}, jnp.asarray(x), jnp.asarray(depth),
                                  return_psf=False)[3]
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x), torch.from_numpy(depth), return_psf=False)[3]
    else:
        jm = (JaxTactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=2) if arch == "tactileSR"
              else JaxTactileSRCNN(scale_factor=4, msrb_cnt=1))
        want = jm.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))
        assert np.asarray(want).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    back = export_torch.export_checkpoint_file(mine, str(tmp_path / "back.pth"), arch=arch)
    sd = ck.load_checkpoint_file(back)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], torch.zeros_like(v) if k.endswith("num_batches_tracked") else v), k


# ---------------------------------------------------- reference .pth forms
def _ref_forms(tmp_path):
    """The reference's .pth forms (tests/test_reference_parity.py's cases),
    with the port's TPSFNet standing in for the reference module: name ->
    (path, needs the pickle opt-in)."""
    net = TPSFNet(generator=torch.Generator().manual_seed(7))
    sd = net.state_dict()
    forms = {
        "bare_state_dict": (sd, False),
        "model_state_dict_bundle": ({"model": sd, "epoch": 3, "num_gpus": 1}, False),
        "model_module_bundle": ({"model": net, "epoch": 3}, True),
        "bare_module": (net, True),
        "trainer_bundle": ({"num_gpus": 1, "model": sd, "optimizer": {"state": {}, "param_groups": []},
                            "metric_storage": MetricStorage(), "epoch": 5}, True),
    }
    out = {}
    for name, (obj, pickled) in forms.items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        out[name] = (path, pickled)
    return net, out


@pytest.mark.parametrize("form", ["bare_state_dict", "model_state_dict_bundle", "model_module_bundle",
                                  "bare_module", "trainer_bundle"])
def test_reference_pth_forms(tmp_path, form):
    """Each form loads to the module's state_dict; the pickled ones only
    with ``allow_pickle=True``, and without it the error names the opt-in."""
    net, forms = _ref_forms(tmp_path)
    path, pickled = forms[form]
    if pickled:
        with pytest.raises(ValueError, match="allow_pickle=True.*--allow-pickle"):
            ck.load_checkpoint_file(path)
    bundle = ck.load_checkpoint_file(path, allow_pickle=pickled)
    want = net.state_dict()
    assert set(bundle["model"]) == set(want)
    for k in want:
        assert torch.equal(bundle["model"][k], want[k])


def test_not_a_checkpoint_raises(tmp_path):
    torch.save({"epoch": 1}, str(tmp_path / "x.pth"))
    with pytest.raises(ValueError, match="not a checkpoint"):
        ck.load_checkpoint_file(str(tmp_path / "x.pth"))


def test_pickled_bundle_through_predictor_and_converter(tmp_path, rng):
    """``SRPredictor(allow_pickle=True)`` serves a ``{'model': nn.Module}``
    bundle as its state_dict, and the converter takes the opt-in too."""
    model = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1,
                      generator=torch.Generator().manual_seed(2), head_init="non_negative")
    path = str(tmp_path / "mod.pth")
    torch.save({"model": model}, path)
    kw = dict(scale_factor=4, pattern_layers=1, compute_dtype="float32", buckets=(4,), device="cpu")
    with pytest.raises(ValueError, match="allow_pickle"):
        SRPredictor(path, **kw)
    x = (rng.random((4, 3, 4, 4)) * 4).astype(np.float32)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(SRPredictor(path, allow_pickle=True, **kw).predict(x), want, **TOL)
    out = torch_convert.convert_checkpoint_file(path, str(tmp_path / "m.ckpt"), allow_pickle=True,
                                                pattern_layers=1)
    assert set(jax_load(out)["model"]["params"]) >= {"inputContact_layer", "output_conv1"}


# ---------------------------------------------------- mismatches
def test_architecture_mismatch_raises(tmp_path):
    """A converter declared with fewer MSRBs than trained fails and writes
    nothing; the export refuses a tree of another architecture; a served
    ``.ckpt`` of 2 MSRBs does not fit a 1-MSRB predictor."""
    model = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=2)
    pth = ck.save_checkpoint_file(str(tmp_path / "two.pth"), model.state_dict())
    with pytest.raises(ValueError, match="patternFeatureExtra_layer.1"):
        torch_convert.convert_checkpoint_file(pth, str(tmp_path / "bad.ckpt"), pattern_layers=1)
    assert not (tmp_path / "bad.ckpt").exists()
    ckpt = torch_convert.convert_checkpoint_file(pth, str(tmp_path / "ok.ckpt"), pattern_layers=2)
    with pytest.raises(ValueError, match="holds a tactileSR parameter tree, not tPSFNet"):
        export_torch.export_checkpoint_file(ckpt, str(tmp_path / "x.pth"), arch="tPSFNet")
    with pytest.raises(ValueError, match="does not consume.*patternFeatureExtra_layer.1"):
        SRPredictor(ckpt, scale_factor=4, pattern_layers=1, device="cpu")


# ---------------------------------------------------- CLIs
def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_clis(tmp_path):
    """``python -m tactilesr_torch.compat.torch_convert`` (with
    ``--allow-pickle`` for a pickled bundle, and refusing it without) and
    ``python -m tactilesr_torch.compat.export_torch``, end to end."""
    model = TactileSR(scale_factor=4, pattern_feature_extra_layer_cnt=1,
                      generator=torch.Generator().manual_seed(4))
    pth, ckpt, back = (str(tmp_path / n) for n in ("m.pth", "m.ckpt", "back.pth"))
    torch.save({"model": model, "epoch": 1}, pth)
    args = ("tactilesr_torch.compat.torch_convert", pth, ckpt, "--arch", "tactileSR",
            "--seqs-cnt", "1", "--pattern-layers", "1", "--force-layers", "1")
    refused = _run(*args)
    assert refused.returncode != 0 and "--allow-pickle" in refused.stderr
    done = _run(*args, "--allow-pickle")
    assert done.returncode == 0, done.stderr
    assert _run("tactilesr_torch.compat.export_torch", ckpt, back, "--arch", "tactileSR").returncode == 0
    sd = ck.load_checkpoint_file(back)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], torch.zeros_like(v) if k.endswith("num_batches_tracked") else v), k

"""The physics bench and the entry points on the CPU: the bound helpers
and FLOP counts of ``tactilesr_torch/bench.py`` (pinned to PERF.md's
figures, to a forward-hook count and to perfbench's frozen copies), the
bench's refusals (``--tile``, a run without a card, a wrapper that
launched nothing), the flagship entry against JAX's
``__graft_entry__.entry()``, and the command index."""

import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR
from tactilesr_torch import bench, graft_entry
from tactilesr_torch.__main__ import COMMANDS
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
from tactilesr_torch.models.tactile_sr import TactileSR, TactileSRCNN
from tactilesr_torch.ops import cuda as tcuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_logger():
    """The entries set up the port's logger (console on stderr, a file in a
    temporary work dir); take back what a test added, so no handler outlives
    the stream or file it writes to."""
    from tactilesr_torch.runtime import logger as tlog

    lg = logging.getLogger("tactilesr_torch")
    handlers, inited = lg.handlers[:], set(tlog._LOGGER_INITIALIZED)
    yield
    for h in lg.handlers:
        if h not in handlers:
            h.close()
    lg.handlers[:] = handlers
    tlog._LOGGER_INITIALIZED.clear()
    tlog._LOGGER_INITIALIZED.update(inited)


# ------------------------------------------------------------- the helpers
@pytest.mark.parametrize("fn,args,want,by", [
    (bench.tpsf_bound_ms, (256,), 0.0117, "operations"),
    (bench.tpsf_bound_ms, (8192,), 0.3745, "operations"),
    (bench.tpsf_bf16_bound_ms, (256, 1), 0.0061, "bytes"),
    (bench.tpsf_bf16_bound_ms, (8192, 1), 0.1958, "bytes"),
    (bench.tpsf_bf16_bound_ms, (256, 3), 0.0061, "bytes"),
    (bench.tpsf_bf16_bound_ms, (8192, 3), 0.1958, "bytes"),
    (bench.fused_bound_ms, (256,), 0.0294, "operations"),
    (bench.tpsf_bwd_bound_ms, (256,), 0.0291, "operations"),
    (bench.tpsf_bwd_bound_ms, (8192,), 0.9312, "operations"),
])
def test_bounds_match_perf_md(fn, args, want, by):
    """PERF.md's kernel table: f32 0.0117 / 0.3745 ms at B = 256 / 8192,
    the bf16 byte bound 0.0061 / 0.1958, the fused 0.0294 and the backward
    0.0291 / 0.9312."""
    ms, got_by = fn(*args)
    assert round(ms, 4) == want and got_by == by


def _hook_flops(model, x):
    """Conv FLOPs (2 x MACs) per frame of one forward, counted by hooks on
    every convolution."""
    total = []

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        total.append(2 * out.numel() * m.in_channels // m.groups * k)

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model.eval()(x)
    for h in handles:
        h.remove()
    return sum(total) / x.shape[0]


@pytest.mark.parametrize("scale,seqs,pattern,force", [(10, 1, 6, 1), (2, 7, 2, 2), (3, 2, 1, 3)])
def test_sr_flops_per_frame_counts_the_convs(scale, seqs, pattern, force):
    model = TactileSR(scale_factor=scale, seqs_cnt=seqs, pattern_feature_extra_layer_cnt=pattern,
                      force_feature_extra_layer_cnt=force)
    x = torch.rand(1, 3 * seqs, 4, 4)
    assert bench.sr_flops_per_frame(scale, seqs, pattern, force)[0] == _hook_flops(model, x)


def test_cnn_flops_per_frame_counts_the_convs():
    assert bench.cnn_flops_per_frame(3, 2) == _hook_flops(TactileSRCNN(scale_factor=3, msrb_cnt=2),
                                                         torch.rand(1, 3, 4, 4))


@pytest.mark.parametrize("name", ["stsr-x10", "mtsr7-x10"])
def test_counts_equal_the_frozen_copies(name):
    """perfbench's frozen FLOP count (``perfbench/workcount.py``, which every
    roofline and ``mfu`` metric reads) equals the port's, hook-tested one
    at each configuration file's widths."""
    from perfbench import workcount

    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        c = json.load(f)
    args = (c["scale_factor"], c["seqsCnt"], c["patternFeatureExtraLayerCnt"], c["forceFeatureExtraLayerCnt"])
    assert bench.sr_flops_per_frame(*args) == workcount.sr_flops_per_frame(*args)
    assert bench.sr_flops_per_frame(*args)[0] == workcount.config_flops_per_frame(c)


# ------------------------------------------------------------- the bench
def test_bench_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--tile", "8"])
    assert e.value.code == 2 and "Pallas" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs the card"):
        bench.bench_tpsf(4, "highest", "cpu")
    with pytest.raises(RuntimeError, match="needs the card"):
        bench.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            bench.main([])


def test_require_launch(monkeypatch):
    """The bench's guard: a call that launched the kernel passes, one that
    ran the plain version raises."""
    name = "tpsf_physics_bf16"
    monkeypatch.setitem(tcuda.launch_counts, name, 0)

    def launched():
        tcuda.launch_counts[name] += 1

    bench.require_launch(name, launched)
    with pytest.raises(RuntimeError, match="was not launched"):
        bench.require_launch(name, lambda: None)


# ------------------------------------------------------------- the entries
def test_graft_entry_matches_jax():
    """The flagship forward: JAX's entry's weights through ``from_jax`` into
    the port's entry module, the first rows of the shared example batch; f32
    within rtol 1e-4 / atol 1e-5, bf16 within 5e-2 of the output range (the
    tolerance of tests/test_torch_sr_model.py)."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as jax_graft

    fn, (variables, xj) = jax_graft.entry()
    model, x = graft_entry.entry(device="cpu")
    assert next(model.parameters()).dtype == torch.float32 and model.dtype == torch.bfloat16
    assert not model.training and x.shape == (32, 3, 4, 4)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    model.load_state_dict(tactile_sr_state_dict(jax.device_get(variables)), strict=True)
    rows = x[:2]
    want_bf16 = np.asarray(jax.jit(fn)(variables, jnp.asarray(rows.numpy())), np.float32)
    f32 = JaxTactileSR(scale_factor=10, seqs_cnt=1, axis_cnt=3, pattern_feature_extra_layer_cnt=6,
                       force_feature_extra_layer_cnt=1)
    want = np.asarray(f32.apply(variables, jnp.asarray(rows.numpy()), train=False))
    assert want.max() > 0
    port32 = TactileSR(dtype=torch.float32)
    port32.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(rows).float().numpy()
        got32 = port32.eval()(rows).numpy()
    np.testing.assert_allclose(got32, want, rtol=1e-4, atol=1e-5)
    span = float(np.abs(want).max())
    assert got.shape == (2, 1, 40, 40) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 5e-2 * span
    assert np.abs(want_bf16 - want).max() <= 5e-2 * span


def test_graft_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        graft_entry.entry()


def test_command_index_lists_every_entry():
    """``python -m tactilesr_torch`` prints every entry, and each names a
    module of the port that exists."""
    import importlib.util

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "tactilesr_torch"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = [c.split()[-1] for c, _ in COMMANDS]
    assert set(mods) == {
        "tactilesr_torch.tasks.tpsf_task", "tactilesr_torch.tasks.sr_task",
        "tactilesr_torch.tasks.sr_seqs_task", "tactilesr_torch.data.generate", "tactilesr_torch.serving",
        "tactilesr_torch.server", "tactilesr_torch.bench", "tactilesr_torch.compat.torch_convert", "tactilesr_torch.compat.export_torch",
        "tactilesr_torch.graft_entry",
    }
    for m in mods:
        assert f"python -m {m}" in proc.stdout and importlib.util.find_spec(m) is not None, m

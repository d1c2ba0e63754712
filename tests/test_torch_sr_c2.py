"""Two behaviours of the trained SR networks seen on the card, held against
the JAX package on the CPU at toy width (scale 4, one MSRB, batch 8), to
tell a fault of the port from the model's own behaviour:

- MTSR zeros: after one epoch of the seqs recipe (lr 1e-4, no warmup, a
  fresh head on a trunk warm-started from a trained STSR) the f32 eval
  forward can be all zero.  Both packages train the same MTSR from the same
  variables on the same labels for the same 21 steps; the share of zero
  eval outputs must agree.
- bf16 stray: the trained STSR's bf16 eval forward strays from its own f32
  eval forward.  Both packages' strays, from the same trained weights, must
  be of one size.  At this width the stray is about 0.5% of the output
  range, far under the 9-11% of the trained full-width networks on the
  card, so agreement here does not show that the card's stray is the
  model's own; it holds the two bf16 forwards to one another.

Run as a script, it prints the measured numbers as JSON:

    JAX_PLATFORMS=cpu python tests/test_torch_sr_c2.py

Given the weights of a trained full-width STSR (a port ``.pth``, such as
``chip_smoke.py --keep-checkpoints DIR`` writes) and LR rows, it measures
both packages' bf16 strays on those weights instead (``strays``;
about a minute a 32 rows):

    JAX_PLATFORMS=cpu python tests/test_torch_sr_c2.py --trained DIR/stsr_latest.pth \
        --rows DIR/sr_test_lr.npz
"""

import argparse
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from conftest import make_toy_trainer, toy_sr_config  # noqa: E402
from tactilesr_tpu.compat.torch_convert import convert_tactile_sr  # noqa: E402
from tactilesr_tpu.models.tactile_sr import TactileSR as JaxTactileSR  # noqa: E402
from tactilesr_tpu.runtime import LRWarmupSchedule as JaxLRWarmupSchedule  # noqa: E402
from tactilesr_tpu.runtime import StepLR as JaxStepLR  # noqa: E402
from tactilesr_tpu.runtime import adam_l2 as jax_adam_l2  # noqa: E402
from tactilesr_tpu.tasks import sr_task as jax_sr_task  # noqa: E402
from tactilesr_torch.compat.from_jax import tactile_sr_state_dict  # noqa: E402
from tactilesr_torch.models.tactile_sr import TactileSR  # noqa: E402
from tactilesr_torch.runtime.optim import adam_l2  # noqa: E402
from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR  # noqa: E402
from tactilesr_torch.tasks import sr_task  # noqa: E402

STSR_ROWS, MTSR_ROWS, TEST_ROWS = 96, 168, 32  # 12 STSR steps, 21 MTSR steps at batch 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed, n, frames):
    """Smooth labels from the first frame's z channel (x 6, the scale of
    the generated SR labels over HR_scale_num), at 100 x 100."""
    rng = np.random.default_rng(seed)
    lr = (rng.random((n, 3 * frames, 4, 4)) * 4).astype(np.float32)
    hr = (6.0 * np.repeat(np.repeat(lr[:, 2:3], 25, axis=2), 25, axis=3)).astype(np.float32)
    return lr, hr


def _trained_stsr(work):
    """The JAX STSR trained 12 steps (f32, lr 1e-3, no warmup, the
    non-negative head so that the toy run's head lives): its variables,
    the trainer's config and the test inputs."""
    cfg = toy_sr_config(work, head_init="non_negative")
    lr, hr = _data(0, STSR_ROWS, 1)
    t = make_toy_trainer(cfg, lr, hr, max_epochs=1)
    t.train(auto_resume=False)
    v = jax.device_get({"params": t.state.params, "batch_stats": t.state.batch_stats})
    return v, cfg, _data(1, TEST_ROWS, 1)[0]


def _outputs_jax(variables, x, seqs_cnt, dtype):
    m = JaxTactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                     force_feature_extra_layer_cnt=1, dtype=dtype)
    return np.asarray(m.apply(variables, jnp.asarray(x), train=False))


def _outputs_port(state_dict, x, seqs_cnt, dtype):
    m = TactileSR(scale_factor=4, seqs_cnt=seqs_cnt, pattern_feature_extra_layer_cnt=1,
                  force_feature_extra_layer_cnt=1, dtype=dtype)
    m.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return m.eval()(torch.from_numpy(x)).numpy()


def _stray(bf16, f32):
    scale = float(np.abs(f32).max())
    d = np.abs(bf16 - f32)
    return {"max_abs": float(d.max()), "ref_max": scale,
            "share_of_range": float(d.max()) / scale,
            "rel_rms": float(np.sqrt(np.mean((bf16 - f32) ** 2) / np.mean(f32 ** 2))),
            "at": [int(i) for i in np.unravel_index(np.argmax(d), d.shape)]}


def measure_bf16_stray(work):
    """Each package's bf16 eval forward against its own f32 eval forward on
    the trained STSR's weights."""
    v, _, x = _trained_stsr(work)
    sd = tactile_sr_state_dict(v)
    return {
        "jax": _stray(_outputs_jax(v, x, 1, jnp.bfloat16), _outputs_jax(v, x, 1, jnp.float32)),
        "port": _stray(_outputs_port(sd, x, 1, torch.bfloat16), _outputs_port(sd, x, 1, torch.float32)),
    }


def strays(state_dict, x, scale_factor=10, pattern_layers=6, force_layers=1, chunk=32):
    """A port STSR state_dict (converted for JAX by
    ``tactilesr_tpu/compat/torch_convert.py::convert_tactile_sr``) through
    both packages' f32 and bf16 eval forwards on the LR rows ``x``: each
    package's bf16 stray from its own f32, each bf16 from the other
    package's f32, and the two f32 forwards from each other."""
    arch = dict(scale_factor=scale_factor, pattern_feature_extra_layer_cnt=pattern_layers,
                force_feature_extra_layer_cnt=force_layers)
    v = convert_tactile_sr(state_dict, pattern_layers=pattern_layers, force_layers=force_layers)

    def run(apply):
        return np.concatenate([apply(x[i:i + chunk]) for i in range(0, len(x), chunk)])

    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        m = JaxTactileSR(dtype=dtype, **arch)
        out["jax", name] = run(lambda xs: np.asarray(m.apply(v, jnp.asarray(xs), train=False)))
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = TactileSR(dtype=dtype, **arch)
        m.load_state_dict(state_dict, strict=True)
        with torch.no_grad():
            out["port", name] = run(lambda xs: m.eval()(torch.from_numpy(xs)).numpy())
    return {
        "rows": len(x),
        "jax": _stray(out["jax", "bf16"], out["jax", "f32"]),
        "port": _stray(out["port", "bf16"], out["port", "f32"]),
        "port_bf16_vs_jax_f32": _stray(out["port", "bf16"], out["jax", "f32"]),
        "jax_bf16_vs_port_f32": _stray(out["jax", "bf16"], out["port", "f32"]),
        "f32_port_vs_jax": _stray(out["port", "f32"], out["jax", "f32"]),
    }


def test_strays_of_a_trained_stsr(tmp_path):
    """``strays`` (the full-width measurement's code) at toy width on the
    trained toy STSR, in chunks: its two own-package strays are those of
    one whole forward (``measure_bf16_stray``'s), and the two f32 forwards
    agree."""
    v, _, x = _trained_stsr(str(tmp_path))
    sd = tactile_sr_state_dict(v)
    got = strays(sd, x, scale_factor=4, pattern_layers=1, chunk=16)
    want = {
        "jax": _stray(_outputs_jax(v, x, 1, jnp.bfloat16), _outputs_jax(v, x, 1, jnp.float32)),
        "port": _stray(_outputs_port(sd, x, 1, torch.bfloat16), _outputs_port(sd, x, 1, torch.float32)),
    }
    for pkg in ("jax", "port"):
        np.testing.assert_allclose(got[pkg]["max_abs"], want[pkg]["max_abs"], rtol=1e-6)
    assert got["f32_port_vs_jax"]["share_of_range"] < 1e-5, got


def _zeros(out):
    return {"zero_pixels": float((out == 0).mean()),
            "all_zero_maps": float((out.reshape(len(out), -1) == 0).all(axis=1).mean()),
            "max": float(out.max())}


def measure_mtsr_zeros(work):
    """The seqs recipe's first epoch in both packages from one MTSR init
    whose trunk is the trained STSR's (JAX's transfer, then the bridge):
    21 steps at lr 1e-4, weight decay 1e-2, no warmup, f32.  Returns the
    share of zero pixels and of all-zero maps in each one's eval forward
    over 32 test rows, and both runs' losses."""
    stsr, cfg, _ = _trained_stsr(os.path.join(work, "stsr"))
    seqs_cfg = dict(cfg, seqsCnt=7, lr=1e-4, weight_decay=1e-2, head_init="reference",
                    save_dir=os.path.join(work, "jax"))
    model = JaxTactileSR(scale_factor=4, seqs_cnt=7, pattern_feature_extra_layer_cnt=1,
                         force_feature_extra_layer_cnt=1)
    init = jax.device_get(model.init(jax.random.key(11), jnp.zeros((1, 21, 4, 4)), train=False))
    init = jax.device_get(jax_sr_task.transfer_trunk_params(
        {"params": init["params"], "batch_stats": init["batch_stats"]}, {"model": stsr}))
    port_init = tactile_sr_state_dict(init)  # before JAX's step donates the arrays
    lr, hr = _data(2, MTSR_ROWS, 7)
    x = _data(3, TEST_ROWS, 7)[0]

    def sched(mod_sched, mod_step):
        return mod_sched(mod_step(1e-4, cfg["lr_scheduler_step_size"], cfg["lr_scheduler_gamma"]),
                         by_epoch=True, epoch_len=MTSR_ROWS // 8)

    tj = jax_sr_task.SRTrainer(
        config=seqs_cfg, model=model, variables=init, tx=jax_adam_l2(weight_decay=1e-2),
        lr_schedule=sched(JaxLRWarmupSchedule, JaxStepLR), train_arrays={"LR": lr, "HR": hr},
        batch_size=8, max_epochs=1, work_dir=seqs_cfg["save_dir"], seed=42)
    tj.train(auto_resume=False)
    vj = jax.device_get({"params": tj.state.params, "batch_stats": tj.state.batch_stats})

    port_cfg = dict(seqs_cfg, save_dir=os.path.join(work, "port"))
    pmodel = sr_task.build_model(port_cfg)
    pmodel.load_state_dict(port_init, strict=True)
    tp = sr_task.SRTrainer(
        config=port_cfg, model=pmodel, optimizer=adam_l2(pmodel.parameters(), 1e-2),
        lr_schedule=sched(LRWarmupSchedule, StepLR), train_arrays={"LR": lr, "HR": hr},
        batch_size=8, max_epochs=1, work_dir=port_cfg["save_dir"], seed=42, device="cpu")
    tp.train(auto_resume=False)

    return {
        "jax": _zeros(_outputs_jax(vj, x, 7, jnp.float32)),
        "port": _zeros(_outputs_port(tp.model.state_dict(), x, 7, torch.float32)),
        "losses_jax": tj.metric_storage["total_loss"].state_dict()["values"],
        "losses_port": tp.metric_storage["total_loss"].state_dict()["values"],
    }


def test_mtsr_zero_outputs_match_jax(tmp_path):
    """The share of zero pixels and of all-zero maps in the MTSR's eval
    forward after its first epoch: the port's within 0.02 of JAX's (the
    two trajectories part only by f32 rounding, as the 3-step trajectory
    test bounds), and the losses at rtol 1e-3 (the last 20 of the 21 steps,
    which the metric storage keeps; measured 1.1e-4)."""
    got = measure_mtsr_zeros(str(tmp_path))
    np.testing.assert_allclose(got["losses_port"], got["losses_jax"], rtol=1e-3)
    for key in ("zero_pixels", "all_zero_maps"):
        assert abs(got["port"][key] - got["jax"][key]) <= 0.02, got


def test_bf16_stray_matches_jax(tmp_path):
    """Each package's bf16 eval forward strays from its own f32 by the same
    order: the port's stray (max |d| over the output range, and relative
    RMS) within a factor of 2 of JAX's either way, both under 10% of the
    range (bf16 keeps 8 significant bits; the two round at other places)."""
    got = measure_bf16_stray(str(tmp_path))
    for key in ("share_of_range", "rel_rms"):
        j, p = got["jax"][key], got["port"][key]
        assert 0.5 * j <= p <= 2.0 * j, got
        assert p < 0.1 and j < 0.1, got


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser()
    p.add_argument("--trained", help="a port .pth of a trained full-width STSR")
    p.add_argument("--rows", help=".npz whose 'LR' rows feed it")
    p.add_argument("--n", type=int, default=64, help="how many of those rows")
    args = p.parse_args()
    if args.trained:
        with np.load(args.rows) as z:
            lr = np.ascontiguousarray(z["LR"][:args.n, :3], np.float32)
        sd = torch.load(args.trained, map_location="cpu", weights_only=True)["model"]
        print(json.dumps(strays(sd, lr), indent=1))
        sys.exit(0)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as work:
        print(json.dumps({"bf16_stray": measure_bf16_stray(os.path.join(work, "a")),
                          "mtsr_zeros": measure_mtsr_zeros(os.path.join(work, "b"))}, indent=1))

"""The plain reference against the port at toy widths (a test may import
both sides): the eval forward, the fused serving graph, and the first
training steps."""

import pytest
import torch

from perfbench import core
from perfbench.drivers import train as drv
from perfbench.reference.compare import serving_numbers, training_numbers
from perfbench.reference.model import build
from perfbench.weights import seeded_state_dict

CFG = {**core.read_json(core.PKG / "configs" / "stsr-x10.json"), "scale_factor": 2,
       "patternFeatureExtraLayerCnt": 2}


@pytest.mark.parametrize("seqs", [1, 7])
def test_reference_matches_the_port_in_eval(seqs):
    from tactilesr_torch.models.inference import fold_inference_params, tactile_sr_infer
    from tactilesr_torch.models.tactile_sr import TactileSR

    cfg = {**CFG, "seqsCnt": seqs}
    state = seeded_state_dict(cfg, 2**31 + seqs, "cpu")
    x = 4 * torch.rand(16, 3 * seqs, 4, 4, generator=torch.Generator().manual_seed(1))
    ref = build(cfg)
    ref.load_state_dict(state)
    with torch.no_grad():
        want = ref.eval()(x)
        port = TactileSR(2, seqs, 3, 2, 1)
        port.load_state_dict(state)
        got = port.eval()(x)
        mode = "grouped" if seqs > 1 else "per_seq"
        folded = fold_inference_params(state, seqs_cnt=seqs, pattern_layers=2, force_layers=1,
                                       dtype=torch.float32, branch_mode=mode)
        fused = tactile_sr_infer(folded, x, scale_factor=2, seqs_cnt=seqs, pattern_layers=2, force_layers=1,
                                 branch_mode=mode)
    assert want.abs().mean() > 0.5  # scaled to the labels' mean, not all zero
    for out in (got, fused):
        nums = serving_numbers(out, want)
        assert nums["rel_rms"] < 1e-5 and nums["worst_row"] < 1e-5, nums


def test_reference_follows_the_ports_first_training_steps(tmp_path):
    cfg = {**CFG, "compute_dtype": "float32", "matmul_precision": "highest"}
    tr = {**core.read_json(core.PKG / "traffic" / "train-b32.json"), "batch": 4, "steps_per_epoch": 6}
    cell = core.Cell(name="t", config=cfg, traffic=tr, limits={}, seed=2**31 + 3, seconds=0, trace=False,
                     device=torch.device("cpu"), t0=0, scratch=str(tmp_path))
    state = seeded_state_dict(cfg, cell.seed, "cpu")
    lr_rows, hr_rows = drv.seeded_rows(cfg, tr, cell.seed, "cpu")
    trainer = drv.build_trainer(cfg, tr, state, lr_rows, hr_rows, cell)
    snap = drv.watch_first_steps(trainer, tr["checked_steps"])
    drv.epoch(trainer)
    prog = {"losses": trainer._scan.losses["total_loss"][:tr["checked_steps"]].tolist(), "grad": snap["grad"],
            "change": {k: p - state[k] for k, p in snap["params"].items()},
            "stats": {k: b - state[k] for k, b in snap["stats"].items()}}
    nums = training_numbers(prog, drv.reference_numbers(cfg, tr, state, lr_rows, hr_rows, cell.seed))
    # f32 on both sides: the forward and first gradient agree to rounding
    # (a BatchNorm bias's gradient, where BN's backward cancels, to 8e-5);
    # Adam's m/sqrt(v) turns an element's rounding-sized gradient into a
    # step of lr either way, so the change agrees less closely
    tol = {"loss_gap": 1e-5, "grad_gap": 2e-4, "stats_gap": 1e-3, "change_gap": 1e-2}
    assert all(nums[k] < t for k, t in tol.items()), nums

"""Cells' runs on the card (skip without one)."""

import json
import subprocess
import sys

import pytest

from perfbench import core


@pytest.mark.gpu
def test_bulk_cell_runs_correct_on_the_card(cuda_device):
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "stsr-serve-bulk", "--seed",
                        str(2**31 + 17), "--seconds", "2"], cwd=core.REPO, capture_output=True, text=True,
                       timeout=600)
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_training_with_its_replays_skipped_is_not_correct(cuda_device, monkeypatch):
    """The captured step's replays (every step after the eager ones, the
    whole window) turned into no-ops: the checked steps and the window's
    losses see it."""
    from tactilesr_torch.ops.graph import CapturedGraph

    monkeypatch.setattr(CapturedGraph, "replay", lambda self: None)
    line, out = core.run("stsr-train-b32", 2**31 + 23, 2, False, cuda_device)
    assert not line["correct"], line["checks"]
    assert out.checks["window_bad_losses"] > 0 and out.checks["loss_gap"] > line["checks"]["loss_gap"]["limit"]

"""Runs of the cells with the timed path broken underneath come out not
correct, and sound runs correct, at toy widths on the CPU (the card look
skipped): the control of the check itself."""

import numpy as np
import pytest
import torch

from perfbench import core

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _run(cell, toy, seconds=0.5):
    line, _ = core.run(cell, SEED, seconds, False, CPU, overrides=toy[cell])
    return line["correct"]


@pytest.mark.parametrize("cell", ["stsr-serve-bulk", "mtsr7-serve-bulk", "stsr-train-b32"])
def test_sound_runs_are_correct(cell, toy):
    assert _run(cell, toy)


def _half_rows_left_out(predict):
    def broken(self, lr):
        out = predict(self, lr)
        out[out.shape[0] // 2:] = 0
        return out
    return broken


def _answer_from_the_next_row(predict):
    def broken(self, lr):
        return np.roll(predict(self, lr), 1, axis=0)
    return broken


@pytest.mark.parametrize("cell", ["stsr-serve-bulk", "mtsr7-serve-bulk"])
@pytest.mark.parametrize("fault", [_half_rows_left_out, _answer_from_the_next_row])
def test_broken_serving_is_not_correct(cell, fault, toy, monkeypatch):
    from tactilesr_torch.serving import SRPredictor

    monkeypatch.setattr(SRPredictor, "predict", fault(SRPredictor.predict))
    assert not _run(cell, toy)


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(toy, monkeypatch):
    from tactilesr_torch.runtime.optim import AdamL2

    monkeypatch.setattr(AdamL2, "step", lambda self, lr: None)
    assert not _run("stsr-train-b32", toy)


def test_half_the_batch_left_out_is_not_correct(toy, monkeypatch):
    from tactilesr_torch.runtime.trainer import Trainer

    gather = Trainer._gather

    def half(self, idx, mask):
        keep = torch.ones_like(mask)
        keep[mask.shape[0] // 2:] = 0
        return gather(self, idx, mask * keep)  # the loss's mean over the rest

    monkeypatch.setattr(Trainer, "_gather", half)
    assert not _run("stsr-train-b32", toy)

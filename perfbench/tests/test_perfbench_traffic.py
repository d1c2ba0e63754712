"""Seeded inputs repeat, and the end-to-end arithmetic: rates over whole
requests and epochs."""

import math

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.drivers import train
from perfbench.inputs import readings

BIG = 2**31 + 977


def test_inputs_repeat_for_a_seed():
    np.testing.assert_array_equal(readings(BIG, 5, 8, 3, 0, 4), readings(BIG, 5, 8, 3, 0, 4))
    assert not np.array_equal(readings(BIG, 5, 8, 3, 0, 4), readings(BIG + 1, 5, 8, 3, 0, 4))
    cfg = core.load_cell("stsr-train-b32")["config"]
    tr = {"batch": 4, "steps_per_epoch": 3, "reading_range": [0, 4], "label_range": [0, 50]}
    for a, b in zip(train.seeded_rows(cfg, tr, BIG, "cpu"), train.seeded_rows(cfg, tr, BIG, "cpu")):
        assert torch.equal(a, b)
    for a, b in zip(train.first_batches(BIG, 12, 4, 3), train.first_batches(BIG, 12, 4, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cell", ["stsr-serve-bulk", "stsr-train-b32"])
def test_rate_is_whole_units_over_their_time(cell, toy):
    line, out = core.run(cell, BIG, 0.5, False, torch.device("cpu"), overrides=toy[cell])
    tr = {**core.load_cell(cell)["traffic"], **toy[cell]["traffic"]}
    per_unit = tr.get("frames_per_request") or tr["batch"] * tr["steps_per_epoch"]
    units = out.attempted if "frames_per_request" in tr else out.attempted // tr["steps_per_epoch"]
    metric = "frames_per_s" if "frames_per_request" in tr else "train_samples_per_s"
    assert out.details["window_s"] >= 0.5
    assert line["metrics"][metric]["value"] == pytest.approx(units * per_unit / out.details["window_s"])
    assert 0 < line["metrics"]["setup_s"]["value"] < 600 and not math.isnan(line["metrics"][metric]["value"])

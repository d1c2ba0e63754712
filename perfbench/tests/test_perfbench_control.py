"""The control (the reference with fp8 convolutions in the program's place)
fails the cells' limits; on the card at the cells' sizes it is read by
``perfbench/tools/calibrate.py`` (PERF.md gives those readings)."""

import pytest
import torch

from perfbench import core
from perfbench.common import serving_control
from perfbench.reference.compare import judge

CPU = torch.device("cpu")
# the full trunk's depth at a smaller upsample: the control's error grows with depth
DEEP = {"scale_factor": 4}


@pytest.mark.parametrize("cell", ["stsr-serve-bulk", "mtsr7-serve-bulk"])
def test_fp8_serving_fails_the_limits(cell):
    c = core.make_cell(cell, 2**31 + 5, 1, False, CPU, 0, {"config": DEEP, "traffic": {"checked_rows": 64}})
    driver = core.load_module("drivers", c.traffic["driver"])
    frames = driver.control_frames(c, 2)[:64]
    nums = serving_control(c.config, c.seed, frames, CPU)
    assert not judge(nums, c.limits), nums


def test_fp8_and_half_batch_training_fail_the_limits(toy):
    c = core.make_cell("stsr-train-b32", 2**31 + 6, 1, False, CPU, 0,
                       {"config": DEEP, "traffic": {"batch": 4, "steps_per_epoch": 6}})
    readings = core.load_module("drivers", "train").control(c)
    for kind, nums in readings.items():  # the reference's numbers (the window's own is the program's)
        assert not judge(nums, {k: lim for k, lim in c.limits.items() if k in nums}), (kind, nums)

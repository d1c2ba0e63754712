"""The frozen work counts equal the port's own at both configurations."""

import json

import pytest

from perfbench import core
from perfbench.workcount import config_flops_per_frame, sr_flops_per_frame


@pytest.mark.parametrize("name", ["stsr-x10", "mtsr7-x10"])
def test_frozen_flops_match_the_port(name):
    from tactilesr_torch.bench import sr_flops_per_frame as port

    c = json.loads((core.PKG / "configs" / f"{name}.json").read_text())
    args = (c["scale_factor"], c["seqsCnt"], c["patternFeatureExtraLayerCnt"], c["forceFeatureExtraLayerCnt"])
    assert sr_flops_per_frame(*args) == port(*args)
    assert config_flops_per_frame(c) == port(*args)[0]


def test_published_counts():
    assert round(sr_flops_per_frame(10, 1)[0] / 1e9, 2) == 14.64
    assert round(sr_flops_per_frame(10, 7)[0] / 1e9, 2) == 16.09

"""Fixtures of the benchmark's CPU tests: the repository's root on the
path, toy widths of the cells, and the card's test gate."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# toy widths and traffic: the cells' code paths at a size the CPU holds
TOY_CONFIG = {"scale_factor": 2, "patternFeatureExtraLayerCnt": 1}
TOY = {
    "stsr-serve-bulk": {"config": TOY_CONFIG, "traffic": {"frames_per_request": 64, "distinct_requests": 2,
                                                         "checked_rows": 64, "traced_requests": 1}},
    "mtsr7-serve-bulk": {"config": TOY_CONFIG, "traffic": {"frames_per_request": 64, "distinct_requests": 2,
                                                          "checked_rows": 64, "traced_requests": 1}},
    "stsr-train-b32": {"config": TOY_CONFIG, "traffic": {"batch": 4, "steps_per_epoch": 6, "traced_epochs": 1}},
}


@pytest.fixture
def toy():
    return TOY


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)

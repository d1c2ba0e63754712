"""Inputs drawn from the seed, with numpy: a request's readings are
U(lo, hi), drawn from (seed, request index) alone, so that the window and
the check draw the same."""

from __future__ import annotations

import numpy as np


def norm_seed(seed: int) -> int:
    return int(seed) % 2**63


def readings(seed: int, index: int, frames: int, channels: int, lo: float, hi: float) -> np.ndarray:
    """Request ``index``'s (frames, channels, 4, 4) f32 readings, U(lo, hi)."""
    rng = np.random.default_rng([norm_seed(seed), 3, int(index)])
    return (lo + (hi - lo) * rng.random((frames, channels, 4, 4))).astype(np.float32)

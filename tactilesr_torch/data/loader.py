"""Batching: (index, mask) pairs per epoch (the port's copy of
``tactilesr_tpu/data/loader.py``).

The trainer keeps the whole (small) dataset on the device and gathers each
step's rows by index, so nothing is collated on the host.  The final partial
batch is padded to the fixed batch size with row 0 and carries a ``mask``,
so every step has one shape while losses and metrics stay exact (torch
DataLoader ``drop_last=False`` semantics).  The same ``np.random.Generator``
state gives the same order as the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["epoch_batches"]


def epoch_batches(
    n: int,
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (padded index array of len batch_size, validity mask)."""
    order = np.arange(n)
    if shuffle:
        assert rng is not None, "shuffle requires an rng"
        order = rng.permutation(n)
    num = n // batch_size if drop_last else math.ceil(n / batch_size)
    for b in range(num):
        idx = order[b * batch_size : (b + 1) * batch_size]
        mask = np.ones(len(idx), np.float32)
        if len(idx) < batch_size:  # pad final batch; mask the padding out
            pad = batch_size - len(idx)
            idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        yield idx, mask

"""The flagship forward as an entry point (the counterpart of the root
``__graft_entry__.py::entry``).

``entry(device="cuda")`` returns the flagship network's eval forward and its
example input: a seeded full-width bf16 STSR (``bench.flagship_model``:
scale 10, 6 MSRB, 1 ResBlock, weights from
``torch.Generator().manual_seed(0)``) as an ``nn.Module`` in
eval mode, and a (32, 3, 4, 4) f32 batch drawn from
``np.random.default_rng(0)`` (the JAX entry's), both on ``device``.
``model(x)`` is a (32, 1, 40, 40) f32 map.

The JAX file's second entry, ``dryrun_multichip`` (the training recipe
data-parallel over a device mesh), waits for the port's data parallel
(ROADMAP A5).
"""

from __future__ import annotations

import numpy as np
import torch

from .bench import flagship_model
from .runtime.device import resolve_device

__all__ = ["entry"]


def entry(device="cuda"):
    dev = resolve_device(device)
    model = flagship_model(dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).random((32, 3, 4, 4)).astype(np.float32))
    return model.to(dev).eval(), x.to(dev)


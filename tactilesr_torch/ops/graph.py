"""A CUDA graph whose replays keep the ops' launch counters true.

A kernel wrapper that counts its launches on the host (as
``ops/cuda::launch_counts`` does) counts once during a capture, which runs
no kernel, and never at a replay, which runs no Python.  A counter dict
given to ``register_counters`` is set back, after a capture, by what the
capture added to it, and each ``CapturedGraph.replay`` adds that much
again.  The caller of a graph needs to know no counter.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

__all__ = ["CapturedGraph", "register_counters"]

# dicts of name -> launches, each bumped by its wrappers on the host
_counters: List[Dict[str, int]] = []


def register_counters(counts: Dict[str, int]) -> None:
    """Keep ``counts`` true under graph capture and replay."""
    if not any(c is counts for c in _counters):
        _counters.append(counts)


class CapturedGraph:
    """One ``torch.cuda.CUDAGraph`` and the launches its capture recorded
    (``per_replay``: counter name -> launches in one replay)."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.per_replay: Dict[str, int] = {}
        self._recorded: List[Tuple[Dict[str, int], Dict[str, int]]] = []

    @contextlib.contextmanager
    def capture(self):
        """Capture the block into the graph (``torch.cuda.graph``)."""
        before = [(c, dict(c)) for c in _counters]
        try:
            with torch.cuda.graph(self.graph):
                yield self
        finally:
            for c, old in before:
                added = {k: n - old.get(k, 0) for k, n in c.items()}
                c.update(old)
                self._recorded.append((c, added))
                for k, n in added.items():
                    self.per_replay[k] = self.per_replay.get(k, 0) + n

    def replay(self) -> None:
        self.graph.replay()
        for c, added in self._recorded:
            for k, n in added.items():
                c[k] += n

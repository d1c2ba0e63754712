"""Windowed metric history (the port's copy of
``tactilesr_tpu/runtime/history.py``; the reference's
HistoryBuffer/MetricStorage pair, cpu/history_buffer.py:6-54,
cpu/trainer.py:501-567).

Stores scalar series with a smoothing window; ``values_maybe_smooth`` feeds
the TensorBoard/console writers.  The whole storage serializes to a plain
dict so it can ride inside checkpoints.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

__all__ = ["HistoryBuffer", "MetricStorage"]


class HistoryBuffer:
    """Keeps the latest ``window_size`` values plus global count/sum."""

    def __init__(self, window_size: int = 20):
        self._window_size = window_size
        self._values: deque = deque(maxlen=window_size)
        self._count: int = 0
        self._sum: float = 0.0

    def update(self, value: float) -> None:
        value = float(value)
        self._values.append(value)
        self._count += 1
        self._sum += value

    @property
    def latest(self) -> float:
        if not self._values:
            raise ValueError(
                "HistoryBuffer is empty: no value has been logged yet "
                "(e.g. a plateau LR update before any evaluation ran)"
            )
        return self._values[-1]

    @property
    def avg(self) -> float:
        if not self._values:
            raise ValueError("HistoryBuffer is empty: no value has been logged yet")
        return sum(self._values) / len(self._values)

    @property
    def global_avg(self) -> float:
        return self._sum / self._count

    @property
    def global_sum(self) -> float:
        return self._sum

    def __len__(self) -> int:
        return self._count

    def state_dict(self) -> dict:
        return {
            "window_size": self._window_size,
            "values": list(self._values),
            "count": self._count,
            "sum": self._sum,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "HistoryBuffer":
        buf = cls(window_size=int(state["window_size"]))
        buf._values = deque(state["values"], maxlen=buf._window_size)
        buf._count = int(state["count"])
        buf._sum = float(state["sum"])
        return buf


class MetricStorage:
    """Name -> HistoryBuffer map with a per-metric ``smooth`` flag and
    latest-iteration tracking."""

    def __init__(self, window_size: int = 20):
        self._window_size = window_size
        self._history: Dict[str, HistoryBuffer] = {}
        self._smooth: Dict[str, bool] = {}
        self._latest_iter: Dict[str, int] = {}

    def update(self, iter: Optional[int] = None, smooth: bool = True, **kwargs) -> None:
        for key, value in kwargs.items():
            if key in self._smooth:
                assert self._smooth[key] == smooth, (
                    f"metric '{key}' was previously logged with smooth="
                    f"{self._smooth[key]}"
                )
            else:
                self._smooth[key] = smooth
                self._history[key] = HistoryBuffer(window_size=self._window_size)
                self._latest_iter[key] = -1
            if iter is not None:
                assert iter > self._latest_iter[key], (
                    f"metric '{key}': iteration must be increasing "
                    f"({iter} <= {self._latest_iter[key]})"
                )
                self._latest_iter[key] = iter
            else:
                self._latest_iter[key] += 1
            self._history[key].update(value)

    def __contains__(self, key: str) -> bool:
        return key in self._history

    def __getitem__(self, key: str) -> HistoryBuffer:
        return self._history[key]

    def keys(self):
        return self._history.keys()

    @property
    def values_maybe_smooth(self) -> Dict[str, Tuple[int, float]]:
        """metric name -> (latest iteration, window-avg if smoothed else latest)."""
        return {
            key: (self._latest_iter[key], buf.avg if self._smooth[key] else buf.latest)
            for key, buf in self._history.items()
        }

    def state_dict(self) -> dict:
        return {
            "window_size": self._window_size,
            "smooth": dict(self._smooth),
            "latest_iter": dict(self._latest_iter),
            "history": {k: b.state_dict() for k, b in self._history.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        self._window_size = int(state["window_size"])
        self._smooth = {k: bool(v) for k, v in state["smooth"].items()}
        self._latest_iter = {k: int(v) for k, v in state["latest_iter"].items()}
        self._history = {
            k: HistoryBuffer.from_state_dict(v) for k, v in state["history"].items()
        }

"""Logging: a console handler on process 0, per-process file logs, and a
TensorBoard scalar writer (the port's copy of
``tactilesr_tpu/runtime/logger.py``).

The writer uses the installed ``tensorboard`` package's event writer when
it imports and falls back to a JSONL scalar log otherwise.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

__all__ = ["setup_logger", "ScalarWriter"]

_LOGGER_INITIALIZED = set()


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.WARNING: "\033[33m",
        logging.ERROR: "\033[31m",
        logging.CRITICAL: "\033[31;1m",
    }
    RESET = "\033[0m"

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelno)
        if color and sys.stdout.isatty():
            return f"{color}{msg}{self.RESET}"
        return msg


def setup_logger(
    name: Optional[str] = "tactilesr_torch",
    output_dir: Optional[str] = None,
    process_index: int = 0,
    level: int = logging.INFO,
    stream=None,
) -> logging.Logger:
    """Idempotent logger setup: console handler on process 0 only (on
    ``stream``, stdout by default; the first call decides); a per-process
    file handler when ``output_dir`` is given."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = "[%(asctime)s %(name)s %(levelname)s] %(message)s"

    console_key = (name, "console", process_index)
    if process_index == 0 and console_key not in _LOGGER_INITIALIZED:
        _LOGGER_INITIALIZED.add(console_key)
        ch = logging.StreamHandler(stream or sys.stdout)
        ch.setFormatter(_ColorFormatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(ch)

    file_key = (name, output_dir, process_index)
    if output_dir is not None and file_key not in _LOGGER_INITIALIZED:
        _LOGGER_INITIALIZED.add(file_key)
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log_rank{process_index}.txt"))
        fh.setFormatter(logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """TensorBoard scalar writer with a JSONL fallback.

    ``add_scalar(tag, value, step)``; one point per (tag, step) is the
    logger hook's business.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._impl = None
        self._jsonl = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import EventFileWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._event_cls = Event
            self._summary_cls = Summary
            self._impl = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._impl is not None:
            summary = self._summary_cls(
                value=[self._summary_cls.Value(tag=tag, simple_value=float(value))]
            )
            event = self._event_cls(wall_time=time.time(), step=int(step), summary=summary)
            self._impl.add_event(event)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
            self._jsonl.flush()

    def flush(self) -> None:
        if self._impl is not None:
            self._impl.flush()
        elif self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._impl is not None:
            self._impl.close()
        elif self._jsonl is not None:
            self._jsonl.close()

"""In-memory spans of the program's phases, on ``torch.profiler``'s clock.

``span(name, **attrs)`` times a block with ``time.time_ns()``, the clock of
the profiler's (Kineto's) host and device events, so a span lines up with
the device work inside it.  A span records ``(start_ns, end_ns, name, id,
parent_id, root_id, attrs)``: a thread's open spans form a stack, which
gives each record its parent, and every span under one outermost span (one
request, one epoch) carries that span's id as ``root_id``.

Tracing is on while a torch profiler runs (``torch.profiler.profile``,
``ProfilerHook``), in every thread of the process, and then each span also
enters ``torch.profiler.record_function(name)``, so that the profiler's
traces name the phases.  Off, ``span`` returns one shared no-op context:
no clock read, no record.  A span's ``recording`` says which of the two it
is, so that a block counts what it did (for ``set``) only when traced.
Records go into a bounded buffer; once it is full each new record drops
the oldest and counts it in ``dropped()``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import types
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Span", "Tracer", "TRACER", "span", "records", "dropped", "clear"]

CAPACITY = 65536

# the profiler's process-wide flag (torch.autograd._profiler_enabled() is per
# thread); a torch without it leaves tracing off
_PROFILER = (_autograd_profiler if hasattr(_autograd_profiler, "_is_profiler_enabled")
             else types.SimpleNamespace(_is_profiler_enabled=False))


class Span(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    id: int
    parent_id: Optional[int]
    root_id: int
    attrs: dict


class _Off:
    """The span of tracing off: enters, exits and takes attrs as a no-op."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Open:
    """A span while tracing is on: its record is made when the block exits."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent_id", "root_id", "start_ns", "_annotation")
    recording = True

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def set(self, **attrs) -> None:
        """Add attrs known only inside the block (a count of what it did)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        self.parent_id = stack[-1].id if stack else None
        self.root_id = stack[0].id if stack else self.id
        stack.append(self)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._annotation.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer._append(Span(self.start_ns, end_ns, self.name, self.id, self.parent_id,
                                 self.root_id, self.attrs))
        return False


class Tracer:
    """Spans of every thread of the process in one bounded buffer."""

    def __init__(self, capacity: int = CAPACITY):
        self._records = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, rec: Span) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(rec)

    def records(self) -> List[Span]:
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0


TRACER = Tracer()


def span(name: str, **attrs):
    """A span of ``TRACER`` while a profiler runs, else the shared no-op."""
    if _PROFILER._is_profiler_enabled:
        return _Open(TRACER, name, attrs)
    return _OFF


def records() -> List[Span]:
    return TRACER.records()


def dropped() -> int:
    return TRACER.dropped()


def clear() -> None:
    TRACER.clear()

"""Spans of the program's host stages, and profiler ranges.

``span(name, **attrs)`` times one stage on ``time.perf_counter()`` and,
when the stage ends, logs ``Span(id, parent, name, t0, t1, attrs)``: the
parent is the innermost span still open on the same thread, and ``attrs``
are the counters at the stage's boundary (the dict the ``with`` statement
gives, so a stage can add what it learns on the way). The log is a ring
of ``CAPACITY`` spans that counts the spans it let go (``dropped``), so
its memory stays fixed however long the process runs; nothing is written
anywhere. ``spans()`` is a snapshot, oldest end first.

While a torch profiler records, and only then, a span is also a
``record_function`` range of the same name, so the profiler's host
timeline (the clock its device trace is aligned to) names the stage the
host was in. ``range(name)`` is the range alone, with no log entry, for
code whose host time means nothing because it only enqueues device work;
``op(name)`` is an operation, which the profiler links the kernels
launched inside it to.
With no profiler recording a span costs a few microseconds and a range
one check.

``tally(name, value)`` keeps a device quantity of each call (a 0-d or 1-d
tensor) in a ring of ``TALLY_CAPACITY`` slots on the tensor's device beside
the call's host time: recording it enqueues one copy and never waits for
the device; ``tallies(name)`` reads the ring back (one wait) after the
fact.

Names are dotted by layer: ``ckpt.*`` (``checkpoint/dedup_ckpt.py``),
``cluster.*`` (``core/``), ``optim.*``, ``kernels.*``, ``moe.*``
(``models/moe.py``), ``ssm.*`` (``models/ssm.py``). docs/tracing.md
lists them with their attributes. This module imports no torch of its
own: the host cluster (``core/``) runs without it, and no profiler can be
recording where torch was never imported.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time
from typing import NamedTuple

CAPACITY = 65536


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    t0: float
    t1: float
    attrs: dict

    @property
    def s(self) -> float:
        return self.t1 - self.t0


def _profiling() -> bool:
    """Whether a torch profiler is recording in this process."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


_NULL = contextlib.nullcontext()


def _record_function(name: str):
    return sys.modules["torch"].autograd.profiler.record_function(name)


def range(name: str):  # noqa: A001  (the profiler's word for it)
    """A ``record_function`` range named ``name`` while a profiler records;
    a context that does nothing otherwise."""
    return _record_function(name) if _profiling() else _NULL


def op(name: str):
    """A profiler operation named ``name`` while a profiler records; a
    context that does nothing otherwise. The profiler links a device kernel
    to the innermost operation around its launch and never to a range, so
    a kernel launched through ``ctypes`` outside any torch operation is
    linked to nothing unless it is launched inside one of these."""
    return sys.modules["torch"]._C._profiler._RecordFunctionFast(name) if _profiling() else _NULL


class SpanLog:
    """A ring of the last ``capacity`` spans, safe to share between threads
    (each thread keeps its own stack of open spans)."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._recorded = 0

    def span(self, name: str, /, **attrs) -> _Open:
        return _Open(self, name, attrs)

    def spans(self) -> list[Span]:
        with self._lock:
            return [Span._make(s) for s in self._ring]

    def dropped(self) -> int:
        """Spans the ring let go, the oldest first."""
        with self._lock:
            return self._recorded - len(self._ring)

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Open:
    """One span while it runs (what ``SpanLog.span`` returns)."""

    __slots__ = ("log", "name", "attrs", "id", "parent", "stack", "rf", "t0")

    def __init__(self, log: SpanLog, name: str, attrs: dict):
        self.log, self.name, self.attrs = log, name, attrs

    def __enter__(self) -> dict:
        self.id = next(self.log._ids)
        self.stack = self.log._stack()
        self.parent = self.stack[-1] if self.stack else None
        self.stack.append(self.id)
        self.rf = _record_function(self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self.attrs

    def __exit__(self, kind, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(kind, exc, tb)
        self.stack.pop()
        if kind is not None:
            self.attrs["error"] = kind.__name__
        with self.log._lock:
            self.log._ring.append((self.id, self.parent, self.name, self.t0, t1, self.attrs))
            self.log._recorded += 1
        return False


LOG = SpanLog()


def span(name: str, /, **attrs) -> _Open:
    """A span of the process's log (``LOG``)."""
    return LOG.span(name, **attrs)


def spans() -> list[Span]:
    return LOG.spans()


def dropped() -> int:
    return LOG.dropped()


TALLY_CAPACITY = 65536


class Tally:
    """Per-call values of a device quantity: slot ``i % capacity`` of a
    ``(capacity, *value.shape)`` tensor on the values' device holds call
    ``i``'s value, and a host ring its ``time.perf_counter()``."""

    def __init__(self, capacity: int = TALLY_CAPACITY):
        self.capacity = capacity
        self._buf = None
        self._times: collections.deque = collections.deque(maxlen=capacity)
        self._n = 0
        self._lock = threading.Lock()

    def add(self, value) -> None:
        with self._lock:
            if self._buf is None or self._buf.device != value.device or self._buf.shape[1:] != value.shape:
                self._buf = value.new_zeros((self.capacity, *value.shape))
                self._times.clear()
                self._n = 0
            self._buf[self._n % self.capacity].copy_(value)
            self._times.append(time.perf_counter())
            self._n += 1

    def values(self) -> list[tuple[float, object]]:
        """(host time, value as a number or list) of the calls the ring
        holds, oldest first. Waits for the device."""
        with self._lock:
            if self._buf is None:
                return []
            held = len(self._times)
            rows = self._buf.tolist()
            first = self._n - held
            return [(t, rows[(first + i) % self.capacity]) for i, t in enumerate(self._times)]


TALLIES: dict[str, Tally] = {}


def tally(name: str, value) -> None:
    """Record ``value`` (a tensor) as one call of tally ``name``."""
    t = TALLIES.get(name)
    if t is None:
        t = TALLIES[name] = Tally()
    t.add(value)


def tallies(name: str) -> list[tuple[float, object]]:
    """Tally ``name``'s (host time, value) per call; [] where none was made."""
    t = TALLIES.get(name)
    return t.values() if t is not None else []

"""Spans the benchmark records around its calls into the program's layers.

A ``Spans`` keeps, for the operation in progress (a train step, a save, a
restore...), the host-clock seconds spent inside each wrapped call, by
name. ``wrap`` replaces an attribute of a program object or module with a
timed version; ``undo`` puts every original back. When a profiler is
recording, each span is also a ``record_function`` range, so the trace can
say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, sync=None):
        self.sync = sync or (lambda: None)
        self.current: dict[str, float] | None = None
        self.profiling = False
        self._undo: list = []

    @contextlib.contextmanager
    def op(self, name: str):
        """One operation: yields its dict of span seconds."""
        outer, self.current = self.current, {}
        try:
            with self.range(name):
                yield self.current
        finally:
            self.current = outer

    def range(self, name: str):
        return torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()

    def add(self, name: str, seconds: float) -> None:
        if self.current is not None:
            self.current[name] = self.current.get(name, 0.0) + seconds

    def wrap(self, owner, attr: str, name: str, synced: bool = False, on_result=None) -> None:
        """Time every call of ``owner.attr`` as span ``name`` (between two
        device synchronizations when ``synced``); ``on_result(result)`` sees
        each result."""
        inner = getattr(owner, attr)

        def timed(*args, **kw):
            with self.range(name):
                if synced:
                    self.sync()
                t = time.perf_counter()
                out = inner(*args, **kw)
                if synced:
                    self.sync()
                self.add(name, time.perf_counter() - t)
            if on_result is not None:
                on_result(out)
            return out

        had = attr in getattr(owner, "__dict__", {})
        self._undo.append((owner, attr, inner, had))
        setattr(owner, attr, timed)

    def undo(self) -> None:
        for owner, attr, inner, had in reversed(self._undo):
            if had:
                setattr(owner, attr, inner)
            else:
                delattr(owner, attr)
        self._undo.clear()

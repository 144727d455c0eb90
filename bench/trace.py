"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over a few
operations, and what the per-layer readers take from it.

``Tracer.start`` wraps the optimizer's update in a ``record_function``
range (``adamw_update``; the profiler gives a kernel to the innermost
host operation around it, so a range marks what sits under it) and turns
the benchmark's spans into ranges; ``stop`` ends the trace and reduces it
to a ``Summary``: the traced seconds, the seconds some operation ran on
the device (over the window and inside each traced step, beside the
step's own seconds), device seconds and launches by kernel name, device seconds
under each named range (by the nearest ancestor that is one), and the
longest idle gaps, each named by the innermost range or host operation
that was running at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

# Ranges whose device time the summary sums: the benchmark's operations
# and spans, and the optimizer.
RANGES = ("adamw_update", "step", "save", "restore", "retain", "wave", "cut_and_fingerprint", "serialize",
          "cluster_write", "ref_write", "read")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict            # name -> [launches, device seconds]
    under: dict              # range name -> device seconds of the kernels under it
    ranges: dict             # range name -> count
    step_busy_s: list        # device-busy seconds inside each traced step
    step_wall_s: list        # each traced step's own seconds (its host range)
    gaps: list               # [label, seconds], longest first

    def kernel_s(self, pred) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name ``pred`` takes."""
        hits = [v for k, v in self.kernels.items() if pred(k)]
        return sum(n for n, _ in hits), sum(s for _, s in hits)


class Tracer:
    def __init__(self, spans, sync):
        self.spans, self.sync = spans, sync
        self.summary: Summary | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.train import loop

        self._update = loop.adamw_update
        update = self._update

        def labelled_update(*args, **kw):
            with record_function("adamw_update"):
                return update(*args, **kw)

        loop.adamw_update = labelled_update
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.sync()
        self.prof = profile(activities=activities)
        self.prof.start()
        self.spans.profiling = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        from repro_torch.train import loop

        self.sync()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.spans.profiling = False
        loop.adamw_update = self._update
        self.summary = summarize(self.prof.events(), window_s)
        del self.prof


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(union: list[tuple[float, float]], a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def summarize(events, window_s: float) -> Summary:
    """Reduce the profiler's events (times in microseconds) to a Summary."""
    dev = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == dev]
    # a record_function range also shows on the device's timeline as a user
    # annotation spanning its kernels: it is no device operation
    device = [e for e in events if e.device_type != dev and not getattr(e, "is_user_annotation", False)
              and e.name not in RANGES]
    kernels: dict = {}
    for e in device:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    union = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_s = sum(b - a for a, b in union) / 1e6

    under = dict.fromkeys(RANGES, 0.0)
    counts = dict.fromkeys(RANGES, 0)
    for e in host:
        if e.name in counts:
            counts[e.name] += 1
        own = sum(k.duration for k in e.kernels) / 1e6 if e.kernels else 0.0
        if not own:
            continue
        up = e
        while up is not None and up.name not in under:
            up = up.cpu_parent
        if up is not None:
            under[up.name] += own
    steps = [e for e in host if e.name == "step"]
    step_busy = [_covered(union, e.time_range.start, e.time_range.end) / 1e6 for e in steps]
    step_wall = [(e.time_range.end - e.time_range.start) / 1e6 for e in steps]

    # idle gaps between the device's busy intervals, named by what the host ran
    gaps = []
    if union:
        starts = sorted((e.time_range.start, -(e.time_range.end - e.time_range.start), e) for e in host)
        for (_, b), (c, _) in zip(union[:-1], union[1:]):
            gaps.append((c - b, b, c))
        gaps.sort(key=lambda g: -g[0])
        named = []
        for length, b, c in gaps[:10]:
            mid = (b + c) / 2
            label = "host: no operation"
            i = bisect.bisect_right([s[0] for s in starts], mid)
            inner = [s[2] for s in starts[:i] if s[2].time_range.end >= mid]
            if inner:
                ranged = [e.name for e in inner if e.name in under]
                label = " > ".join(ranged[-1:] + ([inner[-1].name] if inner[-1].name not in under else []))
            named.append([label, length / 1e6])
        gaps = named
    return Summary(window_s, busy_s, kernels, under, counts, step_busy, step_wall, gaps)

"""Seconds a save spends in the cluster's ticks (in-flight copies landed,
asynchronous commit-flag flips drained): the program's ``cluster.tick``
spans below the save, summed per save, over the saves in the window that the
profiler did not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.tick")

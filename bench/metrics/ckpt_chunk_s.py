"""Seconds a save spends cutting its objects into chunks on the host: the
program's ``cluster.chunk`` spans (``chunk_object`` over each write wave,
``WriteBackCache``), summed per save, over the saves in the window that the
profiler did not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.chunk")

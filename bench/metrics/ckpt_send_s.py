"""Seconds a save spends sending chunk ops to the nodes, which store them on
their replicas and update their CITs: the program's ``cluster.send`` spans,
one per target node's ``ChunkOpBatch`` (and fallback resend), summed over
nodes and per save, over the saves in the window that the profiler did not
see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.send")

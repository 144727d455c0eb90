"""Seconds a save spends planning its write waves (OMAP lookups, chunk
placement, first-writer dedup): the program's ``cluster.plan`` spans
(``DedupCluster._wave_plan``), summed per save, over the saves in the window
that the profiler did not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.plan")

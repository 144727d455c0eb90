"""Seconds a save spends committing its objects (the OMAP puts): the program's
``cluster.commit`` spans (``DedupCluster._wave_commit``), summed per save,
over the saves in the window that the profiler did not see
(``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.commit")

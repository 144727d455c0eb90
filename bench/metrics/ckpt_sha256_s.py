"""Seconds a save spends fingerprinting its chunks with SHA-256 on the host:
the program's ``cluster.sha256`` spans (``fingerprint_many`` over each write
wave), summed per save, over the saves in the window that the profiler did
not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "cluster.sha256")

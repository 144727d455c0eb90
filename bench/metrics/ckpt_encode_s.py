"""Seconds a save spends turning host leaves into stored bytes: the program's
``ckpt.encode`` spans (the numpy view, ``tobytes``, the header join in
``_serialize_leaf``), summed per save, over the saves in the window that the
profiler did not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "ckpt.encode")

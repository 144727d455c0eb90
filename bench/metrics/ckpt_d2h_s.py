"""Seconds a save spends bringing the leaves it writes onto the host: the
program's ``ckpt.d2h`` spans (each leaf's ``.contiguous().cpu()`` in
``_serialize_leaf``), summed per save, over the saves in the window that the
profiler did not see (``_spans.stage_s``)."""

from bench.metrics import _spans


def read(run):
    return _spans.stage_s(run, "ckpt.d2h")

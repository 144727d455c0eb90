"""Seconds a save spends serializing leaves to host bytes: the benchmark's
spans around each leaf's serialization, summed per save, over the saves
in the window that the profiler did not see."""


def read(run):
    return run.mean_span("save", "serialize")

"""Seconds of a save's device wave (the cut and fingerprint kernels and the
rows between them): the benchmark's span around the checkpointer's wave,
between device synchronizations, over the saves in the window that the
profiler did not see."""


def read(run):
    return run.mean_span("save", "wave")

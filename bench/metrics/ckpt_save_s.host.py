"""Seconds the job stalls for a checkpoint: the seconds of every save in the
window that the profiler did not see (host clock between device
synchronizations) over their number. A per-layer metric: the host paces
it, and its runs spread too far for an end-to-end bound (see PERF.md)."""


def read(run):
    return run.mean_seconds("save")

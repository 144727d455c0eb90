"""Seconds a save spends in the host cluster's batched write (chunking,
fingerprints, placement, replica writes, commit): the benchmark's span
around ``DedupCluster.write_objects``, over the saves in the window that
the profiler did not see."""


def read(run):
    return run.mean_span("save", "cluster_write")

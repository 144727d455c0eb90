"""Seconds from the process's start to the window's start: imports, the
kernel build where the checkout has none yet, weights and state, the
followed steps, the mix's set-up operations."""


def read(run):
    return run.setup_s

"""The 95th percentile of every train step's milliseconds in the window
(host clock, each step ending in the loss's ``.item()``); nearest rank."""

import math


def read(run):
    ms = sorted(r.s * 1e3 for r in run.ops("step"))
    if len(ms) < 20:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]

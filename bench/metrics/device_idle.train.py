"""The device's idle share of a train step, in percent, all from the trace:
1 - the seconds in which some operation ran on the device inside the
traced steps over those steps' own wall seconds (their host ranges in the
same trace)."""


def read(run):
    t = run.trace
    if t is None or not t.step_wall_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - sum(t.step_busy_s) / sum(t.step_wall_s))

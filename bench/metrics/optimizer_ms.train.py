"""Device milliseconds a step spends in the optimizer: the kernels under the
``adamw_update`` range (by their host operation's nearest named ancestor)
over the traced steps."""


def read(run):
    t = run.trace
    if t is None or not t.ranges.get("step") or not t.busy_s:
        return None
    return 1e3 * t.under["adamw_update"] / t.ranges["step"]

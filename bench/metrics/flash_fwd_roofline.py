"""The flash forward kernel's share of its roofline, in percent: the least
time its calls could take at the step's shapes (``_arith.flash_bound_ms``,
the larger of the visible pairs' FLOPs over the bf16 peak and q, k, v and
the output over the HBM rate, per call) over the device time of the
kernels named ``flash_fwd`` in the trace."""

from bench.metrics import _arith as A


def read(run):
    t = run.trace
    if t is None:
        return None
    calls, seconds = t.kernel_s(lambda name: "flash_fwd" in name)
    if not calls or not seconds:
        return None
    q, k, v = A.attention_shapes(run.m)
    return 100.0 * calls * max(A.flash_bound_ms(q, k, v, True, 0)) / 1e3 / seconds

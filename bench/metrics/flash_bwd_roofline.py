"""The flash backward kernels' share of their roofline, in percent: the
least time the backward calls could take at the step's shapes
(``_arith.flash_bwd_bound_ms`` per call; a call is one ``flash_bwd_dq``
launch) over the device time of every kernel named ``flash_bwd`` (delta,
dK / dV, their head-split sum, dQ) in the trace."""

from bench.metrics import _arith as A


def read(run):
    t = run.trace
    if t is None:
        return None
    calls, _ = t.kernel_s(lambda name: "flash_bwd_dq" in name)
    _, seconds = t.kernel_s(lambda name: "flash_bwd" in name)
    if not calls or not seconds:
        return None
    q, k, v = A.attention_shapes(run.m)
    return 100.0 * calls * max(A.flash_bwd_bound_ms(q, k, v, True, 0)) / 1e3 / seconds

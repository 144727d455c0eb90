"""The cut-positions kernels' share of their roofline, in percent, over the
traced saves: each save's wave bytes read once and its cut slots and
counts written once over the HBM rate (``_arith.cut_bound_ms``'s bytes
bound) over the device time of the kernels named ``cdc_phase``."""

from bench.metrics import _arith as A


def read(run):
    t = run.trace
    saves = run.traced_ops("save")
    if t is None or not saves:
        return None
    _, seconds = t.kernel_s(lambda name: "cdc_phase" in name)
    if not seconds:
        return None
    bound_ms = sum(A.cut_bound_ms(w["bytes"], w["m_cut"], w["streams"])[0] for w in (r.info["wave"] for r in saves))
    return 100.0 * bound_ms / 1e3 / seconds

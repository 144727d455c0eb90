"""The fingerprint kernels' share of their roofline, in percent, over the
traced saves: each save's chunk bytes read once and its fingerprints
written once over the HBM rate (``_arith.fp_bound_ms``'s bytes bound) over
the device time of the kernels named ``fp_accumulate`` and ``fp_finalize``."""

from bench.metrics import _arith as A


def read(run):
    t = run.trace
    saves = run.traced_ops("save")
    if t is None or not saves:
        return None
    _, seconds = t.kernel_s(lambda name: "fp_accumulate" in name or "fp_finalize" in name)
    if not seconds:
        return None
    bound_ms = sum(A.fp_bound_ms(w["bytes"], w["chunks"], w["width"])[0] for w in (r.info["wave"] for r in saves))
    return 100.0 * bound_ms / 1e3 / seconds

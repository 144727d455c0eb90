"""The steps' share of the card's bf16 peak: model FLOPs of the untraced
steps in the window (``_arith.model_flop_per_step``: products, attention's
visible pairs, Mamba-2's state-space products; no recompute) over their
wall seconds (host clock) and the 989 TFLOP/s peak, in percent."""

from bench.metrics import _arith as A


def read(run):
    steps = run.untraced("step")
    if not steps:
        return None
    flop = A.model_flop_per_step(run.m, run.config["family"]) * len(steps)
    return 100.0 * flop / sum(r.s for r in steps) / A.BF16_FLOP_PER_S

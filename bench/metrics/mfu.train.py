"""The steps' share of the card's bf16 peak: model FLOPs of the untraced
steps in the window (the family file's ``model_flop_per_step``: products,
attention's visible pairs, Mamba-2's state-space products; no recompute)
over their wall seconds (host clock) and the 989 TFLOP/s peak, in percent."""

from bench.families import family
from bench.metrics import _arith as A


def read(run):
    steps = run.untraced("step")
    if not steps:
        return None
    flop = family(run.config["family"]).model_flop_per_step(run.m) * len(steps)
    return 100.0 * flop / sum(r.s for r in steps) / A.BF16_FLOP_PER_S

"""The grouped expert kernels' share of their roofline, in percent.

The kernels are the grouped GEMMs of the MoE layer's experts, picked from
the trace by name (``is_grouped``: CUTLASS's grouped problem shape and the
launch's argument setup, ``torch._grouped_mm``'s two kernels on a Hopper
card); one launch is one grouped product over one layer call's rows. The
rows are the rows actually routed to the held experts: the program's
``moe.rows`` tally (``repro_torch.obs``), one value a layer call outside the
backward pass, summed over the calls in the window and divided by their
number. Each launch's bound is the larger of its FLOPs (2 x rows x
d_model x expert_d_ff) over the bf16 peak and its bytes over the HBM rate:
the held experts' weights (held x d_model x expert_d_ff), the rows in and
the rows out (rows x (d_model + expert_d_ff)), each once, in bf16. Reads
None where the trace has no grouped kernel or the program keeps no tally.
"""

from bench.metrics import _arith as A

GEMM = "GroupProblemShape"
SETUP = "prepare_grouped_gemm_data"


def is_grouped(name: str) -> bool:
    return GEMM in name or SETUP in name


def launch_bound_s(rows: float, m: dict) -> float:
    """Seconds one grouped product over ``rows`` rows needs at least."""
    d, f = m["d_model"], m["expert_d_ff"]
    held = m.get("n_held_experts") or m["n_experts"]
    flop = 2.0 * rows * d * f
    nbytes = 2.0 * (held * d * f + rows * (d + f))
    return max(flop / A.BF16_FLOP_PER_S, nbytes / A.HBM_BYTES_PER_S)


def window_rows(run, log=None) -> float | None:
    """Mean rows routed to the held experts per layer call in the window."""
    if log is None:
        try:
            from repro_torch import obs as log
        except ImportError:
            return None
    if not hasattr(log, "tallies") or not run.records:
        return None
    t0, t1 = run.records[0].t0, run.records[-1].t1
    rows = [v[0] for t, v in log.tallies("moe.rows") if t0 <= t <= t1]
    return sum(rows) / len(rows) if rows else None


def read(run, log=None):
    t = run.trace
    if t is None:
        return None
    launches, _ = t.kernel_s(lambda name: GEMM in name)
    _, seconds = t.kernel_s(is_grouped)
    rows = window_rows(run, log)
    if not launches or not seconds or rows is None:
        return None
    return 100.0 * launches * launch_bound_s(rows, run.m) / seconds

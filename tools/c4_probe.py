"""A pytest plugin for ``tools/c4_diagnose.py --probe-file``: while
``test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]`` runs
in its file's order, every flash call is also computed by the plain version
on the same inputs (the largest |kernel - plain| per call is kept), and
every attention output and block output of the test's three prefills (the
kernel route and the witness on the card, then the CPU) is kept, so that
each layer of each card route is held against the CPU's; every float32
product on the CPU is held against the same product in float64, and the
CPU's thread count and matmul precision settings are kept; right after the
test, its comparisons are made again in the same process. One JSON line per
run of the test goes to ``probe.jsonl`` in ``$C4_PROBE_OUT`` (default
``results/c4/``).

    PYTHONPATH=src:tools python -m pytest -p c4_probe -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

OUT = Path(os.environ.get("C4_PROBE_OUT", Path(__file__).resolve().parents[1] / "results" / "c4")) / "probe.jsonl"
TARGET = "test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]"


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if item.name != TARGET:
        yield
        return
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention_plain
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    flags = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "float32_matmul_precision": torch.get_float32_matmul_precision(),
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "threads": torch.get_num_threads(), "cpus": len(os.sched_getaffinity(0))}
    for name in ("fp32_precision", "mkldnn.fp32_precision", "mkldnn.matmul.fp32_precision",
                 "cuda.matmul.fp32_precision"):
        obj = torch.backends
        for part in name.split("."):
            obj = getattr(obj, part, None)
        flags[name] = obj
    calls, kept = [], {"mha": [], "block": []}
    cpu_dense = []  # largest |fp32 - fp64| / max|fp64| of each CPU product
    orig_flash, orig_mha, orig_block, orig_dense = ops.flash_attention, L.mha, T.block_fwd, L.dense

    def dense(p, x):
        y = orig_dense(p, x)
        if x.device.type == "cpu" and x.dtype == torch.float32:
            want = orig_dense(L.Dense(p.w.double(), None if p.b is None else p.b.double()), x.double())
            cpu_dense.append(float((y.double() - want).abs().max() / want.abs().max()))
        return y

    def flash(q, k, v, **kw):
        out = orig_flash(q, k, v, **kw)
        calls.append(_max_abs(out, flash_attention_plain(q, k, v, **kw)))
        return out

    def mha(*args, **kw):
        out = orig_mha(*args, **kw)
        kept["mha"].append((out[0] if isinstance(out, tuple) else out).detach().float().cpu())
        return out

    def block(*args, **kw):
        out = orig_block(*args, **kw)
        kept["block"].append(out[0].detach().float().cpu())
        return out

    ops.flash_attention, L.mha, T.block_fwd, L.dense = flash, mha, block, dense
    try:
        outcome = yield
    finally:
        ops.flash_attention, L.mha, T.block_fwd, L.dense = orig_flash, orig_mha, orig_block, orig_dense
    failed = outcome.excinfo is not None
    layers = {}
    for name, outs in kept.items():
        if len(outs) == 9:  # kernel route, witness, CPU; 3 layers each
            layers[name] = {"kernel_vs_cpu": [_max_abs(outs[i], outs[6 + i]) for i in range(3)],
                            "witness_vs_cpu": [_max_abs(outs[3 + i], outs[6 + i]) for i in range(3)],
                            "kernel_vs_witness": [_max_abs(outs[i], outs[3 + i]) for i in range(3)]}
        else:
            layers[name] = f"{len(outs)} calls"
    import c4_diagnose

    again = c4_diagnose.measure(1)["max_abs_err_and_most_elements_beyond"]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps({"failed": failed, "error": str(outcome.excinfo[1])[:400] if failed else None,
                            "flags": flags, "flash_vs_plain_max_abs": calls, "layers": layers,
                            "cpu_dense_rel_err_max": max(cpu_dense, default=None), "cpu_dense_calls": len(cpu_dense),
                            "measured_again": again}) + "\n")

"""A pytest plugin for ``tools/c4_diagnose.py --probe``: while
``test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]`` runs
in its file's order, every operation of the CPU route's prefill (the route
that moves, ROADMAP C4) is recorded by reference: ``rms_norm``, ``dense``,
``apply_rope`` and ``chunked_attention`` with their inputs and outputs. The
hooks compute nothing. When the case fails, each recorded operation is made
again in float64 from its own recorded inputs, and its own error (max
|float32 - float64| over max |float64|) is reported in call order, so the
first operation far off the others is the one whose result moved. One JSON
line per run of the case goes to ``probe.jsonl`` in ``$C4_PROBE_OUT``
(default ``results/c4/``); the session stops after the case.

    PYTHONPATH=src:tools python -m pytest -p c4_probe tests/test_torch_cuda.py::<cases up to the C4 case>
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import pytest

OUT = Path(os.environ.get("C4_PROBE_OUT", Path(__file__).resolve().parents[1] / "results" / "c4")) / "probe.jsonl"
TARGET = "test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]"


def _d(t):
    return t.detach().double()


def _float64(name: str, args: tuple, kw: dict):
    """The recorded operation in float64 from its recorded inputs."""
    import torch

    if name == "rms_norm":
        p, x, eps = args[0], _d(args[1]), args[2] if len(args) > 2 else kw.get("eps", 1e-6)
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _d(p.scale)
    if name == "dense":
        p, x = args
        y = _d(x) @ _d(p.w)
        return y if p.b is None else y + _d(p.b)
    if name == "apply_rope":
        x, positions, theta = _d(args[0]), args[1], args[2]
        hd = x.shape[-1]
        freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
        ang = positions.double()[..., None] * freqs
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    # chunked_attention(qg (B, Sq, K, R, hd), k, v, causal, window, mask_offset, scale, ...)
    qg, k, v = _d(args[0]), _d(args[1]), _d(args[2])
    s = torch.einsum("bqkrh,bskh->bkrqs", qg, k) * kw["scale"]
    sq, skv = qg.shape[1], k.shape[1]
    qpos = torch.arange(sq)[:, None] + kw["mask_offset"]
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if kw["causal"]:
        ok &= torch.arange(skv)[None, :] <= qpos
    w = torch.softmax(s.masked_fill(~ok, -math.inf), -1)
    return torch.movedim(torch.einsum("bkrqs,bskh->bkrqh", w, v), 3, 1)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if item.name != TARGET:
        yield
        return
    from repro_torch.models import layers as L

    calls = []
    names = ("rms_norm", "dense", "apply_rope", "chunked_attention")
    orig = {n: getattr(L, n) for n in names}

    def hook(name):
        def fn(*args, **kw):
            out = orig[name](*args, **kw)
            first = args[1] if name in ("rms_norm", "dense") else args[0]
            if first.device.type == "cpu":
                calls.append((name, args, kw, out))
            return out
        return fn

    for n in names:
        setattr(L, n, hook(n))
    try:
        outcome = yield
    finally:
        for n, fn in orig.items():
            setattr(L, n, fn)
    rec = {"failed": outcome.excinfo is not None, "cpu_calls": len(calls)}
    if rec["failed"]:
        rec["error"] = str(outcome.excinfo[1])[-900:]
        errs = []
        for i, (name, args, kw, out) in enumerate(calls):
            try:
                want = _float64(name, args, kw)
                errs.append([i, name, float((_d(out) - want).abs().max() / want.abs().max())])
            except Exception as e:  # the probe reports; it must not hide the case's own result
                errs.append([i, name, f"{type(e).__name__}: {e}"])
        rec["local_errors_in_call_order"] = errs
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    item.session.shouldstop = "c4_probe: stopped after the case"

#!/usr/bin/env python3
"""Measure where chip_smoke.py's phase-9 decode-vs-prefill checks sit, and
what the bfloat16 gaps come from, for Qwen1.5-MoE-A2.7B and Mamba2-1.3B.

    python3 tools/phase9_decode_drift.py [--seeds 0 1]

Run from the root of the repository on a machine with a CUDA card and nvcc.
Each model is built at full width and depth with random weights and tokens
from each seed, and runs phase 9's traffic; one JSON line per run:

- Qwen1.5-MoE-A2.7B, bfloat16 (``chip_smoke.moe_traffic``): the last
  decode step against a fresh prefill as the model routes it, and with the
  traffic's expert choices replayed, with how many expert ids differ;
- Mamba2-1.3B (``chip_smoke.family_traffic``: 8,064 positions, 128 decode
  steps, a fresh prefill of 8,192), bfloat16 and float32, and on the first
  seed ``conv_fp32_accumulated`` (bfloat16: the prefills' causal
  convolution sums its four products in float32 and rounds once, as the
  decode's einsum does) and two faults planted in the decode at run time
  (no file changes), in float32: ``mamba_state_dropped`` (each decode step
  starts from a zero SSD state) and ``mamba_conv_not_advanced`` (the conv
  window keeps the prompt's last inputs).

The last line says whether every sound float32 run is within
``chip_smoke.DECODE_REL_LIMIT["float32"]``, every MoE replayed bf16 run
within the bf16 limit, and every planted fault beyond the float32 limit;
the exit code is 0 when all three hold. The plain bfloat16 gaps are
reported, not judged.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def conv_fp32_accumulated(orig):
    import torch.nn.functional as F

    def conv(xbc, w, b):
        k = w.shape[0]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        y = sum(pad[:, i : i + xbc.shape[1], :].float() * w[i].float()[None, None, :] for i in range(k))
        return F.silu(y.to(xbc.dtype) + b[None, None, :])
    return conv


def mamba_state_dropped(orig):
    def decode(p, s, u, state, conv_state):
        state.zero_()
        return orig(p, s, u, state, conv_state)
    return decode


def mamba_conv_not_advanced(orig):
    def decode(p, s, u, state, conv_state):
        kept = conv_state.clone()
        out = orig(p, s, u, state, conv_state)
        conv_state.copy_(kept)
        return out
    return decode


@contextlib.contextmanager
def patched(mod, name, wrap):
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def run(arch: str, dtype, seed: int, patch=None) -> dict:
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked", param_dtype=dtype)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(seed)
    model = build_model(cfg)
    params = model.init(gen)
    with patched(*patch) if patch else contextlib.nullcontext():
        if arch == chip_smoke.MOE_ARCH:
            tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.PREFILL_CACHE), generator=gen, device=gen.device)
            traffic = chip_smoke.moe_traffic(model, params, tokens, chip_smoke.PREFILL_TOKENS, chip_smoke.PREFILL_CACHE)
        else:
            tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.MAMBA_TOKENS), generator=gen, device=gen.device)
            traffic = chip_smoke.family_traffic(model, params, tokens, chip_smoke.MAMBA_PREFILL, chip_smoke.MAMBA_TOKENS)
            del traffic["logits"]
    del traffic["caches"], model, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return traffic


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("phase9_decode_drift: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from repro_torch.models import ssm

    limit = chip_smoke.DECODE_REL_LIMIT
    ok = {"float32_sound": True, "moe_bf16_replayed": True, "faults_caught": True}

    def show(r, **tags):
        r.update(tags)
        print(json.dumps(r), flush=True)

    for seed in args.seeds:
        r = run(chip_smoke.MOE_ARCH, torch.bfloat16, seed)
        ok["moe_bf16_replayed"] &= r["decode_vs_replayed_prefill_rel_err"] < limit["bfloat16"]
        show(r, arch=chip_smoke.MOE_ARCH, dtype="bfloat16", seed=seed, variant="sound")
    for dt, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for seed in args.seeds:
            r = run(chip_smoke.MAMBA_ARCH, dtype, seed)
            if dt == "float32":
                ok["float32_sound"] &= r["decode_vs_prefill_rel_err"] < limit[dt]
            show(r, arch=chip_smoke.MAMBA_ARCH, dtype=dt, seed=seed, variant="sound")
    seed = args.seeds[0]
    r = run(chip_smoke.MAMBA_ARCH, torch.bfloat16, seed, (ssm, "_causal_conv", conv_fp32_accumulated))
    show(r, arch=chip_smoke.MAMBA_ARCH, dtype="bfloat16", seed=seed, variant="conv_fp32_accumulated")
    for fault in (mamba_state_dropped, mamba_conv_not_advanced):
        r = run(chip_smoke.MAMBA_ARCH, torch.float32, seed, (ssm, "mamba_decode", fault))
        r["caught"] = r["decode_vs_prefill_rel_err"] >= limit["float32"]
        ok["faults_caught"] &= r["caught"]
        show(r, arch=chip_smoke.MAMBA_ARCH, dtype="float32", seed=seed, variant=fault.__name__)
    print(json.dumps({"ok": all(ok.values()), **ok, "limit": limit}))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

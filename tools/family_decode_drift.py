#!/usr/bin/env python3
"""Measure how far chip_smoke.py's decode-vs-prefill check on the
sliding-window families sits from its limits, and show that it tells a
sound cache or RG-LRU state from a slightly wrong one.

    python3 tools/family_decode_drift.py [--seeds 0 1 2 3]

Run from the root of the repository on a machine with a CUDA card and nvcc.
For Gemma3-12B and RecurrentGemma-2B at full width and depth
(``attn_impl="chunked"``, random weights and tokens from each seed) it runs
``chip_smoke.family_traffic``: a prefill of 8,192 tokens into 8,200-slot
caches, 8 teacher-forced decode steps, and a fresh prefill of all 8,200
tokens that the last decode step's logits are held against (relative max
error). It does so for every seed in bfloat16 and in float32. Then, on the
first seed:

- ``conv_fp32_accumulated`` (RecurrentGemma-2B, bfloat16): the prefill's
  causal convolution sums its four products in float32 and rounds once, as
  the decode's einsum does; whether that difference drives the bfloat16
  gap;
- three faults planted in the decode, patched in at run time (no file is
  changed), in both dtypes: ``rglru_state_dropped`` (every decode step
  starts the RG-LRU from a zero state), ``rglru_conv_not_advanced`` (the
  convolution's window keeps the prompt's last inputs) and
  ``ring_oldest_key_dropped`` (every local-attention decode step masks the
  oldest key of its window, 1 of 1,024 or 2,048).

It prints one JSON line per run. The last line says, for each dtype,
whether every sound run is inside ``chip_smoke.DECODE_REL_LIMIT``, and
whether every planted fault is beyond the float32 limit. The exit code is
0 when the float32 check passes every sound run and fails every fault: that
check is the one that tells the two apart; the bfloat16 margin is reported,
not judged.
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

ARCHS = ("gemma3-12b", "recurrentgemma-2b")


def conv_fp32_accumulated(orig):
    import torch.nn.functional as F

    def conv(xbc, w, b):
        k = w.shape[0]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        y = sum(pad[:, i : i + xbc.shape[1], :].float() * w[i].float()[None, None, :] for i in range(k))
        return F.silu(y.to(xbc.dtype) + b[None, None, :])
    return conv


def rglru_state_dropped(orig):
    def decode(p, s, u, hstate, conv_state):
        hstate.zero_()
        return orig(p, s, u, hstate, conv_state)
    return decode


def rglru_conv_not_advanced(orig):
    def decode(p, s, u, hstate, conv_state):
        kept = conv_state.clone()
        out = orig(p, s, u, hstate, conv_state)
        conv_state.copy_(kept)
        return out
    return decode


def ring_oldest_key_dropped(orig):
    def decode(p, cfg, h, cache, pos):
        cache["pos_idx"][(pos + 1) % cfg.window] = -1  # the oldest slot still in the window
        return orig(p, cfg, h, cache, pos)
    return decode


def patches():
    """Variant name -> (the archs it applies to, [(module, attribute, wrapper)])."""
    from repro_torch.models import ssm, transformer

    return {
        "conv_fp32_accumulated": (("recurrentgemma-2b",), [(ssm, "_causal_conv", conv_fp32_accumulated)]),
        "rglru_state_dropped": (("recurrentgemma-2b",), [(ssm, "rglru_decode", rglru_state_dropped)]),
        "rglru_conv_not_advanced": (("recurrentgemma-2b",), [(ssm, "rglru_decode", rglru_conv_not_advanced)]),
        "ring_oldest_key_dropped": (ARCHS, [(transformer, "_local_decode", ring_oldest_key_dropped)]),
    }


@contextlib.contextmanager
def patched(edits):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in edits]
    try:
        for mod, name, wrap in edits:
            setattr(mod, name, wrap(getattr(mod, name)))
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def run(arch: str, dtype, seed: int, edits=()) -> dict:
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked", param_dtype=dtype)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(seed)
    model = build_model(cfg)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.PREFILL_CACHE), generator=gen, device=gen.device)
    with patched(edits):
        traffic = chip_smoke.family_traffic(model, params, tokens, chip_smoke.PREFILL_TOKENS, chip_smoke.PREFILL_CACHE)
    del traffic["caches"], traffic["logits"], model, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return traffic


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("family_decode_drift: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke

    limit = chip_smoke.DECODE_REL_LIMIT
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    within = {dt: True for dt in dtypes}
    caught = True
    for arch in ARCHS:
        for dt, dtype in dtypes.items():
            for seed in args.seeds:
                r = run(arch, dtype, seed)
                r.update(arch=arch, dtype=dt, seed=seed, variant="sound", limit=limit[dt])
                within[dt] = within[dt] and r["decode_vs_prefill_rel_err"] < limit[dt]
                print(json.dumps(r), flush=True)
        for variant, (archs, edits) in patches().items():
            if arch not in archs:
                continue
            for dt, dtype in dtypes.items():
                if variant == "conv_fp32_accumulated" and dt == "float32":
                    continue
                r = run(arch, dtype, args.seeds[0], edits)
                r.update(arch=arch, dtype=dt, seed=args.seeds[0], variant=variant, limit=limit[dt])
                if variant != "conv_fp32_accumulated" and dt == "float32":
                    r["caught"] = r["decode_vs_prefill_rel_err"] >= limit[dt]
                    caught = caught and r["caught"]
                print(json.dumps(r), flush=True)
    ok = within["float32"] and caught
    print(json.dumps({"ok": ok, "sound_within_limit": within, "faults_caught_in_float32": caught, "limit": limit}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

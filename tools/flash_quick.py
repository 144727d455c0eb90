#!/usr/bin/env python3
"""Check and time the flash-attention kernel alone, without the model.

    python3 tools/flash_quick.py [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about a minute, most of it the build). It builds
``src/repro_torch/csrc/flash_attn.cu``, holds the bf16 kernel against its
plain version (``chip_smoke.FLASH_RTOL``) at head dims 128, 64 and 32 on
four small cases each and at the prefill's shape (random q (1, 8192, 40,
128) and k/v (1, 8192, 8, 128) from ``--seed``, causal), then times the
kernel and ``scaled_dot_product_attention`` there (``chip_smoke._timed``,
10 calls each). It prints the build seconds, the ptxas report, the
comparisons and one JSON line of times, and exits 1 if any element lies
beyond the limit. ``chip_smoke.py`` measures the kernel on the model's
own layer-0 inputs; this is the quicker loop for work on the kernel.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_quick: torch sees no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    t = time.perf_counter()
    _build.load("flash_attn")
    print("build_s", time.perf_counter() - t, flush=True)
    print(_build.ptxas_reports.get("flash_attn"), flush=True)
    check = chip_smoke.FlashCheck(strict=False)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def qkv(b, sq, skv, h, kh, hd):
        shapes = ((b, sq, h, hd), (b, skv, kh, hd), (b, skv, kh, hd))
        return [torch.randn(s, generator=gen, device="cuda").bfloat16() for s in shapes]

    for hd in (128, 64, 32):
        for sq, skv, causal, window in ((128, 128, False, 0), (257, 257, True, 0), (300, 300, True, 100),
                                        (257, 129, True, 0)):
            check(*qkv(1, sq, skv, 4, 2, hd), causal=causal, window=window,
                  what=f"hd {hd} Sq {sq} Skv {skv} causal {causal} window {window}")
            torch.cuda.synchronize()
        print(f"hd {hd}: {check.cases} cases, {check.mismatches} beyond, {check.failed}, "
              f"max ratio {check.max_err_ratio}", flush=True)
    q, k, v = qkv(1, 8192, 8192, 40, 8, 128)
    check(q, k, v, causal=True, window=0, what="the prefill's shape")
    torch.cuda.synchronize()
    print(f"prefill shape: {check.mismatches} beyond, {check.failed}, max ratio {check.max_err_ratio}", flush=True)
    ms = chip_smoke._timed(lambda: flash_attention_cuda(q, k, v), 10)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa_ms = chip_smoke._timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    ops_ms, _ = chip_smoke.flash_bound_ms(q, k, True, 0)
    print(json.dumps({"ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": ops_ms,
                      "tflops": ops_ms / ms * chip_smoke.BF16_FLOP_PER_S * 1e-12}))
    return 1 if check.mismatches else 0


if __name__ == "__main__":
    sys.exit(main())

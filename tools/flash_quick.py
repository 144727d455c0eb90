#!/usr/bin/env python3
"""Check and time the flash-attention kernel alone, without the model.

    python3 tools/flash_quick.py [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about a minute, most of it the build). It builds
``src/repro_torch/csrc/flash_attn.cu``, holds the bf16 kernel against its
plain version (``chip_smoke.FLASH_RTOL``) at head dims 256, 128, 64 and 32
and at MLA's (qk 96, v 64) on four small cases each (head dims 256 and
(96, 64) also in float32), and at four layer shapes, random from
``--seed``: Qwen2.5-32B's prefill (q (1, 8192, 40, 128), k/v (1, 8192, 8,
128), causal), Gemma3-12B's two (q (1, 8192, 16, 256), k/v (1, 8192, 8,
256), causal with window 1024 and without) and MiniCPM3-4B's (q and k (1,
8192, 40, 96), v (1, 8192, 40, 64), causal). At each it times the kernel and
``scaled_dot_product_attention`` (``chip_smoke._timed``, 10 calls each;
``chip_smoke.library_attention_ms``: a boolean band mask for the window,
the fastest backend that takes the call). It prints the build seconds, the
ptxas report, the comparisons and one JSON line of times, and exits 1 if
any element lies beyond the limit. ``chip_smoke.py`` measures the kernel
on the models' own inputs; this is the quicker loop for work on the
kernel.
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

    def qkv(b, sq, skv, h, kh, hd, dtype=torch.bfloat16, vd=None):
        shapes = ((b, sq, h, hd), (b, skv, kh, hd), (b, skv, kh, vd or hd))
        return [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in shapes]

    cases = ((128, 128, False, 0), (257, 257, True, 0), (300, 300, True, 100), (257, 129, True, 0))
    for hd, vd, dtype in ((256, 256, torch.bfloat16), (256, 256, torch.float32), (128, 128, torch.bfloat16),
                          (64, 64, torch.bfloat16), (32, 32, torch.bfloat16), (96, 64, torch.bfloat16),
                          (96, 64, torch.float32)):
        for sq, skv, causal, window in cases:
            check(*qkv(1, sq, skv, 4, 2, hd, dtype, vd), causal=causal, window=window,
                  what=f"hd {hd}/{vd} {dtype} Sq {sq} Skv {skv} causal {causal} window {window}")
            torch.cuda.synchronize()
        print(f"hd {hd}/{vd} {dtype}: {check.cases} cases, {check.mismatches} beyond, {check.failed}, "
              f"max ratio {check.max_err_ratio}", flush=True)
    times = {}
    for name, h, kh, hd, vd, window in (("qwen2.5-32b", 40, 8, 128, 128, 0), ("gemma3-12b global", 16, 8, 256, 256, 0),
                                        ("gemma3-12b local", 16, 8, 256, 256, 1024), ("minicpm3-4b", 40, 40, 96, 64, 0)):
        q, k, v = qkv(1, 8192, 8192, h, kh, hd, vd=vd)
        check(q, k, v, causal=True, window=window, what=name)
        torch.cuda.synchronize()
        print(f"{name}: {check.mismatches} beyond, {check.failed}, max ratio {check.max_err_ratio}", flush=True)
        ms = chip_smoke._timed(lambda: flash_attention_cuda(q, k, v, window=window), 10)
        sdpa_ms, backend = chip_smoke.library_attention_ms(q, k, v, window, 10)
        ops_ms, _ = chip_smoke.flash_bound_ms(q, k, v, True, window)
        times[name] = {"ms": ms, "sdpa_ms": sdpa_ms, "sdpa_backend": backend, "bound_ms": ops_ms,
                       "tflops": ops_ms / ms * chip_smoke.BF16_FLOP_PER_S * 1e-12}
        del q, k, v
    print(json.dumps(times))
    return 1 if check.mismatches else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel alone, without a model.

    python3 tools/flash_bwd_quick.py [--seed 0] [--no-shapes]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about two minutes, the build included). It builds
``src/repro_torch/csrc/flash_attn.cu`` and ``flash_attn_bwd.cu`` side by
side and prints the backward's ptxas report (registers, spills). Then
``chip_smoke.py``'s phase-5 backward grid (``flash_bwd_grid_phase``:
every comparison runs to its end; the forward kernel's lse against the
plain one, dq, dk and dv against ``ref.flash_attention_bwd_plain``) and,
unless ``--no-shapes``, each model's train shape (``flash_bwd_entry``:
checked in float32 and bf16, timed beside the plain twin and
``scaled_dot_product_attention``'s backward). It prints one JSON line per
part and exits 1 if any element lies beyond the limits. ``chip_smoke.py``
runs the same checks in phase 5; this is the quicker loop for work on the
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
    ap.add_argument("--no-shapes", action="store_true", help="the grid only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from repro_torch.kernels import _build

    t = time.perf_counter()
    jobs = {name: _build._start(name) for name in ("flash_attn", "flash_attn_bwd")}
    for name, job in jobs.items():
        if job is not None:
            _build._finish(name, job)
        _build.load(name)
    print("build_s", time.perf_counter() - t, flush=True)
    for line in (_build.ptxas_reports.get("flash_attn_bwd") or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    check = chip_smoke.FlashBwdCheck(strict=False)
    t = time.perf_counter()
    chip_smoke.flash_bwd_grid_phase(check, gen)
    print("grid " + json.dumps({"s": time.perf_counter() - t, "cases": check.cases, "mismatches": check.mismatches,
                                "lse_mismatches": check.lse_mismatches, "failed": check.failed,
                                "max_err_ratio": check.max_err_ratio, "max_abs_err": check.max_abs_err,
                                "max_lse_err": check.max_lse_err}), flush=True)
    if not args.no_shapes:
        for name, h, kh, dqk, dv, window in chip_smoke.TRAIN_ATTENTION_SHAPES:
            before = check.mismatches
            entry = chip_smoke.flash_bwd_entry(check, h, kh, dqk, dv, window, gen)
            print(f"{name} " + json.dumps({**entry, "mismatches": check.mismatches - before,
                                           "max_err_ratio": check.max_err_ratio}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"ok": check.mismatches == 0, "cases": check.cases, "mismatches": check.mismatches,
                      "failed": check.failed}))
    return 0 if check.mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

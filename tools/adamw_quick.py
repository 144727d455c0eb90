#!/usr/bin/env python3
"""Phase 4f of ``chip_smoke.py`` alone: the AdamW kernels held bitwise
against the plain update and timed, at the benchmark's two leaf sets.

    python3 tools/adamw_quick.py [--seed 0] [--reps 5] [--archs llava-next-mistral-7b,mamba2-1.3b]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about a minute). Builds ``src/repro_torch/csrc/adamw.cu``, then for each
arch at 8 layers (the benchmark cells' depth: 2.01 B parameters for
LLaVA-NeXT-Mistral-7B, 0.31 B for Mamba2-1.3B) runs
``chip_smoke.adamw_phase``: one train step's fp32 gradients, then
``chip_smoke.adamw_row``'s launch count, bitwise check and times (the
kernels, the plain route, ``torch._fused_adamw_`` and the byte bound).
Prints one JSON line an arch and the card's name and power limit; exits 1
on any failed check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=C.ADAMW_REPS)
    ap.add_argument("--archs", default=f"{C.TRAIN_ARCH},mamba2-1.3b")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("adamw_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    _build.load("adamw")
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in args.archs.split(","):
        row = C.adamw_phase(arch, C.ADAMW_LAYERS, args.seed, args.reps)
        print("adamw " + json.dumps(row), flush=True)
        if row["left_allocated_bytes"]:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Train phases of ``chip_smoke.py`` alone (4c and 4d unless ``--arch``
names another arch of ``chip_smoke.TRAIN_PHASES``): the quick loop for work
on the train path.

    python3 tools/train_families_quick.py [--seed 0] [--arch qwen2-moe-a2.7b] [--layers N]

Builds the kernels, reads the fingerprint kernel's integer operations per
word from its SASS (for the bound), then runs ``chip_smoke.train_phase``
for each phase (at ``--layers`` if given) and prints its line and its
seconds; exits 1 on any failed check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_families_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path("fingerprint"))],
                          capture_output=True, text=True, check=True).stdout
    fp_ops_per_word = C.sass_ops_per_word(sass, "fp_accumulate")[1]
    for _, arch, published, layers, traffic in C.TRAIN_PHASES:
        if arch != args.arch and (args.arch or traffic is C.train_traffic):
            continue
        t = time.perf_counter()
        line = C.train_phase(arch, published, args.layers or layers, args.seed, fp_ops_per_word, traffic)
        print("train_family " + json.dumps(line), flush=True)
        C._check(line["left_allocated_bytes"] == 0, f"{arch} left {line['left_allocated_bytes']} B on the card")
        print(f"{arch}: {time.perf_counter() - t:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

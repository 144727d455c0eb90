#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, at reduced depth: the quick loop
for work on the mesh layer.

    python3 tools/mesh_quick.py [--layers 4] [--seed 0] [--no-dryrun]

Builds the kernels, puts full-width Qwen2.5-32B at ``--layers`` layers on
the card (``attn_impl="chunked"``, random bf16 weights), then on a (1, 1)
mesh runs ``chip_smoke.mesh_prefill_phase`` (8,192 tokens, bitwise against
the plain prefill, one flash launch a layer, both profiled) and
``chip_smoke.mesh_save_phase`` (phase 3's layer re-saved as DTensors), and
the two dry runs of phase 11a (``chip_smoke.start_dry_runs``,
``chip_smoke.dry_run_records``). Prints their JSON lines;
exits 1 on any failed check. About 2 minutes with its build on an H100.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-dryrun", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mesh_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(dataclasses.replace(get_config("qwen2.5-32b"), attn_impl="chunked", n_layers=args.layers))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init(gen)
    rows = [{"name": n, "launches_by_path": {}, "mismatches": 0, "max_abs_err": 0}
            for n in ("cdc_cut_positions_cuda", "fingerprint_chunks_cuda")]
    with C.one_by_one_mesh() as mesh:
        print("mesh_prefill " + json.dumps(C.mesh_prefill_phase(model, params, mesh, gen)), flush=True)
        print("mesh_save " + json.dumps(C.mesh_save_phase(args.seed, mesh, rows)), flush=True)
    print("rows " + json.dumps(rows))
    if not args.no_dryrun:
        t = time.perf_counter()
        for rec in C.dry_run_records(C.start_dry_runs()):
            print("dryrun " + json.dumps(rec))
        print(f"dry runs: {time.perf_counter() - t:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

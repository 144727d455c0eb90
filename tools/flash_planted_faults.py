#!/usr/bin/env python3
"""Show that chip_smoke.py's flash check catches faults in the late query
rows of a long causal prefill, where each output row averages thousands of
value rows and its elements are small.

    python3 tools/flash_planted_faults.py [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc.
It builds ``src/repro_torch/csrc/flash_attn.cu`` as it stands and three
mutants of it, each made in a temporary directory by one text edit that
acts on the second half of the query tiles only, in the float32 kernel's
KV loop and in the KV tile walk (``walk_kv_tiles``) that the bfloat16
kernel's TMA producer and its two consumer warpgroups share, so the
three stay in step on the ring and a mutant drops the tile instead of
deadlocking:

- ``drop_last_tile``: skip the last visible KV tile (the diagonal one when
  causal);
- ``drop_first_tile``: skip the first visible KV tile;
- ``drop_middle_tile``: skip the middle one.

With each build it runs chip_smoke.py's phase-5 grid and its layer-0 check
at the prefill's shape: layer 0 of Qwen2.5-32B at full width (one layer
built, random weights from ``--seed``), 8,192 tokens, causal. Every
comparison runs to its end and counts the elements beyond
``chip_smoke.FLASH_RTOL`` (and, on the layer-0 check, the elements
beyond the reference's fixed 3e-2, for comparison). It prints one JSON
line per build and exits non-zero unless the sound build passes every
comparison and each mutant fails both the grid and the layer-0 check.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# The KV loops a mutant edits: flash_fwd_simt's, and walk_kv_tiles's (the
# bf16 kernel's producer and consumers both walk their tiles through it).
LOOPS = (
    "  for (int64_t t = t_lo; t < t_hi; ++t) {\n    const int64_t kv0 = t * kBN;\n",
    "  for (int t = t_lo; t < t_hi; ++t) {\n",
)
# The reference's fixed bf16 tolerance (|err| <= 3e-2 + 3e-2 * |plain|), counted
# beside FLASH_RTOL on the layer-0 check for comparison.
FIXED_TOL = 3e-2
MUTANTS = {
    "drop_last_tile": "t_hi - 1",
    "drop_first_tile": "t_lo",
    "drop_middle_tile": "(t_lo + t_hi) / 2",
}


def mutant_source(src: str, skip: str) -> str:
    """``src`` with tile ``skip`` left out of both kernels' KV walks for the
    query tiles in the second half of the rows."""
    for loop in LOOPS:
        assert src.count(loop) == 1, "a KV loop of flash_attn.cu changed: update LOOPS"
        src = src.replace(loop, loop + f"    if (q0 >= a.Sq / 2 && t == {skip}) continue;\n")
    return src


def load_library(path: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES["flash_attn"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run_checks(seed: int, q, k, v) -> dict:
    """The phase-5 grid and the layer-0 check with the loaded build."""
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attn import flash_attention_plain

    grid = chip_smoke.FlashCheck(strict=False)
    chip_smoke.flash_grid_phase(grid, torch.Generator(device="cuda").manual_seed(seed))
    layer0 = chip_smoke.FlashCheck(strict=False)
    got = layer0(q, k, v, causal=True, window=0, what="layer 0 of the prefill").float()
    exp = flash_attention_plain(q, k, v, causal=True, window=0).float()
    beyond_fixed = int((~((got - exp).abs() <= FIXED_TOL + FIXED_TOL * exp.abs())).sum())
    return {
        "grid_cases": grid.cases, "grid_cases_failed": len(grid.failed), "grid_mismatches": grid.mismatches,
        "grid_failed": grid.failed, "grid_max_err_ratio": grid.max_err_ratio,
        "layer0_mismatches": layer0.mismatches, "layer0_elements": q.numel(),
        "layer0_max_err_ratio": layer0.max_err_ratio["bfloat16"],
        "layer0_max_abs_err": layer0.max_abs_err["bfloat16"],
        "layer0_beyond_fixed_3e-2": beyond_fixed, "layer0_plain_abs_median": float(exp.abs().median()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_planted_faults: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    src = (_build.CSRC / "flash_attn.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, skip in MUTANTS.items():
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(mutant_source(src, skip))
            jobs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        sound = _build.load("flash_attn")
        libs = {"sound": sound}
        for name, (so, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for mutant {name}:\n{log}")
            libs[name] = load_library(so)

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cfg = dataclasses.replace(get_config("qwen2.5-32b"), attn_impl="chunked", n_layers=1)
        model = build_model(cfg)
        params = model.init(gen)
        tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.PREFILL_TOKENS), generator=gen, device=dev)
        q, k, v = chip_smoke.layer0_qkv(params, cfg, tokens)
        del params
        torch.cuda.empty_cache()

        results = {}
        for name, lib in libs.items():
            _build._loaded["flash_attn"] = lib
            results[name] = run_checks(args.seed, q, k, v)
            print(f"{name} " + json.dumps(results[name]))
        _build._loaded["flash_attn"] = sound

    ok = results["sound"]["grid_mismatches"] == 0 and results["sound"]["layer0_mismatches"] == 0
    for name in MUTANTS:
        ok = ok and results[name]["grid_mismatches"] > 0 and results[name]["layer0_mismatches"] > 0
    print(json.dumps({"ok": ok, "rtol": chip_smoke.FLASH_RTOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

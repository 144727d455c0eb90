#!/usr/bin/env python3
"""Show that chip_smoke.py's flash check catches faults in the late query
rows of a long causal prefill, where each output row averages thousands of
value rows and its elements are small, at every head dim the models run.

    python3 tools/flash_planted_faults.py [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc.
It builds ``src/repro_torch/csrc/flash_attn.cu`` as it stands and five
mutants of it, each made in a temporary directory by text edits that act
on the second half of the query tiles where they can. The three tile
mutants edit the float32 kernel's KV loop and the bfloat16 kernel's
consumers, which treat the tile as one to skip: they still wait for it and
release its ring stage, so the producer (or at head dim 256 the loading
consumer) stays in step and a mutant drops the tile instead of
deadlocking:

- ``drop_last_tile``: skip the last visible KV tile (the diagonal one when
  causal);
- ``drop_first_tile``: skip the first visible KV tile;
- ``drop_middle_tile``: skip the middle one.

Two act on the head-dim-256 instance of the bfloat16 kernel alone:

- ``self_load_previous_tile``: the loading consumer fetches tile t + 1
  where the ring wants t + 2, so stages hold the wrong keys and values
  (barriers and counts as in the sound kernel);
- ``drop_pv_high_half``: O += P V skips its second n128 product, columns
  128..255 of O.

With each build it runs chip_smoke.py's phase-5 grid and the layer
checks at the prefills' shapes, each on a layer built at full width from
random weights (``--seed``) and 8,192 tokens: layer 0 of Qwen2.5-32B
(head dim 128, causal, bfloat16), the first local layer of Gemma3-12B
(head dim 256) causal with window 1024 and without, in bfloat16 and
float32, and layer 0 of MiniCPM3-4B (qk head dim 96, v head dim 64,
causal; ``chip_smoke.mla_layer0_qkv``) in bfloat16 and float32. Every
comparison runs to its end and counts the elements beyond
``chip_smoke.FLASH_RTOL`` (and, on the Qwen2.5-32B check, the elements
beyond the reference's fixed 3e-2, for comparison). It prints one JSON
line per build and exits non-zero unless the sound build passes every
comparison, each tile mutant fails the grid and every layer check, and
each head-dim-256 mutant fails every Gemma3-12B bfloat16 check.

The backward kernel (``src/repro_torch/csrc/flash_attn_bwd.cu``) gets four
mutants of its own, each made by one text edit that acts on its bf16 and
float32 kernels alike:

- ``bwd_dkdv_drop_last_query_tile``: a dK / dV block skips the last query
  tile that can see its keys;
- ``bwd_dkdv_drop_first_tile_of_last_head``: it skips the first query tile
  of the last query head of its group (a GQA sum missing one head's part);
- ``bwd_dq_drop_last_kv_tile`` and ``bwd_dq_drop_first_kv_tile``: a dQ
  block skips its last or its first kv tile.

With the sound backward and each mutant it runs ``chip_smoke.py``'s
phase-5 backward grid and the backward checks at each model's train shape
(``chip_smoke.TRAIN_ATTENTION_SHAPES``: Sq = Skv = 4,096, random inputs
from ``--seed``) in bf16 and float32, counting the elements beyond
``chip_smoke.FLASH_BWD_RTOL``. The sound build must pass every check and
each mutant must fail the grid and every train-shape check in both
dtypes: that is what sets the bf16 rtol.
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

# What the tile mutants edit: flash_fwd_simt's KV loop, and the bf16
# kernel's consumers' tile kind (``{skip}``: the tile to drop).
SIMT_LOOP = "  for (int64_t t = t_lo; t < t_hi; ++t) {\n    const int64_t kv0 = t * kBN;\n"
TILE_KIND = "kind = tile_kind<T::kBN>(r_lo, r_hi, kv0, skv, causal, win);"
TILE_KIND_MUTANT = "kind = (q0 >= a.Sq / 2 && t == {skip}) ? kSkip : tile_kind<T::kBN>(r_lo, r_hi, kv0, skv, causal, win);"
# The edits of the head-dim-256 mutants: (text, replacement).
HD256_MUTANTS = {
    "self_load_previous_tile": ("load_tile(t + kStages, stage);",
                                "load_tile(q0 >= a.Sq / 2 ? t + kStages - 1 : t + kStages, stage);"),
    "drop_pv_high_half": ("wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), pa[kk], db_hi);", ""),
}
# The reference's fixed bf16 tolerance (|err| <= 3e-2 + 3e-2 * |plain|), counted
# beside FLASH_RTOL on the layer-0 check for comparison.
FIXED_TOL = 3e-2
TILE_MUTANTS = {
    "drop_last_tile": "t_hi - 1",
    "drop_first_tile": "t_lo",
    "drop_middle_tile": "(t_lo + t_hi) / 2",
}


# The backward mutants: (loop header, the line each adds at the top of the
# loop). Each header opens one loop of the float32 kernel and one of the
# bf16 kernel.
DKDV_LOOP = "    for (int64_t qt = qt_lo; qt < qt_hi; ++qt) {\n"
DQ_LOOP = "  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {\n"
BWD_MUTANTS = {
    "bwd_dkdv_drop_last_query_tile": (DKDV_LOOP, "      if (qt == qt_hi - 1) continue;\n"),
    "bwd_dkdv_drop_first_tile_of_last_head": (DKDV_LOOP, "      if (hr == rep - 1 && qt == qt_lo) continue;\n"),
    "bwd_dq_drop_last_kv_tile": (DQ_LOOP, "    if (kt == kt_hi - 1) continue;\n"),
    "bwd_dq_drop_first_kv_tile": (DQ_LOOP, "    if (kt == kt_lo) continue;\n"),
}


def _replace_once(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"flash_attn.cu changed: {old!r} is not there once"
    return src.replace(old, new)


def bwd_mutant_source(src: str, name: str) -> str:
    """The backward's source with mutant ``name``'s edit in both kernels."""
    loop, line = BWD_MUTANTS[name]
    assert src.count(loop) == 2, f"flash_attn_bwd.cu changed: {loop!r} is not there twice"
    return src.replace(loop, loop + line)


def mutant_source(src: str, name: str) -> str:
    """``src`` with mutant ``name``'s edits."""
    if name in HD256_MUTANTS:
        return _replace_once(src, *HD256_MUTANTS[name])
    skip = TILE_MUTANTS[name]
    src = _replace_once(src, SIMT_LOOP, SIMT_LOOP + f"    if (q0 >= a.Sq / 2 && t == {skip}) continue;\n")
    return _replace_once(src, TILE_KIND, TILE_KIND_MUTANT.format(skip=skip))


def load_library(path: Path, name: str = "flash_attn") -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def layer_check(check, q, k, v, window: int, what: str, fixed: bool = False) -> dict:
    """One layer check with the loaded build: elements beyond
    ``FLASH_RTOL``, the worst ratio and error, and with ``fixed`` the
    elements beyond the reference's fixed 3e-2."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention_plain

    got = check(q, k, v, causal=True, window=window, what=what).float()
    dt = "float32" if q.dtype == torch.float32 else "bfloat16"
    out = {"mismatches": check.mismatches, "elements": got.numel(), "max_err_ratio": check.max_err_ratio[dt],
           "max_abs_err": check.max_abs_err[dt]}
    if fixed:
        exp = flash_attention_plain(q, k, v, causal=True, window=window).float()
        out["beyond_fixed_3e-2"] = int((~((got - exp).abs() <= FIXED_TOL + FIXED_TOL * exp.abs())).sum())
        out["plain_abs_median"] = float(exp.abs().median())
    return out


def run_checks(seed: int, layers: dict) -> dict:
    """The phase-5 grid and the layer checks with the loaded build."""
    import torch

    import chip_smoke

    grid = chip_smoke.FlashCheck(strict=False)
    chip_smoke.flash_grid_phase(grid, torch.Generator(device="cuda").manual_seed(seed))
    out = {"grid_cases": grid.cases, "grid_cases_failed": len(grid.failed), "grid_mismatches": grid.mismatches,
           "grid_failed": grid.failed, "grid_max_err_ratio": grid.max_err_ratio}
    for name, (q, k, v, window) in layers.items():
        out[name] = layer_check(chip_smoke.FlashCheck(strict=False), q, k, v, window, name,
                                fixed=name.startswith("qwen"))
    return out


def run_bwd_checks(seed: int) -> dict:
    """The phase-5 backward grid and the train-shape backward checks in bf16
    and float32 with the loaded backward build, every comparison to its
    end."""
    import torch

    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grid = chip_smoke.FlashBwdCheck(strict=False)
    chip_smoke.flash_bwd_grid_phase(grid, gen)
    out = {"grid_cases": grid.cases, "grid_cases_failed": len(grid.failed), "grid_mismatches": grid.mismatches,
           "grid_max_err_ratio": grid.max_err_ratio}
    for name, h, kh, dqk, dv, window in chip_smoke.TRAIN_ATTENTION_SHAPES:
        s = chip_smoke.TRAIN_SEQ
        shapes = ((1, s, h, dqk), (1, s, kh, dqk), (1, s, kh, dv))
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes)
        for dt, args in (("bf16", (q, k, v)), ("fp32", (q.float(), k.float(), v.float()))):
            check = chip_smoke.FlashBwdCheck(strict=False)
            check(*args, causal=True, window=window, gen=gen, what=f"{name}, {dt}")
            out[f"{name}, {dt}"] = {"mismatches": check.mismatches, "max_err_ratio": check.max_err_ratio}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def layer_inputs(arch: str, n_layers: int, kind: str, gen) -> tuple:
    """q, k, v of the first ``kind`` layer of ``arch`` at full width, one
    pattern group built, from ``PREFILL_TOKENS`` random tokens."""
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked", n_layers=n_layers)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.PREFILL_TOKENS), generator=gen, device=gen.device)
    qkv = chip_smoke.layer0_qkv(params, cfg, tokens, cfg.block_pattern.index(kind))
    del params
    torch.cuda.empty_cache()
    return qkv, cfg


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
    bwd_src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name in [*TILE_MUTANTS, *HD256_MUTANTS, *BWD_MUTANTS]:
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(bwd_mutant_source(bwd_src, name) if name in BWD_MUTANTS else mutant_source(src, name))
            jobs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        sound = _build.load("flash_attn")
        sound_bwd = _build.load("flash_attn_bwd")
        libs, bwd_libs = {"sound": sound}, {"sound": sound_bwd}
        for name, (so, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for mutant {name}:\n{log}")
            if name in BWD_MUTANTS:
                bwd_libs[name] = load_library(so, "flash_attn_bwd")
            else:
                libs[name] = load_library(so)

        gen = torch.Generator(device=torch.device("cuda")).manual_seed(args.seed)
        (q, k, v), _ = layer_inputs("qwen2.5-32b", 1, "attn_global", gen)
        layers = {"qwen2.5-32b layer 0, bf16": (q, k, v, 0)}
        (q, k, v), gcfg = layer_inputs("gemma3-12b", 6, "attn_local", gen)
        for window in (gcfg.window, 0):
            layers[f"gemma3-12b window {window}, bf16"] = (q, k, v, window)
            layers[f"gemma3-12b window {window}, fp32"] = (q.float(), k.float(), v.float(), window)
        mcfg = dataclasses.replace(get_config(chip_smoke.MLA_ARCH), attn_impl="chunked", n_layers=1)
        params = build_model(mcfg).init(gen)
        tokens = torch.randint(0, mcfg.vocab, (1, chip_smoke.PREFILL_TOKENS), generator=gen, device=gen.device)
        q, k, v = chip_smoke.mla_layer0_qkv(params, mcfg, tokens)
        layers["minicpm3-4b layer 0, bf16"] = (q, k, v, 0)
        layers["minicpm3-4b layer 0, fp32"] = (q.float(), k.float(), v.float(), 0)
        del q, k, v, params, tokens
        torch.cuda.empty_cache()

        results = {}
        for name, lib in libs.items():
            _build._loaded["flash_attn"] = lib
            results[name] = run_checks(args.seed, layers)
            print(f"{name} " + json.dumps(results[name]), flush=True)
        _build._loaded["flash_attn"] = sound
        bwd_results = {}
        for name, lib in bwd_libs.items():
            _build._loaded["flash_attn_bwd"] = lib
            bwd_results[name] = run_bwd_checks(args.seed)
            print(f"backward {name} " + json.dumps(bwd_results[name]), flush=True)
        _build._loaded["flash_attn_bwd"] = sound_bwd

    caught = lambda r, names: all(r[n]["mismatches"] > 0 for n in names)
    gemma_bf16 = [n for n in layers if n.startswith("gemma3") and n.endswith("bf16")]
    verdict = {"sound": results["sound"]["grid_mismatches"] == 0 and
               all(results["sound"][n]["mismatches"] == 0 for n in layers)}
    for name in TILE_MUTANTS:
        verdict[name] = results[name]["grid_mismatches"] > 0 and caught(results[name], layers)
    for name in HD256_MUTANTS:
        verdict[name] = caught(results[name], gemma_bf16)
    shapes = [k for k in bwd_results["sound"] if k.endswith(("bf16", "fp32"))]
    verdict["bwd_sound"] = bwd_results["sound"]["grid_mismatches"] == 0 and \
        all(bwd_results["sound"][k]["mismatches"] == 0 for k in shapes)
    for name in BWD_MUTANTS:
        verdict[name] = bwd_results[name]["grid_mismatches"] > 0 and caught(bwd_results[name], shapes)
    ok = all(verdict.values())
    print(json.dumps({"ok": ok, "verdict": verdict, "rtol": chip_smoke.FLASH_RTOL,
                      "bwd_rtol": chip_smoke.FLASH_BWD_RTOL,
                      "bwd_sound_max_err_ratio": {k: v["max_err_ratio"] for k, v in bwd_results["sound"].items()
                                                  if k in shapes}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

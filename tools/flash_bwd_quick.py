#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel alone, without a model.

    python3 tools/flash_bwd_quick.py [--seed 0] [--no-shapes] [--profile] [--src DIR]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about two minutes, the build included). It builds
``src/repro_torch/csrc/flash_attn.cu`` and ``flash_attn_bwd.cu`` side by
side and prints the backward's ptxas report (registers, spills). Then
``chip_smoke.py``'s phase-5 backward grid (``flash_bwd_grid_phase``:
every comparison runs to its end; the forward kernel's lse against the
plain one, dq, dk and dv against ``ref.flash_attention_bwd_plain``) and,
unless ``--no-shapes``, each model's train shape (``flash_bwd_entry``:
checked in float32 and bf16, timed beside the plain twin and
``scaled_dot_product_attention``'s backward). With ``--profile`` each
shape's line also holds the bf16 call's device ms by kernel
(``torch.profiler``, three calls: the delta pass, dK / dV, a head split's
sum, dQ). With ``--src DIR`` (the root of another checkout, e.g. an
unpacked ``git archive`` of the parent in a git-ignored directory) it
also builds that tree's ``flash_attn_bwd.cu`` and times the two bf16
backwards at each train shape in turns (other, this, this, other: the
same inputs, ``chip_smoke._timed``), as ``ab_ms``. It prints one JSON
line per part and exits 1 if any element lies beyond the limits. ``chip_smoke.py``
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


def profile_bwd(h: int, kh: int, dqk: int, dv: int, window: int, gen) -> dict:
    """Device ms per call of each kernel of the bf16 backward at a train
    shape (random inputs), by ``chip_smoke.profile_calls`` over 3 calls."""
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda, flash_attention_cuda

    s = chip_smoke.TRAIN_SEQ
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((1, s, h, dqk), (1, s, kh, dqk), (1, s, kh, dv)))
    o, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    dout = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window)
    prof = chip_smoke.profile_calls(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window), 3)
    by_kernel = {}
    for name, (ms, _) in prof["by_name"].items():
        key = next((k for k in ("delta", "dkdv_sum", "dkdv_wgmma", "dq_wgmma") if f"flash_bwd_{k}" in name), None)
        if key:  # not the range annotations of the wrapper's record_function
            by_kernel[key] = by_kernel.get(key, 0.0) + ms
    return {**by_kernel, "total": sum(by_kernel.values())}


def ab_ms(other, h: int, kh: int, dqk: int, dv: int, window: int, gen) -> dict:
    """ms of this tree's bf16 backward and of the library ``other`` (another
    tree's build) at a train shape, timed in turns: other, this, this,
    other."""
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda, flash_attention_cuda

    s = chip_smoke.TRAIN_SEQ
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((1, s, h, dqk), (1, s, kh, dqk), (1, s, kh, dv)))
    o, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    dout = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    here = _build.load("flash_attn_bwd")
    out = {"other_ms": [], "here_ms": []}
    for lib, key in ((other, "other_ms"), (here, "here_ms"), (here, "here_ms"), (other, "other_ms")):
        _build._loaded["flash_attn_bwd"] = lib
        out[key].append(chip_smoke._timed(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window), 10))
    _build._loaded["flash_attn_bwd"] = here
    return out


def build_other(src: Path, tmp: Path):
    """The backward library of the tree at ``src``, built into ``tmp``."""
    import subprocess

    from flash_planted_faults import load_library
    from repro_torch.kernels import _build

    csrc = src / "src" / "repro_torch" / "csrc"
    so = tmp / "other_flash_attn_bwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(csrc / "flash_attn_bwd.cu")],
                   check=True, capture_output=True)
    return load_library(so, "flash_attn_bwd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-shapes", action="store_true", help="the grid only")
    ap.add_argument("--profile", action="store_true", help="device ms by kernel at each train shape")
    ap.add_argument("--src", type=Path, help="another tree whose backward to time beside this one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import tempfile

    import chip_smoke
    from repro_torch.kernels import _build

    sys.path.insert(0, str(ROOT / "tools"))
    tmp = tempfile.TemporaryDirectory()
    other = build_other(args.src.resolve(), Path(tmp.name)) if args.src else None
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
            if args.profile:
                entry["device_ms_by_kernel"] = profile_bwd(h, kh, dqk, dv, window, gen)
            if other is not None:
                entry["ab_ms"] = ab_ms(other, h, kh, dqk, dv, window, gen)
            print(f"{name} " + json.dumps({**entry, "mismatches": check.mismatches - before,
                                           "max_err_ratio": check.max_err_ratio}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"ok": check.mismatches == 0, "cases": check.cases, "mismatches": check.mismatches,
                      "failed": check.failed}))
    return 0 if check.mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

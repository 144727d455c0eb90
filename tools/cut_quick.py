#!/usr/bin/env python3
"""Check and time the CDC kernels alone, without the checkpointer: the cut
kernel and the window-hash kernel.

    python3 tools/cut_quick.py [--seed 0] [--src DIR]

Run from the root of the repository on a machine with a CUDA card and nvcc
(about a minute). It builds ``src/repro_torch/csrc/cdc.cu`` only and runs
the cut stage on two waves:

* the main path's wave: the 13 leaves of one full-width Qwen2.5-32B decoder
  layer, bf16, random from ``--seed`` on the card, laid out as
  ``chip_smoke.decoder_layer_shapes`` lays them out (975,220,736 B), under
  the checkpointer's default chunking (512 KiB target, 256 KiB..1 MiB);
* ``chip_smoke.bitmap_route_wave``: 64 MiB whose largest stream has more
  candidates than the kernel's candidate list holds.

Each wave's cuts are held against the plain torch twin on the same inputs
(exact), the call is timed with ``chip_smoke._timed`` (10 calls, CUDA
events) and profiled with ``torch.profiler`` (10 calls): device time per
call by kernel (phase A, phase B, fills, memsets, copies), the wall time
per call and the host gap between them. It prints one JSON line per wave.

Then the window-hash kernel (``cdc_hashes_cuda``) on the main path's
largest leaf (an FFN weight, 283,115,520 B): held against
``cdc_hashes_plain`` (exact), timed the same way, with its rate in GB/s
over the 5 bytes per position it must move (1 read, 4 written) and its
bound, and beside them the time of ``.to(torch.int32)`` on the same bytes
(the same traffic, no hashing). It prints one JSON line for it, the
card's name and power limit, and exits 1 on any mismatch.

``--src`` measures another source tree (a ``git archive`` of an earlier
commit unpacked into a git-ignored directory), for parent / change runs in
one call. A tree from before the cut kernel wrote positions is measured
through its mask wrapper, ``cdc_cut_masks_cuda``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 10


# Kinds of device work in a call, by a part of their names in the profile.
KINDS = {"phase_a": "cdc_phase_a", "phase_b": "cdc_phase_b", "hash": "cdc_hashes", "scatter": "index_put",
         "fill": "Fill", "memset": "Memset", "copy_htod": "Memcpy HtoD", "copy_dtoh": "Memcpy DtoH"}


def profile(fn) -> dict:
    """``chip_smoke.profile_calls`` with the device ms per call by kind."""
    import chip_smoke

    prof = chip_smoke.profile_calls(fn, REPS)
    prof["ms"] = {kind: chip_smoke.device_ms_of(prof, pattern) for kind, pattern in KINDS.items()}
    prof["ms"]["other"] = prof["device_ms_per_call"] - sum(prof["ms"].values())
    return prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the source tree to measure")
    args = ap.parse_args()

    import chip_smoke  # puts this checkout's src on the path: --src goes before it

    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("cut_quick: torch sees no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
    from repro_torch.kernels import _build, cdc, ops

    print("measuring", Path(cdc.__file__).resolve(), flush=True)
    t = time.perf_counter()
    _build.load("cdc")
    print("build_s", time.perf_counter() - t, flush=True)
    print(_build.ptxas_reports.get("cdc"), flush=True)
    positions = hasattr(cdc, "cdc_cut_positions_cuda")
    dev = torch.device("cuda")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tree = chip_smoke.materialize(
        chip_smoke.decoder_layer_shapes(**chip_smoke.QWEN2_5_32B),
        lambda s: torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16),
    )
    main_streams = [ops.tensor_to_u8(a) for _, a in _leaf_paths(tree)]
    spec = CheckpointConfig().resolved_chunk_spec()
    bitmap_streams, bitmap_kw = chip_smoke.bitmap_route_wave(args.seed, dev)
    waves = (("main path", main_streams, spec.kernel_kwargs()), ("bitmap route", bitmap_streams, bitmap_kw))

    bad = 0
    for what, streams, kw in waves:
        nbytes = sum(int(s.numel()) for s in streams)
        if positions:
            fn = lambda: cdc.cdc_cut_positions_cuda(streams, **kw)  # noqa: E731
            routes_before = dict(cdc.cdc_cut_positions_cuda.routes)
            got = fn()
            routes = {k: v - routes_before[k] for k, v in cdc.cdc_cut_positions_cuda.routes.items()}
            t = time.perf_counter()
            exp = cdc.cdc_cut_positions_plain(streams, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            mismatches = sum(
                int((g != e).sum()) + int((gn, gk) != (en, ek))
                for (g, gn, gk), (e, en, ek) in zip(got, exp)
            )
            n_cuts = sum(r[1] for r in got)
            m_cut = sum(int(r[0].numel()) for r in got)
            bound_ms = max(chip_smoke.cut_bound_ms(nbytes, m_cut, len(streams)))
        else:
            fn = lambda: cdc.cdc_cut_masks_cuda(streams, **kw)  # noqa: E731
            got = fn()
            routes = None
            t = time.perf_counter()
            exp = cdc.cdc_cut_masks_plain(streams, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            mismatches = sum(int((g != e).sum()) for g, e in zip(got, exp))
            n_cuts = sum(int(g.sum()) for g in got)
            bound_ms = None
        del got, exp
        bad += mismatches
        ms = chip_smoke._timed(fn, REPS)
        line = {"wave": what, "streams": len(streams), "bytes": nbytes, "kw": kw,
                "output": "positions" if positions else "mask", "n_cuts": n_cuts,
                "mismatches": mismatches, "routes": routes, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "profile": profile(fn)}
        print(json.dumps(line), flush=True)

    big = max(main_streams, key=lambda s: s.numel())
    n = int(big.numel())
    fn = lambda: cdc.cdc_hashes_cuda(big)  # noqa: E731
    got = fn()
    t = time.perf_counter()
    exp = cdc.cdc_hashes_plain(big)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    mismatches = int((got.view(torch.int32) != exp.view(torch.int32)).sum())
    del got, exp
    bad += mismatches
    ms = chip_smoke._timed(fn, REPS)
    prof = profile(fn)
    bound_bytes = 5 * n / chip_smoke.HBM_BYTES_PER_S * 1e3
    bound_ops = chip_smoke.HASH_OPS_PER_BYTE * n / chip_smoke.INT32_OPS_PER_S * 1e3
    # A yardstick with the same traffic: widening the bytes to int32.
    widen_ms = chip_smoke._timed(lambda: big.to(torch.int32), REPS)
    line = {"kernel": "window hash", "bytes": n, "mismatches": mismatches, "ms": ms,
            "device_ms": prof["ms"]["hash"], "gb_per_s": 5 * n / ms * 1e-6,
            "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
            "widen_to_int32_ms": widen_ms, "profile": prof}
    print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

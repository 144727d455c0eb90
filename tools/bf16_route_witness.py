#!/usr/bin/env python3
"""Measure how far apart routes through the same bf16 model land, with and
without the flash kernel, to set the form of the card model test's check.

    python3 tools/bf16_route_witness.py [--seeds 0 1 2]

Run from the root of the repository on a machine with a CUDA card. The
model is the one of ``tests/test_torch_cuda.py::
test_decoder_prefill_on_card_launches_the_kernel_per_layer``: reduced
Qwen2.5-32B with 3 layers, params from the seed, tokens (2, 100) from
seeded numpy, prefill into a 120-slot cache and one decode step. Its
outputs (last-position logits, the k cache of every layer, the decode
logits) come from five routes on the same weights:

- ``card_kernel``: on the card, ``attn_impl="chunked"`` (the flash kernel);
- ``card_dense``: on the card, ``attn_impl="dense"`` (no kernel);
- ``cpu_chunked`` and ``cpu_dense``: the same on the CPU (no kernel);
- ``cpu_fp32``: the CPU chunked route with the weights cast to float32.

For each dtype (float32 and bfloat16 weights) and each pair of routes it
prints the elements beyond the elementwise limit (``atol = rtol`` = 2e-4
or 3e-2) over the three outputs, and the largest RMS of the difference
over the RMS of the second route's output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PAIRS = (
    ("card_kernel", "cpu_chunked"), ("card_dense", "cpu_chunked"), ("card_kernel", "card_dense"),
    ("cpu_chunked", "cpu_dense"), ("cpu_chunked", "cpu_fp32"),
)


def outputs(model, params, toks, dev) -> list:
    import torch

    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev)}, cache_len=120)
    logits2, _ = model.decode_step(params, caches, torch.from_numpy(toks[:, :1].copy()).to(dev), 100)
    return [t.cpu().float() for t in (logits, caches[0][0]["k"], logits2)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bf16_route_witness: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    for seed in args.seeds:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), attn_impl="chunked", n_layers=3,
                                      param_dtype=dtype)
            dense = dataclasses.replace(cfg, attn_impl="dense")
            params = build_model(cfg).init(seed)
            toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 100)).astype(np.int32)
            out = {
                "card_kernel": outputs(build_model(cfg), params, toks, "cuda"),
                "card_dense": outputs(build_model(dense), params, toks, "cuda"),
            }
            params = params.to("cpu")
            out["cpu_chunked"] = outputs(build_model(cfg, device="cpu"), params, toks, "cpu")
            out["cpu_dense"] = outputs(build_model(dense, device="cpu"), params, toks, "cpu")
            fp32 = dataclasses.replace(cfg, param_dtype=torch.float32)
            out["cpu_fp32"] = outputs(build_model(fp32, device="cpu"), params.float(), toks, "cpu")
            line = {"seed": seed, "dtype": str(dtype), "elements": sum(t.numel() for t in out["cpu_fp32"])}
            for a, b in PAIRS:
                beyond, rel_rms = 0, 0.0
                for x, y in zip(out[a], out[b]):
                    beyond += int((~((x - y).abs() <= tol + tol * y.abs())).sum())
                    rel_rms = max(rel_rms, float((x - y).square().mean().sqrt() / y.square().mean().sqrt()))
                line[f"{a}_vs_{b}"] = {"beyond_elementwise": beyond, "rel_rms": rel_rms}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

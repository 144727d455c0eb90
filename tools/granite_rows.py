#!/usr/bin/env python3
"""The Granite cell's dropless route on the card, counted two ways: the rows
the program's ``moe.rows`` tally gives for one train step, against the rows
the benchmark's float32 reference routes to the held experts from the same
weights and batch.

    python3 tools/granite_rows.py [--seed 3000000001]

Run from the root of the repository on a machine with a CUDA card (about a
minute and a half, most of it the kernel builds and the weights). The
program makes the step the benchmark's job makes first (2 microbatches x 10
layers, 20 tallied calls); then, with its state freed, the reference
(``bench/families/granitemoehybrid.py``) runs the same two microbatches
forward without grad and counts, per layer, the (token, choice) pairs its
own float32 router sends to experts 0-17. Prints one JSON line: both counts
per call, their totals, tokens x top_k x the reference's share of choices on
held experts, and the calls where the two differ (a near-tie of the 10th
and 11th expert that bf16 and float32 order differently).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3000000001)
    args = ap.parse_args()

    import torch

    from bench import weights as W
    from bench.families import family
    from bench.job import Job
    from bench.reference import models as M
    from bench.reference import train as T
    from repro_torch import obs
    from repro_torch.kernels import _build

    _build.BUILD_DIR = ROOT / "build" / "repro_torch"
    config = json.loads((ROOT / "bench" / "configs" / "granite-4.0-h-small.d10.json").read_text())
    traffic = json.loads((ROOT / "bench" / "traffic" / "train.json").read_text())
    m = config["model"]
    job = Job(config, traffic, args.seed, "cuda")
    job.build(storage=False)
    before = len(obs.tallies("moe.rows"))
    job.train_step()
    program = [int(v[0]) for _, v in obs.tallies("moe.rows")[before:]]
    job.state = job.step_fn = job.model = None
    del job
    gc.collect()
    torch.cuda.empty_cache()

    fam = family(config["family"])
    held = fam.held(m)
    counted: list[int] = []
    moe = fam.moe

    def counting(p, mm, a):
        ids = M.matmul(a.reshape(-1, a.shape[-1]), p["router"]["w"]).topk(mm["top_k"], dim=-1).indices
        counted.append(int(((ids >= held.start) & (ids < held.stop)).sum()))
        return moe(p, mm, a)

    fam.moe = counting
    M.plain_float32()
    params = T.map_tree(lambda t: t.float(), W.make_tree(m, config["family"], args.seed, "cuda"))
    batch = {k: (v.float() if v.is_floating_point() else v) for k, v in W.make_batch(m, args.seed, 0, "cuda").items()}
    with torch.no_grad():
        for mb in W.microbatches(batch, m["accum"]):
            fam.loss(params, m, mb)
    fam.moe = moe
    tokens = m["global_batch"] * m["seq_len"]
    share = sum(counted) / (tokens * m["top_k"] * m["n_layers"])
    out = {"seed": args.seed, "program": program, "reference": counted, "program_total": sum(program),
           "reference_total": sum(counted), "tokens_x_top_k_x_share": tokens * m["top_k"] * share * m["n_layers"],
           "held_share": share, "calls_differing": [i for i, (a, b) in enumerate(zip(program, counted)) if a != b]}
    print(json.dumps(out))
    return 0 if len(program) == len(counted) == m["n_layers"] * m["accum"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The readings the limits of ``bench/limits/<config>.json`` are set from.

    python3 -m bench.control --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9] [--out FILE]

For each seed of ``--seeds``: the job's first steps on the program, as a
run makes them, against the float32 reference (the lower readings). For
each seed of ``--control-seeds`` also: the control, the reference itself
in the program's place with every product's operands rounded to float8
e4m3 (a per-tensor scale), the nearest precision below the configuration's
bfloat16; and the program with half of each batch left out (its rows
replaced by copies of the others, so the mean is over the rest). Training's
readings need no measured window, so none is run. Each reading is judged
against the limits of ``bench/limits/<config>.json`` as a run judges it:
a program's reading must come out correct, the control's and the fault's
not. Prints one JSON line a reading (appended to ``--out`` too) and the
largest and smallest of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class _Float8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def float8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Float8.apply(a) @ _Float8.apply(b)


def half_batch(step_fn):
    """A train step that leaves out the second half of each batch's rows,
    training on copies of the first half in their place."""
    def step(state, batch):
        half = batch["tokens"].shape[0] // 2
        return step_fn(state, {k: torch.cat([v[:half], v[:half]]) for k, v in batch.items()})
    return step


def program_readings(config, traffic, seed, device, wrapper=None) -> dict:
    from bench.job import Job

    job = Job(config, traffic, seed, device, wrapper)
    job.build(storage=False)
    out = job.first_steps()
    job.spans.undo()
    del job
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def readings(config: dict, traffic: dict, limits: dict, seeds: list[int], control_seeds: list[int], device: str,
             out: Path | None = None) -> list[dict]:
    from bench import check
    from bench.job import FOLLOWED_STEPS
    from bench.reference import models as M

    rows = []
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        first = len(rows)
        prog = program_readings(config, traffic, seed, device)
        M.matmul = M._plain_matmul
        ref = check.reference_readings(config, seed, device, FOLLOWED_STEPS)
        if seed in seeds:
            rows.append(row(seed, "program", check.training_numbers(prog, ref), limits))
        if seed in control_seeds:
            M.matmul = float8_matmul
            ctrl = check.reference_readings(config, seed, device, FOLLOWED_STEPS)
            M.matmul = M._plain_matmul
            rows.append(row(seed, "control float8", check.training_numbers(ctrl, ref), limits))
            half = program_readings(config, traffic, seed, device, half_batch)
            rows.append(row(seed, "fault half batch", check.training_numbers(half, ref), limits))
        for r in rows[first:]:
            print(json.dumps(r), flush=True)
            if out is not None:
                with out.open("a") as f:
                    f.write(json.dumps(r) + "\n")
    return rows


def row(seed: int, kind: str, numbers: dict, limits: dict) -> dict:
    """One reading: its numbers and whether the limits judge it correct."""
    from bench import check

    ok, _ = check.judge(numbers, limits)
    return {"seed": seed, "kind": kind, "correct": ok, **{k: v for k, v in numbers.items() if not k.startswith("_")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = json.loads((ROOT / "bench" / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    limits = json.loads((ROOT / "bench" / "limits" / f"{cell['config']}.json").read_text())
    rows = readings(config, traffic, limits, seeds, control, "cuda", args.out)
    for kind in sorted({r["kind"] for r in rows}):
        sel = [r for r in rows if r["kind"] == kind]
        print(f"{kind}: correct under the limits on {sum(r['correct'] for r in sel)} of {len(sel)} seeds")
        for name in (k for k in sel[0] if k not in ("seed", "kind", "correct")):
            vals = [r[name] for r in sel]
            print(f"{kind} {name}: max {max(vals)!r} min {min(vals)!r} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

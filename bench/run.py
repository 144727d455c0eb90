"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix and limits are the
files ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``
and ``bench/limits/<config>.json``, and each metric the cell reports is
read by ``bench/metrics/<metric>.py`` (``read(run)``: a number, or None
where the run has nothing to read). A configuration's ``family`` is the
file ``bench/families/<family>.py``: its weights' layout, plain reference
loss, model FLOPs and test sizes; the program takes every ``model`` key that
is a field of its ``ModelConfig``. Adding a cell, a mix, a metric or a model
family adds files and entries; no file here changes. A
configuration of a new family is ``bench/configs/<name>.json``,
``bench/families/<family>.py``, ``bench/limits/<name>.json`` with its
``.readings.jsonl``, and its entries in ``BENCHMARK.json``.

A run builds the job (``bench.job``) from the seed, makes its first steps
(the reference follows them) and the mix's set-up operations, then repeats
the mix's cycle of operations until ``--seconds`` have passed, whole
cycles only. With ``--trace 1`` the profiler records the cycles the mix
names (``bench.trace``), and the per-layer metrics are reported; with
``--trace 0`` the end-to-end ones. Once the window has closed the device
memory peak is read, the program's state is freed, and the plain reference
decides ``correct`` (``bench.check``). Each number compared is printed
beside its limit, last on standard error and last in the result, the one
JSON line that ends standard output.

The program's kernel builds go to ``build/repro_torch/`` in the checkout
(fixed in the program); the benchmark writes nothing else to disk.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# Top-level modules no run may load: JAX, its relatives, and the JAX package
# the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start, in seconds since the epoch (from /proc)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that
    ``workload`` reports: those that list it, or list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


class RunView:
    """What a metric reader reads: the window's operation records, the
    set-up and window seconds, the trace summary (None untraced), the
    configuration, the mix, and which steps were traced."""

    def __init__(self, job, t_w0: float, t_w1: float, setup_s: float, summary, traced: tuple[float, float] | None):
        self.config, self.traffic, self.m = job.config, job.traffic, job.config["model"]
        self.records = [r for r in job.records if r.t0 >= t_w0]
        self.window_s = t_w1 - t_w0
        self.setup_s = setup_s
        self.trace = summary
        self.traced = traced

    def ops(self, kind: str) -> list:
        return [r for r in self.records if r.op == kind]

    def untraced(self, kind: str) -> list:
        """The operations of ``kind`` the profiler did not see (all of them
        in an untraced run): what host-clock readers read."""
        a, b = self.traced or (float("inf"), float("inf"))
        return [r for r in self.ops(kind) if r.t1 <= a or r.t0 >= b]

    def traced_ops(self, kind: str) -> list:
        if self.traced is None:
            return []
        a, b = self.traced
        return [r for r in self.ops(kind) if r.t0 >= a and r.t1 <= b]

    def mean_span(self, op: str, span: str) -> float | None:
        """Span ``span``'s seconds per untraced ``op``, over all of them."""
        vals = [r.spans.get(span, 0.0) for r in self.untraced(op)]
        return statistics.fmean(vals) if vals else None

    def mean_seconds(self, op: str) -> float | None:
        """The seconds of every untraced ``op`` over their number."""
        ops = self.untraced(op)
        return sum(r.s for r in ops) / len(ops) if ops else None


def window(job, traffic: dict, seconds: float, tracer) -> tuple[float, float, tuple | None]:
    """Repeat the mix's cycle until ``seconds`` have passed (whole cycles),
    tracing the cycles the mix names when ``tracer`` is given (and going on
    until they are done). Returns (start, end, traced interval)."""
    cycle, spec = traffic["cycle"], traffic.get("trace", {})
    first, last = spec.get("first_cycle", 0), spec.get("last_cycle", 0)
    sync = job._sync
    traced = None
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        for i, op in enumerate(cycle):
            if tracer is not None and n == first and i == 0:
                k = spec.get("last_steps", 0) if op["op"] == "steps" else 0
                if k:
                    job.run(op, steps=op["n"] - k)
                tracer.start()
                ta = time.perf_counter()
                job.run(op, steps=k or None)
            else:
                job.run(op)
        if tracer is not None and n == last:
            tracer.stop()
            traced = (ta, time.perf_counter())
        n += 1
        if time.perf_counter() - t0 >= seconds and (tracer is None or traced is not None):
            break
    sync()
    return t0, time.perf_counter(), traced


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, limits: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None, step_fn_wrapper=None,
             after_window=None) -> dict:
    """One run of ``cell``; returns the result line's object. Tests pass a
    CPU ``device``, a tiny configuration, and faults through
    ``step_fn_wrapper`` (wraps the train step) or ``after_window(job)``."""
    import torch

    from bench import check
    from bench.job import FOLLOWED_STEPS, Job
    from bench.trace import Tracer

    t_start = time.time() if t_start is None else t_start
    on_card = device == "cuda"
    job = Job(config, traffic, seed, device, step_fn_wrapper)
    job.build()
    program = job.first_steps()
    for op in traffic.get("setup", []):
        job.run(op)
    job.reserve_snapshots()
    tracer = Tracer(job.spans, job._sync) if trace else None
    job._sync()
    setup_s = time.time() - t_start
    t_w0, t_w1, traced = window(job, traffic, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    forbidden = loaded_forbidden()
    if forbidden:
        raise SystemExit(f"modules loaded in this run that no run may load: {forbidden}")
    if after_window is not None:
        after_window(job)
    view = RunView(job, t_w0, t_w1, setup_s, tracer.summary if tracer else None, traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell["name"], kind):
        value = reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(view.records)

    # the program's state goes before the reference runs
    job.spans.undo()
    job.state = job.step_fn = job.model = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_readings(config, seed, device, FOLLOWED_STEPS)
    numbers = check.training_numbers(program, ref)
    t_ref_done = time.perf_counter()
    if "cluster" in config:
        numbers.update(check.checkpoint_numbers(job, seed))
    ok, table = check.judge(numbers, limits)
    result = {"correct": ok, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if tracer is not None and tracer.summary is not None:
        s = tracer.summary
        result["device"].update({"busy_s": s.busy_s, "window_s": s.window_s})
        ops = sorted(([n, v[1]] for n, v in s.kernels.items()), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": ops, "idle_gaps": s.gaps[:10]}
    result["checks"] = table
    steps = sorted(r.s for r in view.ops("step"))
    result["_notes"] = {
        "setup_s": setup_s, "window_s": view.window_s, "reference_s": t_ref_done - t_ref,
        "checkpoint_check_s": time.perf_counter() - t_ref_done, "left_out_of_change": numbers["_left_out"],
        "faults": numbers.get("_faults", []),
        "steps": {"n": len(steps), "median_s": statistics.median(steps) if steps else None,
                  "max_s": steps[-1] if steps else None},
        "ops": [[r.op, r.s, r.spans] for r in view.records if r.op != "step"],
        "program": program, "reference": ref}
    return result


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return f"card: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell['config']}.json")
    # Kernel and compiler caches at fixed paths inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.BUILD_DIR = ROOT / "build" / "repro_torch"
    result = run_cell(bench, cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    notes = result.pop("_notes")
    print(power_line(), file=sys.stderr)
    print(f"notes: {json.dumps(notes, default=str)}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Diagnose the one-off float32 failure of
``tests/test_torch_cuda.py::test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]``
on a CUDA card.

    python3 tools/c4_diagnose.py [--alone 50] [--jobs 4] [--file 10] [--measure 20]
        [--upto-case] [--probe 30] [--platform] [--no-racecheck]

* ``--alone N``: the case alone, N pytest processes, ``--jobs`` at a time;
* ``--file M``: the whole card-test file in its order, M times, one after
  the other; every failing case is listed;
* ``--upto-case``: with ``--file``, run the file's cases in its order up
  to and including the case, passed as node ids (no plugin; the later
  cases cannot reach it). A failing float32 comparison of the case names
  the route that moved: each route against a float64 prefill of the same
  weights, and whether it gives its result again;
* ``--probe P``: the file's cases up to the case, P times, under
  ``tools/c4_probe.py``, which records the CPU route's operations by
  reference and, when the case fails, gives each operation's own error
  against float64 in call order;
* ``--platform``: the host's CPU, torch's build and threading, and the
  environment variables that steer BLAS and oneDNN;
* ``--measure K``: the case's computation K times in this process: for
  each of the three tensors the test compares (the prefill's logits, layer
  0's k cache, the decode step's logits), the largest |error| against the
  CPU and the elements beyond the test's tolerance (2e-4, relative and
  absolute), for the kernel route and the witness (``attn_impl="dense"``);
* ``compute-sanitizer --tool racecheck`` over one float32 flash call at the
  test's shapes (head dim 32: ``flash_fwd_simt<float, 32, 32>``) and at
  head dim 128 (``flash_fwd_simt<float, 128, 128>``), when the tool runs.

Prints one JSON line per part; failing pytest output goes to ``--out`` (default ``results/c4/``). Exits 0 whatever it
finds: it reports.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASE = "tests/test_torch_cuda.py::test_decoder_prefill_on_card_launches_the_kernel_per_layer[dtype0]"
OUT = ROOT / "results" / "c4"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TOL = 2e-4


def _pytest(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True)


def alone(n: int, jobs: int) -> dict:
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        runs = list(pool.map(lambda _: _pytest(["-m", "cuda", CASE]), range(n)))
    failed = [i for i, r in enumerate(runs) if r.returncode != 0]
    for i in failed:
        (OUT / f"alone_{i}.txt").write_text(runs[i].stdout + runs[i].stderr)
    return {"part": "alone", "runs": n, "failed": len(failed), "failed_runs": failed}


def upto_case() -> list[str]:
    """The file's card cases in its order, up to and including the case."""
    r = _pytest(["--collect-only", "-m", "cuda", "tests/test_torch_cuda.py"])
    ids = [line for line in r.stdout.splitlines() if line.startswith("tests/test_torch_cuda.py::")]
    return ids[: ids.index(CASE) + 1]


def whole_file(m: int, upto: bool) -> dict:
    fails, summaries, args = [], [], upto_case() if upto else ["-m", "cuda", "tests/test_torch_cuda.py"]
    for i in range(m):
        r = _pytest(args)
        names = re.findall(r"^FAILED (\S+)", r.stdout, flags=re.M)
        fails.append(names)
        summaries.append((r.stdout.strip().splitlines() or [""])[-1])
        if r.returncode != 0:
            (OUT / f"file_{i}.txt").write_text(r.stdout[-20000:] + r.stderr[-5000:])
    return {"part": "file", "runs": m, "cases": len(args) if upto else "all", "summaries": summaries,
            "failing_cases_by_run": fails,
            "case_failed": sum(CASE.split("::")[1] in " ".join(f) for f in fails)}


def platform_info() -> dict:
    import platform

    import torch

    cpu = Path("/proc/cpuinfo").read_text() if Path("/proc/cpuinfo").exists() else ""
    model = re.findall(r"^model name\s*:\s*(.*)$", cpu, flags=re.M)
    cpu_flags = (re.findall(r"^flags\s*:\s*(.*)$", cpu, flags=re.M) or [""])[0].split()
    return {"part": "platform", "machine": platform.machine(), "cpu": model[0] if model else None,
            "cpu_flags": [f for f in cpu_flags if f.startswith(("avx512", "amx", "fma", "avx2"))],
            "torch": torch.__version__, "cuda": torch.version.cuda, "config": torch.__config__.show(),
            "parallel": torch.__config__.parallel_info(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("MKL", "OMP", "KMP", "ONEDNN", "DNNL", "OPENBLAS", "GOMP", "NVIDIA_TF32"))}}


def probe(p: int) -> dict:
    env = {**ENV, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tools'}", "C4_PROBE_OUT": str(OUT)}
    out = OUT / "probe.jsonl"
    out.unlink(missing_ok=True)
    args = upto_case()
    for _ in range(p):
        subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "c4_probe", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True)
    runs = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    return {"part": "probe", "runs": len(runs), "failed": sum(r["failed"] for r in runs),
            "failing_runs": [r for r in runs if r["failed"]]}


def measure(k: int) -> dict:
    import numpy as np
    import torch

    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), attn_impl="chunked", n_layers=3,
                              param_dtype=torch.float32)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
    m_dense = build_model(dataclasses.replace(cfg, attn_impl="dense"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32)
    nxt = torch.from_numpy(toks[:, :1].copy())
    names = ("logits", "k_cache_layer0", "decode_logits")
    worst = {route: {n: [0.0, 0] for n in names} for route in ("kernel", "witness")}
    for _ in range(k):
        params = m.init(0)
        cuda_toks = torch.from_numpy(toks).cuda()
        logits, caches = m.prefill(params, {"tokens": cuda_toks}, cache_len=120)
        logits2, _ = m.decode_step(params, caches, nxt.cuda(), 100)
        wit, wcaches = m_dense.prefill(params, {"tokens": cuda_toks}, cache_len=120)
        wit2, _ = m_dense.decode_step(params, wcaches, nxt.cuda(), 100)
        pc = params.to("cpu")
        ref, rcaches = m_cpu.prefill(pc, {"tokens": torch.from_numpy(toks)}, cache_len=120)
        ref2, _ = m_cpu.decode_step(pc, rcaches, nxt, 100)
        for route, outs in (("kernel", (logits, caches[0][0]["k"], logits2)),
                            ("witness", (wit, wcaches[0][0]["k"], wit2))):
            for name, got, exp in zip(names, outs, (ref, rcaches[0][0]["k"], ref2)):
                d = (got.cpu().float() - exp.float()).abs()
                beyond = int((d > TOL + TOL * exp.float().abs()).sum())
                w = worst[route][name]
                w[0], w[1] = max(w[0], float(d.max())), max(w[1], beyond)
    return {"part": "measure", "reps": k, "tol": TOL,
            "max_abs_err_and_most_elements_beyond": worst}


def racecheck() -> list[dict]:
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    out = []
    for hd, (h, kh) in ((32, (4, 2)), (128, (40, 8))):
        code = (
            "import sys, torch; sys.path.insert(0, 'src');"
            "from repro_torch.kernels.flash_attn import flash_attention_cuda as f;"
            "g = torch.Generator(device='cuda').manual_seed(0);"
            f"q = torch.randn(2, 100, {h}, {hd}, device='cuda', generator=g);"
            f"k = torch.randn(2, 100, {kh}, {hd}, device='cuda', generator=g);"
            f"v = torch.randn(2, 100, {kh}, {hd}, device='cuda', generator=g);"
            "f(q, k, v); torch.cuda.synchronize(); print('called')"
        )
        try:
            r = subprocess.run([tool, "--tool", "racecheck", "--racecheck-report", "all", sys.executable, "-c", code],
                               cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=600)
            text = r.stdout + r.stderr
            out.append({"part": "racecheck", "kernel": f"flash_fwd_simt<float, {hd}, {hd}>", "rc": r.returncode,
                        "hazards": re.findall(r"RACECHECK SUMMARY: .*", text), "tail": text[-1500:]})
        except (OSError, subprocess.TimeoutExpired) as e:
            out.append({"part": "racecheck", "kernel": f"flash_fwd_simt<float, {hd}, {hd}>",
                        "error": f"{type(e).__name__}: {e}"})
    return out


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alone", type=int, default=50)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--file", type=int, default=10)
    ap.add_argument("--measure", type=int, default=20)
    ap.add_argument("--upto-case", action="store_true")
    ap.add_argument("--probe", type=int, default=0)
    ap.add_argument("--platform", action="store_true")
    ap.add_argument("--no-racecheck", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    OUT = args.out.resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    # build the kernels once, before processes run side by side
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, 'src');"
                    "from repro_torch.kernels import _build; _build.build_all()"], cwd=ROOT, env=ENV, check=True)
    if args.platform:
        print(json.dumps(platform_info()), flush=True)
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
    if not args.no_racecheck:
        for line in racecheck():
            print(json.dumps(line), flush=True)
    if args.alone:
        print(json.dumps(alone(args.alone, args.jobs)), flush=True)
    if args.file:
        print(json.dumps(whole_file(args.file, args.upto_case)), flush=True)
    if args.probe:
        print(json.dumps(probe(args.probe)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

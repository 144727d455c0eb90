"""Runs of each cell at a tiny size on the CPU: the result line's shape, the
reference agreeing with the program, planted faults that ``correct`` must
catch, the float8 control, and no JAX loaded by a run."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_cell

CELLS = ["llava-next-7b.train", "mamba2-1.3b.train_ckpt", "mamba2-1.3b.resume"]
SEED = 2**31 + 977
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(workload, trace=False, dtype="float32", **kw):
    from bench.run import run_cell

    bench, cell, config, traffic, limits = tiny_cell(workload, dtype)
    res = run_cell(bench, cell, config, traffic, limits, SEED, 0.5, trace, device="cpu", **kw)
    res.pop("_notes")
    return res


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_holds_only_the_contract_keys(cpu_threads, workload, trace):
    res = run(workload, trace)
    assert set(res) == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"] and any(m.startswith("train_tokens_per_s") for m in res["metrics"])


def _unchanged(step_fn):
    """A step that leaves the train state as it found it."""
    def step(state, batch):
        keep = [t.detach().clone() for t in _tensors(state)]
        state, metrics = step_fn(state, batch)
        with torch.no_grad():
            for t, k in zip(_tensors(state), keep):
                t.copy_(k)
        return state, metrics
    return step


def _tensors(state):
    out = [p for p in state["params"].parameters()]
    for k in ("master", "mu", "nu"):
        out += list(state["opt"][k].values())
    return out + [state["opt"]["step"]]


def _half(step_fn):
    from bench.control import half_batch

    return half_batch(step_fn)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half])
def test_a_broken_step_is_not_correct(cpu_threads, workload, fault):
    res = run(workload, step_fn_wrapper=fault)
    assert res["correct"] is False


def _flip_a_stored_byte(job):
    name = job.saved[-1]
    key = max(job.snapshots[name], key=lambda k: job.snapshots[name][k].numel())
    entry = next(n.shard.omap[f"ckpt/{name}/{key}"] for n in job.cluster.nodes.values()
                 if f"ckpt/{name}/{key}" in n.shard.omap)
    fp = entry.chunk_fps[0]
    node = next(n for n in job.cluster.nodes.values() if fp in n.chunk_store)
    data = bytearray(node.chunk_store[fp])
    data[100] ^= 0x40
    node.chunk_store[fp] = bytes(data)


def _drop_a_replica(job):
    name = job.saved[-1]
    key = next(iter(job.snapshots[name]))
    entry = next(n.shard.omap[f"ckpt/{name}/{key}"] for n in job.cluster.nodes.values()
                 if f"ckpt/{name}/{key}" in n.shard.omap)
    node = next(n for n in job.cluster.nodes.values() if entry.chunk_fps[0] in n.chunk_store)
    del node.chunk_store[entry.chunk_fps[0]]


@pytest.mark.parametrize("workload", CELLS[1:])
@pytest.mark.parametrize("fault", [_flip_a_stored_byte, _drop_a_replica])
def test_a_damaged_checkpoint_is_not_correct(cpu_threads, workload, fault):
    res = run(workload, after_window=fault)
    assert res["correct"] is False
    assert res["checks"]["ckpt_faults"]["value"] > 0


def test_an_altered_restore_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.checkpoint import DedupCheckpointer

    inner = DedupCheckpointer.restore

    def altered(self, name, like=None):
        tree = inner(self, name, like)
        leaf = tree["params"]["embed"]["table"]
        leaf.view(-1)[0] += 1
        return tree

    monkeypatch.setattr(DedupCheckpointer, "restore", altered)
    res = run("mamba2-1.3b.resume")
    assert res["correct"] is False and res["checks"]["restore_mismatches"]["value"] > 0


def test_a_miscut_wave_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.kernels import ops

    inner = ops.cdc_cut_and_fingerprint_many

    def miscut(streams, **kw):
        """The longest stream (always held to the reference) gets one
        fingerprint bit flipped."""
        out = list(inner(streams, **kw))
        i = max(range(len(streams)), key=lambda j: streams[j].shape[0])
        cut, n_cuts, fps, n_chunks = out[i]
        fps = fps.clone()
        fps.view(torch.int32)[0, 0] ^= 1
        out[i] = (cut, n_cuts, fps, n_chunks)
        return out

    monkeypatch.setattr(ops, "cdc_cut_and_fingerprint_many", miscut)
    res = run("mamba2-1.3b.train_ckpt")
    assert res["correct"] is False and res["checks"]["wave_mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", ["llava-next-7b.train", "mamba2-1.3b.train_ckpt"])
def test_the_float8_control_reads_above_the_program(cpu_threads, workload):
    """The reference with float8 products in the program's place reads a
    wider gap to the float32 reference than the bf16 program does, on the
    numbers the limits separate (the chip's readings set the limits)."""
    from bench import check
    from bench.control import float8_matmul, program_readings
    from bench.job import FOLLOWED_STEPS
    from bench.reference import models as M

    _, _, config, traffic, _ = tiny_cell(workload, "bfloat16")
    prog = check.training_numbers(program_readings(config, traffic, SEED, "cpu"),
                                  ref := check.reference_readings(config, SEED, "cpu", FOLLOWED_STEPS))
    M.matmul = float8_matmul
    try:
        ctrl = check.training_numbers(check.reference_readings(config, SEED, "cpu", FOLLOWED_STEPS), ref)
    finally:
        M.matmul = M._plain_matmul
    assert ctrl["grad_leaf_gap"] > prog["grad_leaf_gap"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process: no module whose top-level name
    is jax, jaxlib, flax or repro is loaded once it ends."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}, {str(ROOT / "bench" / "tests")!r}]
from conftest import tiny_cell
from bench.run import run_cell, loaded_forbidden
bench, cell, config, traffic, limits = tiny_cell("mamba2-1.3b.resume")
res = run_cell(bench, cell, config, traffic, limits, 5, 0.2, False, device="cpu")
print(json.dumps([res["correct"], loaded_forbidden(), sorted({{m.split('.')[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    correct, forbidden, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and forbidden == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(names)
    assert "repro_torch" in names


def test_the_benchmark_reads_no_file_of_the_old_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import jax" not in text and "from repro." not in text, path


def test_the_cli_refuses_without_a_card_and_without_the_program(tmp_path):
    env_cmd = [sys.executable, "-m", "bench.run", "--workload", "llava-next-7b.train", "--seed", "1",
               "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(env_cmd, capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert out.returncode != 0 and out.stdout == ""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(env_cmd, capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_the_llava_cell_is_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "bench.run", "--workload", "llava-next-7b.train", "--seed",
                          str(SEED), "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_host_clock_readers_leave_out_what_the_profiler_saw():
    from bench.job import Record
    from bench.run import RunView, reader
    from bench.trace import Summary

    class Job:
        config, traffic = {"model": {}}, {}
        records = [Record("save", 0, 1, {"wave": 0.1}, {}), Record("save", 2, 5, {"wave": 0.4}, {}),
                   Record("save", 6, 7, {"wave": 0.2}, {})]

    view = RunView(Job, 0, 8, 1.0, None, (1.5, 5.5))
    assert reader("ckpt_save_s.host")(view) == 1.0
    assert reader("ckpt_wave_s")(view) == pytest.approx(0.15)
    # the idle share is the traced steps' own: busy over their wall, both from the trace
    view.trace = Summary(4.0, 2.0, {}, {}, {}, [0.45, 0.45], [0.5, 0.5], [])
    assert reader("device_idle.train")(view) == pytest.approx(10.0)

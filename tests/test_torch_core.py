"""The port's copy of the host cluster held against ``repro.core``, and the
port's import boundary.

The cluster modules are host Python plus numpy; the port keeps its own copy
so that it imports nothing of the JAX package. The same seeded operations
through both copies must leave the same counters, savings and fingerprints.
"""

import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core as jcore
import repro_torch.core as tcore

REPO = Path(__file__).resolve().parents[1]


def _fp(f) -> tuple[str, bytes]:
    return f.namespace, f.value


def _quickstart(core) -> tuple[dict, float, list]:
    """examples/quickstart.py's cluster steps 1-4 on seeded bytes."""
    rng = np.random.default_rng(0)
    blob = rng.bytes(1 << 20)
    cluster = core.DedupCluster.create(4, replicas=2, chunking=core.ChunkingSpec("fixed", 64 * 1024))
    fps = [
        cluster.write_object("vm-image-a", blob),
        cluster.write_object("vm-image-b", blob),
        cluster.write_object("vm-image-c", blob + rng.bytes(1 << 18)),
    ]
    cluster.tick(2)
    assert cluster.read_object("vm-image-b") == blob
    cluster.crash_node("oss1")
    assert cluster.read_object("vm-image-a") == blob
    cluster.restart_node("oss1")
    cluster.add_node()
    assert cluster.read_object("vm-image-c")[: 1 << 20] == blob
    return cluster.stats.snapshot(), cluster.space_savings(), [_fp(f) for f in fps]


def test_quickstart_cluster_matches_reference():
    got = _quickstart(tcore)
    exp = _quickstart(jcore)
    assert got[0] == exp[0]
    assert got[1] == exp[1]
    assert got[2] == exp[2]


@pytest.mark.parametrize(
    "spec",
    [("fixed", 4096, 0, 0), ("cdc", 1024, 0, 0), ("cdc", 2048, 100, 9000)],
)
def test_chunk_object_matches_reference(spec):
    data = np.random.default_rng(3).bytes(50_000)
    got = tcore.chunk_object(data, tcore.ChunkingSpec(*spec))
    assert got == jcore.chunk_object(data, jcore.ChunkingSpec(*spec))
    assert [_fp(f) for f in tcore.fingerprint_many(got)] == [
        _fp(f) for f in jcore.fingerprint_many(got)
    ]


def test_chunk_specs_match_reference():
    from repro.core.chunking import GEAR_TABLE as J_GEAR
    from repro.core.chunking import ChunkSpec as JSpec
    from repro_torch.core.chunking import GEAR_TABLE as T_GEAR
    from repro_torch.core.chunking import ChunkSpec as TSpec

    assert T_GEAR == J_GEAR
    for target in (512 * 1024, 4096, 1000):
        for kw in ({}, {"min_bytes": 100, "max_bytes": 9000}, {"device": False}):
            assert asdict(TSpec.for_checkpoint(target, **kw)) == asdict(JSpec.for_checkpoint(target, **kw))
        for kw in ({}, {"min_bytes": 100, "max_bytes": 9000}):
            assert TSpec.cdc(target, **kw).kernel_kwargs() == JSpec.cdc(target, **kw).kernel_kwargs()


def test_batched_writes_and_delete_match_reference():
    rng = np.random.default_rng(11)
    items = [(f"obj{i}", rng.bytes(20_000 + 997 * i)) for i in range(6)]
    items.append(("dup", items[2][1]))

    def run(core):
        c = core.DedupCluster.create(3, replicas=2, chunking=core.ChunkingSpec("cdc", 4096))
        fps = c.write_objects(items)
        c.tick(2)
        blobs = c.read_objects([n for n, _ in items])
        c.delete_object("obj1")
        c.run_gc()
        return [_fp(f) for f in fps], blobs, c.stats.snapshot(), c.unique_bytes_stored()

    got, exp = run(tcore), run(jcore)
    assert got == exp
    assert got[1] == [d for _, d in items]


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys, repro_torch, repro_torch.checkpoint, repro_torch.core, chip_smoke\n"
        "import repro_torch.configs, repro_torch.models.convert, repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attn, repro_torch.train, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.launch.train, repro_torch.models.moe, repro_torch.models.encdec\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def _objects(seed: int) -> list[tuple[str, bytes]]:
    """Objects with duplicates across names: a shared 8 KiB blob, partial
    copies of it and unique tails."""
    rng = np.random.default_rng(seed)
    blob = rng.bytes(8192)
    items = [(f"o{i}", blob) for i in range(4)]
    items += [(f"p{i}", blob[: 4096 * (i + 1)] + rng.bytes(1000 + i)) for i in range(2)]
    items += [(f"u{i}", rng.bytes(3000 + 512 * i)) for i in range(3)]
    return items


@pytest.mark.parametrize("kind", ["CentralDedupCluster", "DiskLocalDedupCluster", "NoDedupCluster"])
def test_baselines_match_reference(kind):
    items = _objects(5)

    def run(core):
        if kind == "NoDedupCluster":
            c = core.NoDedupCluster.create(4)
        else:
            c = getattr(core, kind).create(8, chunking=core.ChunkingSpec("fixed", 2048))
        fps = [c.write_object(n, d) for n, d in items]
        blobs = [c.read_object(n) for n, _ in items]
        extra = (c.central_ops, c.central_cpu_bytes) if kind == "CentralDedupCluster" else ()
        savings = None if kind == "NoDedupCluster" else c.space_savings()  # it stores every byte
        return ([None if f is None else _fp(f) for f in fps], blobs, savings, c.unique_bytes_stored(),
                c.stats.snapshot(), extra)

    got, exp = run(tcore), run(jcore)
    assert got == exp
    assert got[1] == [d for _, d in items]


def test_workload_under_scheduler_matches_reference():
    """A seeded multi-client workload under the Scheduler: the same report,
    event log and cluster counters in both copies."""
    def run(core):
        c = core.DedupCluster.create(4, replicas=2, chunking=core.ChunkingSpec("fixed", 2048))
        sched = core.Scheduler(c, seed=3)
        spec = core.WorkloadSpec(clients=6, objects=16, ops_per_client=6, seed=7,
                                 bulk_first=2, wave_bytes=8192, gc_interval=5, repair_interval=7)
        rep = core.run_workload(c, spec, scheduler=sched)
        return rep, sched.event_log, c.stats.snapshot()

    got, exp = run(tcore), run(jcore)
    assert got[0]["totals"]["puts_ok"] >= 1 and got[0]["actor_errors"] == {}
    assert got == exp


def test_simclock_trace_matches_reference():
    """SimClock's skewed node clocks and the Scheduler's event trace of
    one-shot and recurring actors."""
    def run(core):
        clk = core.SimClock(offsets={"oss0": 5, "oss1": -3})
        clock_trace = [clk.advance(d) for d in (4, 0, 7)]
        clock_trace += [clk.node_now(n) for n in ("oss0", "oss1", "oss2")] + [clk.max_skew]
        c = core.DedupCluster.create(2, replicas=1, chunking=core.ChunkingSpec("fixed", 2048))
        sched = core.Scheduler(c, seed=1)
        trace = []

        def actor(tag, delays):
            for d in delays:
                trace.append((c.now, tag))
                yield d
            return tag

        sched.spawn(actor("a", [3, 1, 2]), name="a")
        sched.spawn(actor("b", [1, 1, 4]), name="b", delay=1)
        sched.every(2, lambda: trace.append((c.now, "tick")), name="r")
        results = sched.run()
        return clock_trace, trace, results, sched.event_log, sched.steps, c.now

    assert run(tcore) == run(jcore)


def test_data_pipeline_matches_reference():
    from repro.data import DedupWorkload as JWorkload
    from repro.data import SyntheticLMData as JData
    from repro.data import make_dedup_objects as jmake
    from repro_torch.data import DedupWorkload, SyntheticLMData, make_dedup_objects

    for seed, step in ((0, 0), (1, 5), (7, 123)):
        got = SyntheticLMData(vocab=512, seq_len=33, global_batch=3, seed=seed).batch(step)
        exp = JData(vocab=512, seq_len=33, global_batch=3, seed=seed).batch(step)
        assert sorted(got) == sorted(exp)
        for k in got:
            assert got[k].dtype == exp[k].dtype
            np.testing.assert_array_equal(got[k], exp[k])
    shard = SyntheticLMData(vocab=64, seq_len=8, global_batch=4, seed=2).host_shard(3, 1, 2)
    jshard = JData(vocab=64, seq_len=8, global_batch=4, seed=2).host_shard(3, 1, 2)
    assert all(np.array_equal(shard[k], jshard[k]) for k in jshard)
    for pct in (0.0, 40.0, 100.0):
        kw = dict(object_size=10_000, n_objects=5, dedup_pct=pct, seed=3)
        assert make_dedup_objects(DedupWorkload(**kw)) == jmake(JWorkload(**kw))

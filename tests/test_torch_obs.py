"""The port's span log (``repro_torch.obs``) and the spans of the save path.

The recorder: nesting and parent ids, the ring's bound and its dropped
count, threads, a failing stage; ranges only while a profiler records. The
save path on a tiny CPU cluster (4 nodes, 2 replicas): one ``ckpt.save``
root, a ``ckpt.serialize`` / ``ckpt.d2h`` / ``ckpt.encode`` per written
leaf, a ``cluster.send`` per target node, byte counts that agree with the
checkpointer's and the cluster's own counters; the same stages through the
scheduled ``put_wave_actor``.
"""

import os
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer  # noqa: E402
from repro_torch.core import ChunkingSpec, DedupCluster  # noqa: E402
from repro_torch.core.chunking import chunk_object  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.trace import RANGES  # noqa: E402

# Substrings the benchmark's device-trace readers match in kernel names.
KERNEL_KEYS = ("flash_fwd", "flash_bwd", "cdc_phase", "fp_accumulate", "fp_finalize")
SAVE_SPANS = {"ckpt.save", "ckpt.wave", "ckpt.serialize", "ckpt.d2h", "ckpt.encode", "cluster.put_many",
              "cluster.chunk", "cluster.sha256", "cluster.plan", "cluster.send", "cluster.commit", "cluster.tick"}
RANGE_ONLY = {"kernels.cut", "kernels.rows", "kernels.fingerprint", "optim.adamw_update"}


def _tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(40_000, generator=g), "b": torch.randn(3_000, generator=g).to(torch.bfloat16),
            "layer": {"k": torch.randint(0, 1 << 20, (20_000,), generator=g, dtype=torch.int32)}, "step": 3}


def _cluster() -> DedupCluster:
    return DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 4096))


def _below(spans, root) -> list:
    """The spans below ``root`` (its descendants), by start."""
    kids, out, todo = {}, [], [root]
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    while todo:
        found = kids.get(todo.pop().id, [])
        out += found
        todo += found
    return sorted(out, key=lambda s: s.t0)


def _save(ckpt, name, tree):
    manifest = ckpt.save(name, tree)
    spans = obs.spans()
    root = next(s for s in reversed(spans) if s.name == "ckpt.save" and s.attrs["name"] == name)
    return manifest, root, _below(spans, root)


# ------------------------------------------------------------- the recorder --
def test_spans_nest_and_name_their_parents():
    log = obs.SpanLog()
    with log.span("a.outer", k=1) as attrs:
        with log.span("a.inner"):
            pass
        with log.span("a.inner") as inner:
            inner["n"] = 2
        attrs["done"] = True
    with log.span("a.next"):
        pass
    spans = {s.id: s for s in log.spans()}
    outer = next(s for s in spans.values() if s.name == "a.outer")
    inners = [s for s in spans.values() if s.name == "a.inner"]
    assert outer.parent is None and outer.attrs == {"k": 1, "done": True}
    assert [s.parent for s in inners] == [outer.id, outer.id] and inners[1].attrs == {"n": 2}
    assert all(outer.t0 <= s.t0 <= s.t1 <= outer.t1 for s in inners)
    assert next(s for s in spans.values() if s.name == "a.next").parent is None
    # a log snapshot is in the order the spans ended
    assert [s.name for s in log.spans()] == ["a.inner", "a.inner", "a.outer", "a.next"]


def test_a_span_keeps_a_name_attribute_of_its_own():
    log = obs.SpanLog()
    with log.span("ckpt.save", name="step-32"):
        pass
    assert log.spans()[0].attrs == {"name": "step-32"}


def test_the_ring_is_bounded_and_counts_what_it_let_go():
    log = obs.SpanLog(capacity=8)
    for i in range(20):
        with log.span("a.b", i=i):
            pass
    spans = log.spans()
    assert len(spans) == 8 and log.dropped() == 12
    assert [s.attrs["i"] for s in spans] == list(range(12, 20))
    assert obs.CAPACITY >= 65536 and obs.LOG._ring.maxlen == obs.CAPACITY


def test_a_failing_stage_is_logged_and_leaves_the_stack_clean():
    log = obs.SpanLog()
    with pytest.raises(KeyError):
        with log.span("a.outer"):
            with log.span("a.fails"):
                raise KeyError("x")
    with log.span("a.after"):
        pass
    by_name = {s.name: s for s in log.spans()}
    assert by_name["a.fails"].attrs == {"error": "KeyError"} and by_name["a.outer"].attrs == {"error": "KeyError"}
    assert by_name["a.after"].parent is None


def test_threads_keep_their_own_parents_and_lose_no_span():
    """More threads than cores, switching often: every span's parent is a
    span its own thread opened, and recorded spans = kept + dropped."""
    log = obs.SpanLog(capacity=4096)
    n_threads, rounds = 2 * (os.cpu_count() or 2) + 2, 200

    def work(t):
        for i in range(rounds):
            with log.span("t.outer", thread=t):
                with log.span("t.inner", thread=t):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = log.spans()
    assert len(spans) + log.dropped() == 2 * n_threads * rounds
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "t.inner" and s.parent in by_id:
            assert by_id[s.parent].name == "t.outer" and by_id[s.parent].attrs["thread"] == s.attrs["thread"]
        if s.name == "t.outer":
            assert s.parent is None


class _Counting:
    """A stand-in for ``record_function`` that counts the ranges entered."""

    def __init__(self, inner):
        self.inner, self.names = inner, []

    def __call__(self, name, *args, **kw):
        self.names.append(name)
        return self.inner(name, *args, **kw)


def _one_of_each():
    """A tiny CDC save (the device route on the CPU: the wave's ranges) and
    an optimizer update."""
    ckpt = DedupCheckpointer(_cluster(), CheckpointConfig(fp_chunk_bytes=4096), device="cpu")
    ckpt.save("p", _tree())
    params = {"w": torch.ones(8)}
    state = adamw_init(params, AdamWConfig())
    adamw_update(params, {"w": torch.ones(8)}, state, AdamWConfig())
    with obs.range("kernels.test"):
        pass


def test_no_range_is_entered_while_no_profiler_records(monkeypatch):
    counting = _Counting(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    _one_of_each()
    assert counting.names == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _one_of_each()
    assert SAVE_SPANS | RANGE_ONLY <= set(counting.names)


def test_the_program_names_its_stages_in_a_profilers_host_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _one_of_each()
    names = {e.name for e in prof.events()}
    assert SAVE_SPANS | RANGE_ONLY <= names
    # no name the benchmark's trace reader already gives a meaning to
    for name in SAVE_SPANS | RANGE_ONLY:
        assert name not in RANGES and not any(k in name for k in KERNEL_KEYS), name


def test_an_op_is_a_profiler_operation_inside_the_range_around_it():
    """``obs.op`` is nothing while no profiler records; under one it is an
    operation, not a user range, below the range around it. The profiler
    links a kernel to the innermost operation around its launch, so the
    optimizer kernels' device time (launched through ctypes inside these)
    falls under the update's range."""
    from torch.profiler import ProfilerActivity, profile

    ops = ("kernels.adamw_sumsq", "kernels.adamw_finish", "kernels.adamw_apply")
    assert all(obs.op(name) is obs._NULL for name in ops)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.range("optim.adamw_update"):
            for name in ops:
                with obs.op(name):
                    pass
    events = {e.name: e for e in prof.events()}
    for name in ops:
        assert not events[name].is_user_annotation and events[name].cpu_parent.name == "optim.adamw_update"
        assert name not in RANGES and not any(k in name for k in KERNEL_KEYS), name


# ------------------------------------------------------------ the save path --
def test_a_save_records_its_stages_below_one_root():
    cluster = _cluster()
    ckpt = DedupCheckpointer(cluster, CheckpointConfig(fp_chunk_bytes=4096), device="cpu")
    tree = _tree()
    batches = cluster.transport.msgs_by_type.get("chunk_op_batch", 0)
    manifest, root, below = _save(ckpt, "s1", tree)
    written = [e for e in manifest["leaves"] if not e["ref"]]
    count = {n: sum(1 for s in below if s.name == n) for n in SAVE_SPANS}
    assert root.parent is None and root.attrs == {"name": "s1", "leaves": 4, "bytes": ckpt.stats["bytes_sent"]}
    assert count["ckpt.wave"] == 1 and count["cluster.put_many"] == 1 and count["cluster.tick"] == 1
    assert count["ckpt.serialize"] == count["ckpt.d2h"] == count["ckpt.encode"] == len(written) == 4
    by_id = {s.id: s for s in below}
    for s in below:
        if s.name in ("ckpt.d2h", "ckpt.encode"):
            assert by_id[s.parent].name == "ckpt.serialize"
        if s.name in ("cluster.chunk", "cluster.sha256", "cluster.plan", "cluster.send", "cluster.commit"):
            assert by_id[s.parent].name == "cluster.put_many"
    serialize = [s for s in below if s.name == "ckpt.serialize"]
    assert sum(s.attrs["bytes"] for s in serialize) == ckpt.stats["bytes_sent"]
    encode = [s for s in below if s.name == "ckpt.encode"]
    assert [s.attrs["bytes"] for s in encode] == [s.attrs["bytes"] for s in serialize]
    # one ChunkOpBatch per target node, and every node is one
    sends = [s for s in below if s.name == "cluster.send"]
    assert len(sends) == cluster.transport.msgs_by_type["chunk_op_batch"] - batches
    assert sorted(s.attrs["node"] for s in sends) == sorted(cluster.nodes)
    assert sum(s.attrs["ops"] for s in sends) == 2 * next(s for s in below if s.name == "cluster.plan").attrs["chunk_ops"]
    # SHA-256 over every chunk of the batch: the leaves' bytes and the manifest
    items = [cluster.read_object(e["object"]) for e in written]
    items.append(cluster.read_object("ckpt/s1/MANIFEST"))
    chunks = [c for data in items for c in chunk_object(data, cluster.chunking)]
    (sha,) = [s for s in below if s.name == "cluster.sha256"]
    assert sha.attrs == {"chunks": len(chunks), "bytes": sum(len(c) for c in chunks)}
    (put,) = [s for s in below if s.name == "cluster.put_many"]
    assert put.attrs == {"objects": len(items), "bytes": sha.attrs["bytes"]}
    # the stages lie inside the root and cover most of a save's own work
    assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in below)


def test_a_resave_by_reference_serializes_nothing():
    ckpt = DedupCheckpointer(_cluster(), CheckpointConfig(fp_chunk_bytes=4096), device="cpu")
    tree = _tree()
    ckpt.save("s1", tree)
    sent = ckpt.stats["bytes_sent"]
    manifest, root, below = _save(ckpt, "s2", tree)
    assert all(e["ref"] for e in manifest["leaves"] if e["key"] != "['step']")
    serialize = [s for s in below if s.name == "ckpt.serialize"]
    assert len(serialize) == 1  # the int leaf, which has no device fingerprint
    assert root.attrs["bytes"] == ckpt.stats["bytes_sent"] - sent == serialize[0].attrs["bytes"]


def test_the_wave_actor_records_the_same_stages():
    cluster = _cluster()
    g = torch.Generator().manual_seed(1)
    items = [(f"obj/{i}", torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8).numpy().tobytes())
             for i, n in enumerate((40_000, 30_000, 50_000, 9_000, 70_000))]
    session = cluster.client(wave_bytes=64 * 1024)
    first = max((s.id for s in obs.spans()), default=0)
    actor = session.put_wave_actor(items)
    n_yields = 0
    with pytest.raises(StopIteration) as stop:
        while True:
            next(actor)
            n_yields += 1
    fps, committed = stop.value.value
    assert len(fps) == len(items) == len(committed)
    spans = [s for s in obs.spans() if s.id > first]
    count = {n: sum(1 for s in spans if s.name == n) for n in SAVE_SPANS}
    assert count["cluster.plan"] == count["cluster.commit"] == count["cluster.chunk"] == n_yields >= 2
    assert count["cluster.sha256"] == n_yields and count["cluster.put_many"] == 0
    chunks = [c for _, data in items for c in chunk_object(data, cluster.chunking)]
    assert sum(s.attrs["bytes"] for s in spans if s.name == "cluster.sha256") == sum(len(c) for c in chunks)
    assert sum(s.attrs["chunks"] for s in spans if s.name == "cluster.sha256") == len(chunks)
    sends = [s for s in spans if s.name == "cluster.send"]
    assert sum(s.attrs["ops"] for s in sends) == 2 * len(chunks)
    assert sum(s.attrs["payload_bytes"] for s in sends) > 0
    # each wave's sends lie between its plan and its commit
    plans = sorted((s for s in spans if s.name == "cluster.plan"), key=lambda s: s.t0)
    commits = sorted((s for s in spans if s.name == "cluster.commit"), key=lambda s: s.t0)
    for p, c in zip(plans, commits):
        wave = [s for s in sends if p.t1 <= s.t0 and s.t1 <= c.t0]
        assert wave and len({s.attrs["node"] for s in wave}) == len(wave)

"""Multi-tenant workload generator — declarative seeded workload mixes
driven through the discrete-event Scheduler (core/simclock.py).

ROADMAP item 1: the per-edge stats and straggler-NIC model need N
concurrent clients to measure anything. A ``WorkloadSpec`` declares the
mix as data (the ``tlasica__casstor`` stress-YAML idiom: client count,
Zipf object popularity, Zipf sizes, put/get/delete mix, bursty seeded
arrivals) and ``run_workload`` compiles it into one generator actor per
client — each an independent ``DedupClient`` session with its own
transport endpoint (``c0``..``cN-1``), so per-edge accounting attributes
contention per client — then runs the Scheduler to quiescence and
reports per-client throughput, p50/p99 op latency in ticks, and
per-edge/NIC contention maxima.

Everything is deterministic given ``spec.seed``: per-client op streams
come from ``random.Random(seed*1_000_003 + client_index)``, Zipf draws
use ``random.choices`` with 1/rank^s weights (pure python floats — no
hash-order iteration anywhere), and the Scheduler's tie-breaking is
seeded. Same seed ⇒ identical event log, report and final cluster state
(pinned in tests/test_workload.py; the ``multi_tenant`` bench section
gates the report's columns at tolerance 0).

Content model: objects are concatenations of blocks drawn Zipf-skewed
from a small seeded shared pool, plus a unique tail block per (client,
op) — so cross-client dedup on hot blocks is real (FASTEN's hot-chunk
concentration) while every rewrite still changes content. Hot NAMES are
real too: clients draw object names from one shared Zipf universe, so
concurrent sessions race puts/deletes/gets on the same names — the
version-authority and response-carried-prev machinery under live fire.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

from repro_torch.core.cluster import ReadError, WriteError
from repro_torch.core.simclock import Scheduler


@dataclass(frozen=True)
class WorkloadOp:
    """One client operation: ``kind`` in put|get|delete; ``at`` is the
    arrival tick; ``items`` carries (name, bytes) payloads for puts
    (several for a bulk put), ``name`` the target for get/delete."""

    at: int
    kind: str
    name: str = ""
    items: tuple = ()


@dataclass(frozen=True)
class WorkloadSpec:
    """A workload mix as data. ``mix`` weights put/get/delete draws;
    ``burst_p`` is the probability an op arrives in the same burst as
    its predecessor (gap 0) instead of ``1..gap_max`` ticks later.
    ``bulk_first > 0`` makes each client's first op a bulk put of that
    many objects, streamed through ``wave_bytes``-bounded waves — the
    overlap-pipelining exercise (``stats.waves_overlapped``)."""

    clients: int = 8
    objects: int = 48                 # shared Zipf name universe o0..oN-1
    ops_per_client: int = 12
    zipf_s: float = 1.1               # name popularity skew
    size_zipf_s: float = 0.8          # size-in-blocks skew (small is common)
    size_blocks_max: int = 6
    block_bytes: int = 2048
    block_pool: int = 24              # shared content blocks (dedup source)
    mix: tuple = (("put", 0.55), ("get", 0.3), ("delete", 0.15))
    burst_p: float = 0.5
    gap_max: int = 4
    bulk_first: int = 0
    wave_bytes: int = 0
    presence_cache: int = 0
    seed: int = 0
    gc_interval: int = 0              # >0: recurring cluster.run_gc actor
    repair_interval: int = 0          # >0: recurring RepairDaemon.step actor


@dataclass
class ClientRecord:
    """Mutable per-client run record (one per actor)."""

    label: str
    ops_done: int = 0
    puts_ok: int = 0
    gets_ok: int = 0
    deletes_ok: int = 0
    not_found: int = 0                # get/delete on an absent name
    failures: int = 0                 # WriteError/ReadError under faults
    bytes_written: int = 0
    bytes_read: int = 0
    latencies: list = field(default_factory=list)   # ticks, per completed op
    # Serialization witness: (version, kind, name, data|None) per committed
    # put object / acked delete, in commit order — the oracle replays the
    # union of all clients' records sorted by version (the cluster-monotonic
    # commit authority) to reproduce the winners byte-identically.
    commits: list = field(default_factory=list)


def _zipf_weights(n: int, s: float) -> list[float]:
    return [1.0 / (rank**s) for rank in range(1, n + 1)]


def _block_pool(spec: WorkloadSpec) -> list[bytes]:
    rng = random.Random(spec.seed * 7919 + 17)
    return [rng.randbytes(spec.block_bytes) for _ in range(spec.block_pool)]


def _gen_client_ops(
    spec: WorkloadSpec, client_idx: int, pool: list[bytes]
) -> list[WorkloadOp]:
    """Compile one client's seeded op stream. Bursty arrivals: a run of
    ops lands on one tick, then a seeded gap."""
    rng = random.Random(spec.seed * 1_000_003 + client_idx)
    name_w = _zipf_weights(spec.objects, spec.zipf_s)
    size_w = _zipf_weights(spec.size_blocks_max, spec.size_zipf_s)
    block_w = _zipf_weights(spec.block_pool, spec.size_zipf_s)
    kinds = [k for k, _ in spec.mix]
    kind_w = [w for _, w in spec.mix]
    names = [f"o{i}" for i in range(spec.objects)]

    def _data(tag: int) -> bytes:
        nblocks = rng.choices(range(1, spec.size_blocks_max + 1), size_w)[0]
        body = b"".join(
            pool[i] for i in rng.choices(range(spec.block_pool), block_w, k=nblocks)
        )
        # Unique tail: rewrites change content; (client, op) disambiguates.
        return body + f"|c{client_idx}:{tag}".encode()

    ops: list[WorkloadOp] = []
    t = 0
    if spec.bulk_first > 0:
        items = tuple(
            (f"bulk-c{client_idx}-{j}", _data(10_000 + j))
            for j in range(spec.bulk_first)
        )
        ops.append(WorkloadOp(at=0, kind="put", items=items))
    for j in range(spec.ops_per_client):
        if ops:  # first op arrives at t=0 (everyone bursts at the start)
            t += 0 if rng.random() < spec.burst_p else rng.randint(1, spec.gap_max)
        kind = rng.choices(kinds, kind_w)[0]
        name = rng.choices(names, name_w)[0]
        if kind == "put":
            ops.append(WorkloadOp(at=t, kind="put", name=name,
                                  items=((name, _data(j)),)))
        else:
            ops.append(WorkloadOp(at=t, kind=kind, name=name))
    return ops


def _client_actor(cluster, client, ops: list[WorkloadOp], rec: ClientRecord):
    """One client session as a generator actor: waits out arrival gaps,
    drives puts through the resumable wave pipeline (yielding while waves
    are in flight), and books one latency sample per completed op."""
    for op in ops:
        if op.at > cluster.now:
            yield op.at - cluster.now
        try:
            if op.kind == "put":
                data_by_name = dict(op.items)
                sink: list = []
                try:
                    yield from client.put_wave_actor(
                        list(op.items), commit_sink=sink
                    )
                    rec.puts_ok += 1
                    rec.bytes_written += sum(len(d) for _, d in op.items)
                finally:
                    # Waves that committed before a mid-batch failure are
                    # real commits: the oracle must see them.
                    for name, version in sink:
                        rec.commits.append(
                            (version, "put", name, data_by_name[name])
                        )
            elif op.kind == "get":
                data = client.get(op.name)
                rec.gets_ok += 1
                rec.bytes_read += len(data)
            elif op.kind == "delete":
                if client.delete(op.name):
                    rec.deletes_ok += 1
                    # delete_object allocated exactly one txn; cooperative
                    # scheduling means nobody ran in between.
                    rec.commits.append(
                        (cluster._txn_counter, "delete", op.name, None)
                    )
                else:
                    rec.not_found += 1
            else:
                raise ValueError(f"unknown op kind {op.kind!r}")
        except ReadError:
            rec.not_found += 1
        except WriteError:
            rec.failures += 1
        rec.ops_done += 1
        # Arrival-to-completion, queueing included: an op that waited
        # behind this client's own backlog pays for it in the tail.
        rec.latencies.append(max(1, cluster.now - op.at + 1))
        yield 1
    return rec


def _pct(sorted_vals: list[int], q: float) -> int:
    """Nearest-rank percentile over pre-sorted integer samples."""
    if not sorted_vals:
        return 0
    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]


def _edge_contention(cluster) -> dict:
    """Per-edge/NIC payload maxima (deterministic ints): the busiest
    single edge and the busiest node ingress/egress lanes — the direct
    inputs of the straggler-NIC model (benchmarks/simtime.py prices
    them; this reports them raw so core carries no bench dependency)."""
    edges = cluster.transport.edges
    busiest = 0
    ingress: dict[str, int] = {}
    egress: dict[str, int] = {}
    for (src, dst), e in edges.items():
        busiest = max(busiest, e.payload_bytes)
        egress[src] = egress.get(src, 0) + e.payload_bytes
        ingress[dst] = ingress.get(dst, 0) + e.payload_bytes
    return {
        "edges": len(edges),
        "busiest_edge_payload": busiest,
        "node_ingress_max": max(
            (ingress.get(nid, 0) for nid in cluster.nodes), default=0
        ),
        "node_egress_max": max(
            (egress.get(nid, 0) for nid in cluster.nodes), default=0
        ),
    }


def run_workload(cluster, spec: WorkloadSpec, scheduler: Scheduler | None = None) -> dict:
    """Compile ``spec`` into per-client actors, run the Scheduler to
    quiescence, close the sessions, and return the report dict:
    ``per_client`` (ops/oks/p50/p99/bytes), ``totals``, ``edges``
    (contention maxima), ``max_in_flight_sessions`` (the interleaving
    witness), ``commit_log`` (version-sorted serialization witness for
    oracle replay) and ``elapsed_ticks``. Every value is a deterministic
    function of (cluster state, spec) — the bench gates them at
    tolerance 0."""
    sched = scheduler if scheduler is not None else Scheduler(cluster, seed=spec.seed)
    pool = _block_pool(spec)
    sessions = []
    records: list[ClientRecord] = []
    start_now = cluster.now
    for i in range(spec.clients):
        label = f"c{i}"
        client = cluster.client(
            presence_cache=spec.presence_cache,
            wave_bytes=spec.wave_bytes,
            src=label,
        )
        rec = ClientRecord(label=label)
        sched.spawn(
            _client_actor(cluster, client, _gen_client_ops(spec, i, pool), rec),
            name=label,
            session=client,
        )
        sessions.append(client)
        records.append(rec)
    if spec.gc_interval > 0:
        sched.every(spec.gc_interval, cluster.run_gc, name="gc")
    if spec.repair_interval > 0:
        from repro_torch.core.recovery import RepairDaemon

        daemon = RepairDaemon(cluster)
        sched.every(spec.repair_interval, daemon.step, name="repair")
    sched.run()
    for s in sessions:
        s.close()

    per_client = []
    all_lats: list[int] = []
    for rec in records:
        lats = sorted(rec.latencies)
        all_lats.extend(lats)
        elapsed = max(1, cluster.now - start_now)
        per_client.append({
            "client": rec.label,
            "ops": rec.ops_done,
            "puts_ok": rec.puts_ok,
            "gets_ok": rec.gets_ok,
            "deletes_ok": rec.deletes_ok,
            "not_found": rec.not_found,
            "failures": rec.failures,
            "bytes_written": rec.bytes_written,
            "bytes_read": rec.bytes_read,
            "latency_p50_ticks": _pct(lats, 0.50),
            "latency_p99_ticks": _pct(lats, 0.99),
            "throughput_bytes_per_tick": rec.bytes_written // elapsed,
        })
    all_lats.sort()
    commit_log = sorted(
        (c for rec in records for c in rec.commits), key=lambda c: c[0]
    )
    return {
        "spec_seed": spec.seed,
        "clients": spec.clients,
        "per_client": per_client,
        "totals": {
            "ops": sum(r.ops_done for r in records),
            "puts_ok": sum(r.puts_ok for r in records),
            "gets_ok": sum(r.gets_ok for r in records),
            "deletes_ok": sum(r.deletes_ok for r in records),
            "not_found": sum(r.not_found for r in records),
            "failures": sum(r.failures for r in records),
            "bytes_written": sum(r.bytes_written for r in records),
            "latency_p50_ticks": _pct(all_lats, 0.50),
            "latency_p99_ticks": _pct(all_lats, 0.99),
        },
        "edges": _edge_contention(cluster),
        "max_in_flight_sessions": sched.max_in_flight_sessions,
        "scheduler_steps": sched.steps,
        "elapsed_ticks": cluster.now - start_now,
        "commit_log": commit_log,
        # Unexpected actor deaths (anything the client actors don't model
        # as an op failure — i.e. bugs). Chaos suites assert this empty so
        # a dead client can't silently weaken their invariants.
        "actor_errors": {name: repr(e) for name, e in sched.errors.items()},
    }

"""DedupCluster — the shared-nothing cluster with cluster-wide deduplication.

Implements the paper's complete write/read I/O transactions (Fig 3), the
fingerprint-routed chunk placement (Fig 2), storage rebalancing on topology
change (Fig 1b, made metadata-free by content placement), K-way replication,
failure injection, and byte-accurate network/disk accounting for the
benchmark models.

Transaction flow (write) — every arrow is a typed message on the Transport
(see core/messages.py for the catalog, core/transport.py for delivery):

  client --(object bytes: ingress transfer)--> primary OSS (by name hash)
  primary: chunk + fingerprint (vectorized, whole batch at once), then
      OmapGet           -> idempotence / replace check
      ChunkOpBatch      -> one unicast per *target node* carrying every
                           chunk op routed there — for the WHOLE batch of
                           objects, not per object (cross-object unicast
                           coalescing). A batch-local fp->first-writer
                           cache turns intra-batch duplicate chunks into
                           ref-only ops before anything hits the wire.
      target: CIT lookup -> dedup_hit | repaired | restored | stored
                           (commit flags flip asynchronously, paper §2.4)
  per object, once its chunk ops are acked:
      OmapPut           -> OMAP entry on primary (+ replicas) = txn commit
  on failure: DecrefBatch rolls back the refs the failed object took;
      unreachable decrements leave flag-0 garbage for GC (paper's model).

Each object in a batch remains its own transaction: a failure raises at
that object after earlier objects committed — retrying the tail reproduces
the serial outcome exactly.

Failure surface: a fault injector callback may crash nodes / abort between
steps (the legacy event points), and the transport's delivery policy may
drop, delay, or partition messages (the message-level failure space). When
a fault injector is listening, writes auto-select the chunk-granular
message shape so every per-chunk event window stays observable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.chunking import ChunkingSpec
from repro_torch.core.dmshard import OMAPEntry
from repro_torch.core.fingerprint import (
    Fingerprint,
    name_fp,
    object_fp,
)
from repro_torch.core.messages import (
    CONTROL_MSG_BYTES,
    ChunkOp,
    ChunkOpBatch,
    ChunkRead,
    ChunkReadBatch,
    DecrefBatch,
    OmapDelete,
    OmapGet,
    OmapPut,
    PresenceInvalidate,
    RefOnlyWrite,
    TxnCancel,
)
from repro_torch.core.node import ChunkMissing, NodeDown, StorageNode
from repro_torch.core.placement import ClusterMap, place
from repro_torch.core.transport import MessageDropped, Transport

# fault injector signature: (event, context-dict) -> None. May raise
# TransactionAbort or call cluster.crash_node() to model failures.
FaultInjector = Callable[[str, dict], None]


class TransactionAbort(RuntimeError):
    pass


class WriteError(RuntimeError):
    pass


class ReadError(RuntimeError):
    pass


class ClusterStats:
    """Legacy stats facade. Transaction-outcome counters live here; all
    network/message counters are *views* over the Transport's accounting
    (legacy field names preserved — nothing hand-maintains them anymore)."""

    def __init__(self, transport: Transport, nodes: dict | None = None):
        self._transport = transport
        self._nodes = nodes if nodes is not None else {}
        self.logical_bytes_written = 0
        self.writes_ok = 0
        self.writes_failed = 0
        # Commit-version races under concurrent sessions: the write landed
        # (>=1 OMAP replica acked) but every replica's version gate refused
        # it because a concurrent committer got there with a newer version
        # first. Semantically a committed-then-instantly-replaced write:
        # counted in writes_ok, its refs rolled back, never readable.
        self.writes_superseded = 0
        self.reads_ok = 0
        self.rebalance_bytes_moved = 0
        self.rebalance_chunks_moved = 0
        # Scheduled-session pipelining: waves whose k+1 chunking ran while
        # wave k's chunk unicasts were still in flight (un-committed) — the
        # overlap the discrete-event scheduler buys (see docs/concurrency.md).
        self.waves_overlapped = 0
        # Write-back / presence cache counters (core/write_cache.py). The
        # caches of every DedupClient session on this cluster accumulate
        # here, so the columns are cluster-wide and survive session close.
        self.probe_elisions = 0        # CIT probes elided by presence hits
        self.cache_hits = 0            # presence-cache hits at plan time
        self.cache_misses = 0          # presence-cache misses at plan time
        self.cache_evictions = 0       # LRU evictions from presence caches
        self.cache_invalidations = 0   # fps dropped by PresenceInvalidate
        self.presence_fallbacks = 0    # stale presence -> byte resends
        self.peak_dirty_bytes = 0      # high-water dirty chunk bytes (host)
        # Coalesced restore engine counters (read_objects). fetch_elisions
        # is the read-side twin of probe_elisions: duplicate fingerprint
        # references inside one restore batch whose bytes were fetched once
        # and reused (the first-reader cache), never re-requested.
        self.read_batches = 0          # ChunkReadBatch unicasts planned
        self.read_fallback_rounds = 0  # follow-up waves re-requesting misses
        self.fetch_elisions = 0        # duplicate chunk fetches elided

    @property
    def net_bytes(self) -> int:
        """Payload bytes crossing the network (transport view)."""
        return self._transport.net_bytes

    @property
    def control_msgs(self) -> int:
        """Messages sent through the transport (lookup/ack/refcount/... )."""
        return self._transport.messages_sent

    @property
    def lookup_unicasts(self) -> int:
        return self._transport.lookup_unicasts

    @property
    def lookup_broadcasts(self) -> int:
        return self._transport.lookup_broadcasts  # always 0 — the paper's point

    # --- at-least-once delivery counters (transport views) -----------------
    @property
    def retransmits(self) -> int:
        """Wire-level re-sends chasing lost messages/acks (not counted in
        ``control_msgs``, which stays the logical message count)."""
        return self._transport.retransmits

    @property
    def acks(self) -> int:
        """Delivery acks sent back to senders (one per handler delivery,
        including duplicate/late copies)."""
        return self._transport.acks_sent

    @property
    def ack_bytes(self) -> int:
        """Wire bytes spent on acks — included in ``net_bytes``."""
        return self._transport.ack_bytes

    @property
    def msgs_dropped(self) -> int:
        return self._transport.dropped

    @property
    def duplicate_deliveries(self) -> int:
        """Extra copies that reached a handler (duplicate/reorder faults);
        the receivers' seen-windows made them state no-ops."""
        return self._transport.late_deliveries

    @property
    def timeout_ticks_waited(self) -> int:
        """Simulated ticks senders spent waiting on acks that never came."""
        return self._transport.timeout_ticks_waited

    # --- seen-window eviction pressure (per-node, aggregated) --------------
    @property
    def seen_evictions(self) -> int:
        """Message ids the bounded per-node seen-windows pushed out. Zero
        at default sizing; anything else means in-flight depth approached
        the point where a late duplicate could slip past dedup (the
        ROADMAP's seen-window sizing signal)."""
        return sum(n.stats.seen_evictions for n in self._nodes.values())

    @property
    def seen_high_water(self) -> int:
        """Peak seen-window occupancy across nodes — how close the cluster
        came to eviction pressure."""
        return max(
            (n.stats.seen_high_water for n in self._nodes.values()), default=0
        )

    def snapshot(self) -> dict:
        """One-call dict view of every counter — the stable consumption
        surface for benches and ``check_bench_regression.py`` (preferred
        over attribute-poking, which couples callers to which counters are
        plain fields vs transport views). Keys are the attribute names;
        values are plain ints, safe to serialize."""
        return {
            "logical_bytes_written": self.logical_bytes_written,
            "writes_ok": self.writes_ok,
            "writes_failed": self.writes_failed,
            "writes_superseded": self.writes_superseded,
            "waves_overlapped": self.waves_overlapped,
            "reads_ok": self.reads_ok,
            "rebalance_bytes_moved": self.rebalance_bytes_moved,
            "rebalance_chunks_moved": self.rebalance_chunks_moved,
            "net_bytes": self.net_bytes,
            "control_msgs": self.control_msgs,
            "lookup_unicasts": self.lookup_unicasts,
            "lookup_broadcasts": self.lookup_broadcasts,
            "retransmits": self.retransmits,
            "acks": self.acks,
            "ack_bytes": self.ack_bytes,
            "msgs_dropped": self.msgs_dropped,
            "duplicate_deliveries": self.duplicate_deliveries,
            "timeout_ticks_waited": self.timeout_ticks_waited,
            "seen_evictions": self.seen_evictions,
            "seen_high_water": self.seen_high_water,
            "probe_elisions": self.probe_elisions,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_evictions": self.cache_evictions,
            "cache_invalidations": self.cache_invalidations,
            "presence_fallbacks": self.presence_fallbacks,
            "peak_dirty_bytes": self.peak_dirty_bytes,
            "read_batches": self.read_batches,
            "read_fallback_rounds": self.read_fallback_rounds,
            "fetch_elisions": self.fetch_elisions,
        }

    def __repr__(self) -> str:  # debugging convenience
        return (
            f"ClusterStats(logical={self.logical_bytes_written}, "
            f"net={self.net_bytes}, msgs={self.control_msgs}, "
            f"lookups={self.lookup_unicasts}, ok={self.writes_ok}, "
            f"failed={self.writes_failed}, reads={self.reads_ok})"
        )


@dataclass
class DedupCluster:
    cmap: ClusterMap
    chunking: ChunkingSpec = field(default_factory=ChunkingSpec)
    nodes: dict[str, StorageNode] = field(default_factory=dict)
    transport: Transport | None = None
    stats: ClusterStats | None = None
    now: int = 0
    fault_injector: FaultInjector | None = None
    send_fingerprint_first: bool = False   # beyond-paper: lookup-before-send
    # Per-node message batching: None = auto (batched unless a fault injector
    # is listening, since the batched unicast has no between-chunk event
    # windows); True/False force it regardless of observers.
    batch_unicasts: bool | None = None
    # Cross-object unicast coalescing: one ChunkOpBatch per node for a whole
    # write_objects() batch (False reproduces the per-object message shape).
    coalesce_batches: bool = True
    # Coalesced restore: one ChunkReadBatch per target node for a whole
    # read_objects() batch, with cross-object duplicate-fetch elision
    # (False reproduces the serial per-chunk ChunkRead shape — the read
    # oracle the batched engine is proven byte-identical to).
    batch_reads: bool = True
    # At-least-once delivery: retransmissions chasing a lost message/ack
    # (0 = legacy fire-and-forget) and the simulated-ticks ack timeout per
    # attempt. None = unset: inherit the transport's settings (an injected
    # transport keeps its own, a created one uses the Transport defaults);
    # any explicit value — INCLUDING an explicit 0 / 2 — wins over an
    # injected transport's configuration. After construction both fields
    # mirror the transport's truth.
    retry_budget: int | None = None
    ack_timeout: int | None = None
    _txn_counter: int = 0
    # DedupClient sessions with a presence cache, keyed by session id —
    # the fan-out targets of PresenceInvalidate (delete/GC/reap). Sessions
    # register via ``_register_session`` (done by DedupClient itself);
    # cache-disabled sessions never register, so clusters without presence
    # caching see zero extra messages or handlers.
    _sessions: dict = field(default_factory=dict)
    _session_seq: int = 0
    _pending_inval: list = field(default_factory=list)
    _default_session: object | None = field(default=None, repr=False)
    # Fingerprints of waves that are SENT but not yet COMMITTED, keyed by
    # batch txn. Under the Scheduler a session yields between ``_wave_send``
    # and ``_wave_commit``, so a repair round can start inside that window;
    # its refcount audit would otherwise see the wave's chunk refs with no
    # committed recipe referencing them and decref live data. The registry
    # is the host's own in-flight transaction knowledge (same authority as
    # ``exclude_after``), not cross-node state. The synchronous write path
    # runs all three phases back-to-back, so it is always empty there.
    _inflight_wave_fps: dict = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.transport is None:
            self.transport = Transport(handlers=self.nodes)
        self.transport.fault_hook = self._transport_fault
        if self.retry_budget is not None:
            self.transport.retry_budget = self.retry_budget
        if self.ack_timeout is not None:
            self.transport.ack_timeout = self.ack_timeout
        self.retry_budget = self.transport.retry_budget
        self.ack_timeout = self.transport.ack_timeout
        if self.stats is None:
            self.stats = ClusterStats(self.transport, self.nodes)

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(
        cls,
        n_nodes: int,
        replicas: int = 1,
        chunking: ChunkingSpec | None = None,
        policy=None,
        **kw,
    ) -> "DedupCluster":
        ids = tuple(f"oss{i}" for i in range(n_nodes))
        cmap = ClusterMap(epoch=1, nodes=ids, replicas=replicas)
        c = cls(cmap=cmap, chunking=(chunking or ChunkingSpec()).normalized(), **kw)
        for nid in ids:
            c.nodes[nid] = StorageNode(nid)
            c.nodes[nid].set_cmap(cmap, 0)
        if policy is not None:
            c.transport.policy = policy
        return c

    def node(self, nid: str) -> StorageNode:
        return self.nodes[nid]

    def crash_node(self, nid: str) -> None:
        self.nodes[nid].crash()

    def restart_node(self, nid: str) -> None:
        self.nodes[nid].restart()

    def set_clock_skew(self, offsets: dict[str, int], guard: bool = True) -> int:
        """Inject bounded per-node clock skew (ROADMAP item 4): each node's
        local clock reads ``now + offsets.get(node_id, 0)``. With ``guard``
        (the default, and what a deployment that KNOWS its skew bound would
        configure) every node also widens its tombstone-reap horizon by the
        bound ``max(|offset|)``, so the fastest clock in the fleet cannot
        nominate a tombstone for reaping before its true age passes the GC
        horizon. ``guard=False`` models the unguarded deployment — the
        chaos schedule in tests/test_simclock.py shows a fast clock reaping
        early and resurrecting a deleted object without it. Returns the
        skew bound applied."""
        max_skew = max((abs(v) for v in offsets.values()), default=0)
        for nid, node in self.nodes.items():
            node.clock_offset = offsets.get(nid, 0)
            node.skew_guard = max_skew if guard else 0
        return max_skew

    def tick(self, dt: int = 1) -> None:
        """Advance simulated time; land in-flight (duplicated/reordered)
        message copies, then drain async consistency queues."""
        for _ in range(dt):
            self.now += 1
            self.transport.advance(self.now)
            for n in self.nodes.values():
                n.tick(self.now)
        self._flush_presence_invalidations()

    def run_gc(self) -> dict[str, list[Fingerprint]]:
        removed = {nid: n.run_gc(self.now) for nid, n in self.nodes.items()}
        # Each node's GC hook queued its reclaimed fps (when sessions are
        # registered); fan the invalidations out now, after every node ran.
        self._flush_presence_invalidations()
        return removed

    # -------------------------------------------------- client sessions
    def client(
        self, presence_cache: int = 0, wave_bytes: int = 0, src: str = "client"
    ):
        """Open a ``DedupClient`` session on this cluster — the public
        write/read surface (``put/put_many/get/delete/flush/close``).
        ``src`` names the session's transport endpoint: distinct names give
        concurrent sessions their own per-edge accounting (the multi-tenant
        workload opens ``c0..cN-1``); the default keeps every legacy edge
        key byte-identical."""
        from repro_torch.core.client import DedupClient

        return DedupClient(
            self, presence_cache=presence_cache, wave_bytes=wave_bytes, src=src
        )

    def _default_client(self):
        """The cache-disabled session backing the legacy
        ``write_object``/``write_objects`` shims."""
        if self._default_session is None:
            self._default_session = self.client()
        return self._default_session

    def _register_session(self, session) -> None:
        """Register a presence-caching session as an invalidation fan-out
        target: it becomes addressable on the transport (under its session
        id) and every node's GC gains a reclaim hook feeding the
        invalidation queue."""
        if session.session_id is None:
            session.session_id = f"session{self._session_seq}"
            self._session_seq += 1
        self._sessions[session.session_id] = session
        self.transport.extra_handlers[session.session_id] = session
        self._wire_gc_hooks()

    def _unregister_session(self, session) -> None:
        self._sessions.pop(session.session_id, None)
        self.transport.extra_handlers.pop(session.session_id, None)

    def _wire_gc_hooks(self) -> None:
        for nid, n in self.nodes.items():
            if n.gc.on_reclaim is None:
                n.gc.on_reclaim = (
                    lambda fps, _nid=nid: self._queue_presence_invalidation(
                        _nid, fps
                    )
                )

    def _queue_presence_invalidation(self, nid: str, fps) -> None:
        if self._sessions and fps:
            self._pending_inval.append((nid, tuple(fps)))

    def _flush_presence_invalidations(self) -> None:
        if not self._pending_inval:
            return
        pending, self._pending_inval = self._pending_inval, []
        for nid, fps in pending:
            self._invalidate_presence(nid, fps, "gc")

    def _invalidate_presence(self, src: str, fps, reason: str) -> None:
        """Fan a ``PresenceInvalidate`` out to every registered session.
        Best-effort on purpose: a lost/partitioned invalidation leaves
        stale presence, which the receiver-side validation of presence
        ops degrades to a fallback byte resend — never a dangling ref."""
        if not self._sessions or not fps:
            return
        msg = PresenceInvalidate(tuple(fps), reason)
        for sid in list(self._sessions):
            try:
                self.transport.send(src, sid, msg, self.now)
            except (MessageDropped, NodeDown):
                pass

    # -------------------------------------------------------------- fault hook
    def _fault(self, event: str, **ctx) -> None:
        if self.fault_injector is not None:
            self.fault_injector(event, {"now": self.now, **ctx})

    def _transport_fault(self, event: str, ctx: dict) -> None:
        self._fault(event, **ctx)

    # ------------------------------------------------------------ placement
    def chunk_targets(self, fp: Fingerprint) -> list[str]:
        return place(fp, self.cmap)

    def omap_targets(self, name: str) -> list[str]:
        return place(name_fp(name), self.cmap)

    def _live(self, targets: list[str]) -> list[str]:
        return [t for t in targets if self.nodes[t].alive]

    # ----------------------------------------------------------------- write
    def write_object(self, name: str, data: bytes) -> Fingerprint:
        """Complete write transaction. Returns the object fingerprint.

        .. deprecated:: use ``DedupClient.put_many`` (``cluster.client()``)
           — the session facade is the public write surface and owns the
           write-back/presence caches. This shim delegates to a
           cache-disabled default session and keeps the legacy
           message-for-message behavior."""
        return self.write_objects([(name, data)])[0]

    def write_objects(self, items: list[tuple[str, bytes]]) -> list[Fingerprint]:
        """Batched write pipeline: semantically identical to looping
        ``write_object`` (same fingerprints, refcounts, OMAP state,
        rollback behavior and fault event points) but vectorized, coalesced
        per target node, and streamed in bounded waves — see
        ``DedupClient.put_many`` (core/client.py) for the full contract.

        .. deprecated:: use ``DedupClient.put_many`` (``cluster.client()``)
           — this shim delegates to a cache-disabled default session
           (presence cache off, unbounded waves), preserving the legacy
           message shape byte-for-byte."""
        return self._default_client().put_many(items)

    # ---------------------------------------------- coalesced batch write
    def _write_wave(self, wave: list, session=None) -> list[Fingerprint]:
        """One coalesced write wave (unique object names), synchronously:
        plan, send, commit back to back. This is the call-driven path every
        legacy caller rides; the discrete-event scheduler drives the same
        three phases through ``DedupClient.put_wave_actor`` with a yield
        between send and commit so concurrent sessions interleave — both
        paths produce the identical message sequence for a single session
        (chunking emits no messages, so deferring commit past the next
        wave's chunking changes nothing on the wire).

        Three phases — ``_wave_plan`` (per object, in order: ingress,
        idempotence/replace check, target placement, intra-batch dedup),
        ``_wave_send`` (ONE ChunkOpBatch per target node for the whole
        wave, plus the stale-presence byte-resend fallback),
        ``_wave_commit`` (per object, in order: OmapPut; rollback + raise
        at the first failure, releasing the refs of every not-yet-committed
        object so a retry of the tail reproduces the serial outcome).

        ``session`` (a ``DedupClient``) hooks the presence cache in: a
        plan-time presence hit turns a would-ship-bytes op into a
        presence-asserted ref-only op (no bytes travel, no CIT probe is
        booked — ``probe_elisions``); a receiver answering 'miss' for such
        an op (stale presence: the invalidation was lost or is still in
        flight) triggers a fallback resend of the actual bytes before the
        commit phase judges acks, so staleness degrades to the ordinary
        path instead of failing the write. Acked storing outcomes teach
        the session's presence cache. ``session=None`` (or a session with
        the cache disabled) reproduces the legacy behavior exactly.
        """
        state = self._wave_plan(wave, session)
        self._wave_send(state, session)
        return self._wave_commit(state, session)

    def _wave_plan(self, wave: list, session=None) -> dict:
        """Plan phase: per object, in order — txn allocation, ingress
        transfer, idempotence/replace check, chunk target placement,
        intra-batch first-writer dedup and presence elision. Returns the
        wave state dict threaded through ``_wave_send``/``_wave_commit``:
        ``plans``, ``planning_failure``, ``batch_txn``, ``src`` (the
        session's transport endpoint) and ``committed`` (filled at commit:
        ``(name, version)`` per committed object — the serialization
        witness the concurrent-session oracle replays)."""
        src = getattr(session, "src", "client")
        plans: list[dict] = []
        # (exc, obj size, counted in writes_failed) — a planning failure is
        # raised only after the objects planned before it have committed.
        planning_failure: tuple[Exception, int, bool] | None = None
        first_writer: set[Fingerprint] = set()

        for name, data, chunks, fps in wave:
            self._txn_counter += 1
            txn = self._txn_counter
            self.stats.logical_bytes_written += len(data)
            omap_nodes = self._live(self.omap_targets(name))
            if not omap_nodes:
                self.stats.writes_failed += 1
                planning_failure = (
                    WriteError(f"no live OMAP target for {name!r}"),
                    len(data),
                    True,
                )
                break
            primary = omap_nodes[0]
            self.transport.client_transfer(primary, len(data), src=src)
            try:
                self._fault("primary_selected", name=name, primary=primary, txn=txn)
                prev = self._omap_lookup(name, src=primary, strict=True)
            except TransactionAbort as e:
                # The serial loop re-raises planning-phase aborts uncounted;
                # earlier objects still commit before we propagate it.
                planning_failure = (e, len(data), False)
                break
            except WriteError as e:
                self.stats.writes_failed += 1
                planning_failure = (e, len(data), True)
                break
            if prev is not None:
                if prev.object_fp == object_fp(fps):
                    self.stats.writes_ok += 1
                    plans.append(
                        {"kind": "done", "name": name, "ofp": prev.object_fp,
                         "size": len(data)}
                    )
                    continue
                # Rewriting different content replaces the old object — but
                # the old refs (the fetched ``prev`` entry, kept on the
                # plan) are released at *commit* time, so an earlier
                # object's failure (which aborts this whole tail) leaves the
                # previous version intact, exactly like the serial loop that
                # never reached this item.

            ops: list[tuple[int, Fingerprint, bytes | None, list[str], bool]] = []
            failed_chunk: int | None = None
            for i, (fp, chunk) in enumerate(zip(fps, chunks)):
                live = self._live(self.chunk_targets(fp))
                if not live:
                    failed_chunk = i
                    break
                # Intra-batch dedup: the first writer of a fingerprint ships
                # bytes; every later op in the wave is ref-only (the bytes
                # are already on the same placement targets). A presence-
                # cache hit makes even the first writer ref-only — asserted
                # (presence=True) rather than known, so the receiver
                # validates and the send phase falls back on 'miss'.
                payload = None if fp in first_writer else chunk
                presence = False
                if (
                    payload is not None
                    and session is not None
                    and session.presence_hit(fp)
                ):
                    payload = None
                    presence = True
                first_writer.add(fp)
                ops.append((i, fp, payload, live, presence))
            if failed_chunk is not None:
                self.stats.writes_failed += 1
                cause = WriteError(f"chunk {failed_chunk} of {name!r}: no live target")
                exc = WriteError(f"write {name!r} failed: {cause}")
                exc.__cause__ = cause
                planning_failure = (exc, len(data), True)
                break
            plans.append(
                {
                    "kind": "write",
                    "name": name,
                    "data": data,
                    "chunks": chunks,  # kept resident for presence fallback
                    "fps": fps,
                    "ops": ops,
                    "primary": primary,
                    "txn": txn,
                    "prev": prev,  # non-None only for replaces (done short-circuits)
                    "acked": {i: [] for i, _, _, _, _ in ops},
                }
            )
        return {
            "plans": plans,
            "planning_failure": planning_failure,
            "batch_txn": self._txn_counter,
            "src": src,
            "committed": [],
        }

    def _wave_send(self, state: dict, session=None) -> None:
        """Send phase: one ChunkOpBatch per target node for the whole wave,
        then the stale-presence fallback resends. After this returns the
        wave is IN FLIGHT: every chunk op is acked (or definitively not),
        but no commit record exists yet — the window a scheduled session
        yields in while other sessions run."""
        plans = state["plans"]
        src = state["src"]
        batch_txn = state["batch_txn"]
        node_ops: dict[str, list[ChunkOp]] = {}
        node_refs: dict[str, list[tuple[int, int]]] = {}  # (plan idx, chunk idx)
        for pi, plan in enumerate(plans):
            if plan["kind"] != "write":
                continue
            primary = plan["primary"]
            for i, fp, payload, live, presence in plan["ops"]:
                op = ChunkOp(fp, payload, origin=primary, presence=presence)
                for t in live:
                    node_ops.setdefault(t, []).append(op)
                    node_refs.setdefault(t, []).append((pi, i))
        fallback: dict[str, list[tuple[int, int]]] = {}
        for t, ops in node_ops.items():
            elided = sum(1 for op in ops if op.presence)
            if elided:
                self.stats.probe_elisions += elided
            msg = ChunkOpBatch(
                ops=tuple(ops),
                txn=batch_txn,
                fp_first=self.send_fingerprint_first,
            )
            try:
                outcomes = self.transport.send(src, t, msg, self.now)
            except MessageDropped as e:
                # Nothing acked on this node — but the ops may have applied
                # ("ack lost"): a conditional cancel settles it receiver-side
                # before the commit phase fails any object with an unacked
                # chunk.
                self._cancel_unconfirmed(
                    src, t, e, fps=tuple(op.fp for op in ops)
                )
                continue
            except (NodeDown, TransactionAbort):
                # Aborted before delivery: nothing applied on this node; the
                # commit phase fails (and rolls back) any object that ends
                # up with an unacked chunk.
                continue
            for (pi, i), outcome in zip(node_refs[t], outcomes):
                if outcome != "miss":
                    plans[pi]["acked"][i].append(t)
                    if session is not None:
                        session.presence_note(plans[pi]["fps"][i])
                elif session is not None:
                    # 'miss' only happens when a presence assertion (this
                    # op's, or the elided first-writer's earlier in the same
                    # batch) was stale — queue a byte resend.
                    fallback.setdefault(t, []).append((pi, i))

        # ---- fallback: stale presence degrades to shipping the bytes ------
        for t, refs in fallback.items():
            for pi, i in refs:
                session.presence_drop(plans[pi]["fps"][i])
            ops = tuple(
                ChunkOp(
                    plans[pi]["fps"][i],
                    plans[pi]["chunks"][i],
                    origin=plans[pi]["primary"],
                )
                for pi, i in refs
            )
            self.stats.presence_fallbacks += len(ops)
            msg = ChunkOpBatch(
                ops=ops, txn=batch_txn, fp_first=self.send_fingerprint_first
            )
            try:
                outcomes = self.transport.send(src, t, msg, self.now)
            except MessageDropped as e:
                self._cancel_unconfirmed(
                    src, t, e, fps=tuple(op.fp for op in ops)
                )
                continue
            except (NodeDown, TransactionAbort):
                continue
            for (pi, i), outcome in zip(refs, outcomes):
                if outcome != "miss":
                    plans[pi]["acked"][i].append(t)
                    session.presence_note(plans[pi]["fps"][i])

        # The wave is now in flight: its chunk refs exist on the owners but
        # no commit record does. Register its fingerprints so a concurrently
        # scheduled repair round's refcount audit defers them (exactly like
        # ``exclude_after`` defers same-round writes); ``_wave_commit`` (or
        # the actor's abort path) releases the registration.
        pending = {
            fp
            for plan in plans
            if plan["kind"] == "write"
            for fp in plan["fps"]
        }
        if pending:
            self._inflight_wave_fps[batch_txn] = pending

    def release_inflight_wave(self, batch_txn: int) -> None:
        """Drop a wave's in-flight audit registration (idempotent). Called
        by ``_wave_commit`` on entry — commit runs without yield points, so
        no audit can interleave past this — and by ``put_wave_actor``'s
        abort path when a sent wave will never reach its commit."""
        self._inflight_wave_fps.pop(batch_txn, None)

    def inflight_audit_fps(self) -> set[Fingerprint]:
        """Union of fingerprints in sent-but-uncommitted waves — the set a
        refcount audit must treat as in-flight (see ``_inflight_wave_fps``)."""
        out: set[Fingerprint] = set()
        for fps in self._inflight_wave_fps.values():
            out |= fps
        return out

    def _wave_commit(self, state: dict, session=None) -> list[Fingerprint]:
        """Commit phase: per object, in order — OmapPut the commit record,
        release the refs of the version the put actually displaced, roll
        back and raise at the first failure. The displaced version comes
        from the put's RESPONSE, not the plan-time lookup: with concurrent
        sessions two replacers can both plan against the same previous
        entry, and releasing the plan-time fetch would double-release the
        refs of a version only one of them displaced. A write whose every
        replica refused the put (version gate: a concurrent committer got
        a newer version in first) is ``superseded``: its refs roll back,
        it counts in ``writes_ok`` + ``writes_superseded``, and it never
        enters ``state['committed']`` — exactly a committed write replaced
        an instant later, minus the wire traffic."""
        self.release_inflight_wave(state["batch_txn"])
        plans = state["plans"]
        planning_failure = state["planning_failure"]
        results: list[Fingerprint] = []
        failure: Exception | None = None
        for plan in plans:
            if plan["kind"] == "done":
                if failure is not None:
                    # Serial never reached this item; undo its no-op commit.
                    self.stats.writes_ok -= 1
                    self.stats.logical_bytes_written -= plan["size"]
                else:
                    results.append(plan["ofp"])
                continue
            if failure is not None:
                # An earlier object already failed: this one never commits.
                # Undo its refs and its logical accounting (a retry of the
                # tail will re-run it, exactly like the serial loop).
                self._rollback_refs(plan["primary"], plan["acked"], plan["ops"])
                self.stats.logical_bytes_written -= len(plan["data"])
                continue
            name, primary = plan["name"], plan["primary"]
            try:
                bad = next(
                    (i for i, _, _, _, _ in plan["ops"] if not plan["acked"][i]),
                    None,
                )
                if bad is not None:
                    raise WriteError(f"chunk {bad} of {name!r}: no live target")
                self._fault("before_omap", name=name, txn=plan["txn"])
                if not self.nodes[primary].alive:
                    raise NodeDown(primary)
                ofp = object_fp(plan["fps"])
                entry = OMAPEntry(
                    name, ofp, list(plan["fps"]), len(plan["data"]), plan["txn"]
                )
                wrote, applied, prev = self._commit_omap(primary, name, entry)
                if not wrote:
                    raise WriteError(f"no live OMAP target for {name!r} at commit")
            except (NodeDown, TransactionAbort, WriteError) as e:
                self._rollback_refs(primary, plan["acked"], plan["ops"])
                self.stats.writes_failed += 1
                failure = WriteError(f"write {name!r} failed: {e}")
                failure.__cause__ = e
                continue
            if not applied:
                # Every replica's version gate refused the record: a
                # concurrent session committed a newer version between our
                # plan and commit. Superseded — roll back our refs (the
                # winner's are the live ones) and report success.
                self._rollback_refs(primary, plan["acked"], plan["ops"])
                self.stats.writes_superseded += 1
                self.stats.writes_ok += 1
                results.append(ofp)
                continue
            if prev is not None and not prev.deleted:
                # Release the refs of the version THIS put displaced —
                # response-carried, so concurrent replacers each release a
                # distinct version exactly once — only now that the commit
                # record is durably written (the OmapPut overwrote the old
                # entry in place — no OmapDelete needed): a failure
                # anywhere before this leaves the previous version fully
                # intact. A displaced TOMBSTONE took no refs (the delete
                # released them). The new ops already took their refs, so
                # shared chunks dip to N, not 0.
                self._release_entry_refs(prev, src=primary)
            self.stats.writes_ok += 1
            state["committed"].append((name, plan["txn"]))
            results.append(ofp)

        if failure is not None:
            if planning_failure is not None:
                # Serial would have stopped at the commit failure, never
                # reaching the planning-failed item: undo its accounting.
                if planning_failure[2]:
                    self.stats.writes_failed -= 1
                self.stats.logical_bytes_written -= planning_failure[1]
            raise failure
        if planning_failure is not None:
            raise planning_failure[0]
        return results

    def _commit_omap(
        self, src: str, name: str, entry: OMAPEntry
    ) -> tuple[bool, bool, OMAPEntry | None]:
        """Write the commit record to every live OMAP replica. Returns
        ``(wrote, applied, prev)``: ``wrote`` — at least one replica acked
        (the transaction commits); ``applied`` — at least one replica's
        version gate accepted the record (False means a concurrent
        committer superseded this write before it landed anywhere);
        ``prev`` — the record the FIRST applying replica in placement
        order displaced (entry or tombstone, None for a fresh name). The
        first-in-placement-order choice matters: the primary is the
        authority the plan-time lookup consulted, and a lagging replica
        that missed an earlier replace would report a version whose refs
        were already released — taking the earliest live replica's answer
        keeps release exactly-once under both races and replica lag.

        When NO replica acks, any maybe-applied put is conditionally
        cancelled receiver-side so a failed transaction cannot leave a
        committed-looking entry behind — and because the OmapPut is
        idempotent and cancels are conditional, a RETRIED commit neither
        double-applies nor rolls back a replica that did commit: a replica
        that applied the first put simply re-acks it (response included:
        the same (applied, prev) tuple) from its seen-window."""
        wrote = False
        applied = False
        prev: OMAPEntry | None = None
        unconfirmed: list[tuple[str, MessageDropped]] = []
        for t in self._live(self.omap_targets(name)):
            try:
                resp = self.transport.send(src, t, OmapPut(entry), self.now)
                wrote = True
                if not applied and isinstance(resp, tuple) and resp[0]:
                    applied = True
                    prev = resp[1]
            except MessageDropped as e:
                unconfirmed.append((t, e))
        if not wrote:
            for t, e in unconfirmed:
                self._cancel_unconfirmed(src, t, e, omap_name=name)
        return wrote, applied, prev

    def _cancel_unconfirmed(
        self,
        src: str,
        dst: str,
        exc: MessageDropped,
        fps: tuple = (),
        omap_name: str | None = None,
        undelete_version: int = 0,
    ) -> None:
        """Resolve the at-least-once ambiguity after a send exhausted its
        retry budget: when ``maybe_applied`` the op may have landed without
        its ack, so a blind rollback would either miss applied refs
        ("ack lost, op applied") or double-release ("op lost"). The
        conditional ``TxnCancel`` decides AT the receiver: compensate if
        the message id is in its seen-window, otherwise poison the id so a
        copy still in flight is discarded. Best-effort — a cancel that is
        itself lost leaves at worst the legacy unreachable-node garbage."""
        if not exc.maybe_applied:
            return  # no attempt reached the receiver: nothing ever applied
        try:
            self.transport.send(
                src,
                dst,
                TxnCancel(
                    exc.msg_id,
                    tuple(fps),
                    omap_name,
                    undelete=undelete_version > 0,
                    ref_version=undelete_version,
                ),
                self.now,
            )
        except (MessageDropped, NodeDown):
            pass

    def _rollback_refs(self, src: str, acked: dict, ops) -> None:
        """Release the refcounts one failed wave object took (plan shape)."""
        self._rollback_acked(src, ((fp, acked[i]) for i, fp, _, _, _ in ops))

    def _rollback_acked(self, src: str, pairs) -> None:
        """Release acked (fp, nodes) refs, one DecrefBatch per node.
        Unreachable decrements leave flag-0 garbage for GC — the paper's
        failure model."""
        undo: dict[str, list[Fingerprint]] = {}
        for fp, on in pairs:
            for t in on:
                undo.setdefault(t, []).append(fp)
        for t, undo_fps in undo.items():
            node = self.nodes.get(t)
            if node is None or not node.alive:
                continue
            try:
                self.transport.send(src, t, DecrefBatch(tuple(undo_fps)), self.now)
            except (MessageDropped, NodeDown):
                pass

    # ------------------------------------------------- per-object write path
    def _write_prepared(
        self,
        name: str,
        data: bytes,
        chunks: list[bytes],
        fps: list[Fingerprint],
        batched: bool,
    ) -> Fingerprint:
        """One object's write transaction over pre-chunked, pre-fingerprinted
        content (paper Fig 3, steps after the primary's chunk+fingerprint)."""
        self._txn_counter += 1
        txn = self._txn_counter
        self.stats.logical_bytes_written += len(data)

        # 1. client -> primary OSS by object-name hash (full object travels).
        omap_nodes = self._live(self.omap_targets(name))
        if not omap_nodes:
            self.stats.writes_failed += 1
            raise WriteError(f"no live OMAP target for {name!r}")
        primary = omap_nodes[0]
        self.transport.client_transfer(primary, len(data))
        self._fault("primary_selected", name=name, primary=primary, txn=txn)

        # Idempotence: rewriting an identical object is a no-op; rewriting
        # different content under an existing name replaces it — but the
        # old refs are released at COMMIT time (matching the coalesced
        # wave): a failed replace leaves the previous version fully intact,
        # so a client retry releases it exactly once instead of
        # double-decrementing refs a failed first attempt already dropped.
        try:
            prev = self._omap_lookup(name, src=primary, strict=True)
        except WriteError:
            self.stats.writes_failed += 1
            raise
        if prev is not None and prev.object_fp == object_fp(fps):
            self.stats.writes_ok += 1
            return prev.object_fp

        # 2. fingerprint-routed chunk unicasts, batched per target node.
        acked: list[tuple[Fingerprint, list[str]]] = []
        try:
            if batched:
                acked, fail_idx = self._route_chunks_batched(primary, fps, chunks, txn)
                if fail_idx is not None:
                    raise WriteError(f"chunk {fail_idx} of {name!r}: no live target")
            else:
                # Chunk-granular path: a batched unicast has no window between
                # two chunk ops, so when a fault injector is listening we keep
                # per-chunk messaging to preserve every observable event point
                # (before/after_chunk_op at each index).
                for i, (fp, chunk) in enumerate(zip(fps, chunks)):
                    self._fault("before_chunk_op", name=name, index=i, fp=fp, txn=txn)
                    written_on = self._send_chunk_granular(primary, fp, chunk, txn)
                    if not written_on:
                        raise WriteError(f"chunk {i} of {name!r}: no live target")
                    acked.append((fp, written_on))
                    self._fault("after_chunk_op", name=name, index=i, fp=fp, txn=txn)

            # 3. all chunks acked -> OMAP entry on primary (+ replicas).
            self._fault("before_omap", name=name, txn=txn)
            if not self.nodes[primary].alive:
                raise NodeDown(primary)
            ofp = object_fp(fps)
            entry = OMAPEntry(name, ofp, list(fps), len(data), txn)
            wrote, applied, replaced = self._commit_omap(primary, name, entry)
            if not wrote:
                raise WriteError(f"no live OMAP target for {name!r} at commit")
        except (NodeDown, TransactionAbort, WriteError) as e:
            # Failed object transaction: best-effort rollback of the
            # refcounts we took.
            self._rollback_acked(primary, acked)
            self.stats.writes_failed += 1
            raise WriteError(f"write {name!r} failed: {e}") from e

        if not applied:
            # Superseded by a concurrent committer's newer version: roll
            # back our refs (the winner's stand) and report success — see
            # ``_wave_commit`` for the semantics.
            self._rollback_acked(primary, acked)
            self.stats.writes_superseded += 1
            self.stats.writes_ok += 1
            return ofp
        if replaced is not None and not replaced.deleted:
            # Committed (the OmapPut overwrote the old entry in place):
            # release the refs of the version this put actually displaced
            # (response-carried — race-safe under concurrent replacers),
            # exactly once. Any failure above left the previous version
            # fully intact; a displaced tombstone took no refs.
            self._release_entry_refs(replaced, src=primary)
        self.stats.writes_ok += 1
        return ofp

    def _route_chunks_batched(
        self, primary: str, fps: list[Fingerprint], chunks: list[bytes], txn: int
    ) -> tuple[list[tuple[Fingerprint, list[str]]], int | None]:
        """Group one object's chunk ops per target node -> one ChunkOpBatch
        each. Returns (acked, fail_idx); fail_idx is the first chunk with no
        live target (or, under a lossy policy, no surviving ack) and —
        matching the serial abort point — no op at or past a planning
        failure is applied."""
        targets_per_chunk: list[list[str]] = []
        fail_idx: int | None = None
        for i, fp in enumerate(fps):
            live = self._live(self.chunk_targets(fp))
            if not live:
                fail_idx = i
                break
            targets_per_chunk.append(live)

        per_node: dict[str, list[int]] = {}
        for i, live in enumerate(targets_per_chunk):
            for t in live:
                per_node.setdefault(t, []).append(i)

        acked_on: dict[int, list[str]] = {i: [] for i in range(len(targets_per_chunk))}
        for t, idxs in per_node.items():
            msg = ChunkOpBatch(
                ops=tuple(ChunkOp(fps[i], chunks[i], origin=primary) for i in idxs),
                txn=txn,
                fp_first=self.send_fingerprint_first,
            )
            try:
                outcomes = self.transport.send(primary, t, msg, self.now)
            except MessageDropped as e:
                # Unacked: settle "applied without ack?" receiver-side; the
                # ack check below decides the transaction's fate.
                self._cancel_unconfirmed(primary, t, e, fps=tuple(fps[i] for i in idxs))
                continue
            for i, outcome in zip(idxs, outcomes):
                if outcome != "miss":
                    acked_on[i].append(t)

        acked = [(fps[i], acked_on[i]) for i in range(len(targets_per_chunk)) if acked_on[i]]
        if fail_idx is None:
            lost = next((i for i in range(len(targets_per_chunk)) if not acked_on[i]), None)
            if lost is not None:
                fail_idx = lost
        return acked, fail_idx

    def _send_chunk_granular(
        self, primary: str, fp: Fingerprint, chunk: bytes, txn: int
    ) -> list[str]:
        """Route one chunk to its replica set, one single-op unicast per
        replica. Returns nodes that took a ref."""
        written_on: list[str] = []
        for t in self.chunk_targets(fp):
            if not self.nodes[t].alive:
                continue
            msg = ChunkOpBatch(
                ops=(ChunkOp(fp, chunk, origin=primary),),
                txn=txn,
                fp_first=self.send_fingerprint_first,
            )
            try:
                outcomes = self.transport.send(primary, t, msg, self.now)
            except MessageDropped as e:
                self._cancel_unconfirmed(primary, t, e, fps=(fp,))
                continue
            if outcomes[0] != "miss":
                written_on.append(t)
        return written_on

    def write_object_by_ref(self, name: str, src_name: str) -> Fingerprint | None:
        """Reference-only write: create object `name` with the same layout as
        `src_name`, incrementing chunk refcounts without moving data
        (checkpointer device-fp fast path) — one RefOnlyWrite unicast per
        target node. Fails (None) if any chunk is invalid and unrepairable,
        in which case the caller falls back to a full write."""
        src = self._omap_lookup(src_name, src="client")
        if src is None:
            return None
        per_node: dict[str, list[Fingerprint]] = {}
        for fp in src.chunk_fps:
            for t in self._live(self.chunk_targets(fp)):
                per_node.setdefault(t, []).append(fp)
        taken: dict[str, list[Fingerprint]] = {}
        holders: dict[Fingerprint, int] = {fp: 0 for fp in src.chunk_fps}
        for t, fps in per_node.items():
            try:
                results = self.transport.send(
                    "client", t, RefOnlyWrite(tuple(fps)), self.now
                )
            except MessageDropped as e:
                self._cancel_unconfirmed("client", t, e, fps=tuple(fps))
                continue
            except NodeDown:
                continue
            for fp, res in zip(fps, results):
                if res != "miss":
                    taken.setdefault(t, []).append(fp)
                    holders[fp] += 1

        def _undo() -> None:
            self._rollback_acked(
                "client", ((fp, (t,)) for t, fps in taken.items() for fp in fps)
            )

        if any(cnt == 0 for cnt in holders.values()):
            _undo()
            return None
        self._txn_counter += 1
        entry = OMAPEntry(
            name, src.object_fp, list(src.chunk_fps), src.size, self._txn_counter
        )
        wrote, applied, _replaced = self._commit_omap("client", name, entry)
        if not wrote or not applied:
            # Never acked, or superseded by a concurrent newer version:
            # the caller falls back to a full write. (A by-ref write over
            # an existing live name keeps the legacy leak-to-audit
            # behavior for the displaced refs — callers write fresh
            # checkpoint names.)
            _undo()
            return None
        self.stats.writes_ok += 1
        self.stats.logical_bytes_written += src.size
        return entry.object_fp

    # ------------------------------------------------------------------ read
    def read_object(self, name: str) -> bytes:
        """Complete read transaction for one object. Rides the coalesced
        restore engine as a one-object batch (``batch_reads=False``
        reproduces the serial per-chunk ``ChunkRead`` shape)."""
        return self.read_objects([name])[0]

    def read_objects(
        self, names: list[str], session=None, frag_out: list | None = None
    ) -> list[bytes]:
        """Coalesced batch restore — the read-side mirror of the write
        path's wave architecture. Plans the WHOLE batch of objects at once:

        1. OMAP probes grouped per primary node (same per-name replica
           fallback and message count as the serial path — only the probe
           order changes, so one node answers its run of names back to
           back);
        2. a batch-local fp->bytes first-reader cache collapses duplicate
           fingerprint references across (and within) the batch's recipes
           — a chunk shared by many objects travels the wire exactly once
           (``ClusterStats.fetch_elisions``), the read-side twin of the
           write path's first-writer cache;
        3. one ``ChunkReadBatch`` per target node carries every distinct
           fp routed there (``read_batches``);
        4. degraded reads stay batched: a reply reports per-fp hit/miss,
           and ONLY the misses are re-requested from each fp's next
           untried live replica in a follow-up wave
           (``read_fallback_rounds``); replicas exhausted raises
           ``ReadError`` — the serial path's failure surface.

        Per acked hit, ``session.presence_note`` teaches the session's
        presence cache (restored bytes are positive existence evidence —
        same currency as an acked write outcome). ``frag_out``, when given
        a list, receives one restore-fragmentation record per object:
        ``{"name", "chunks", "nodes", "max_chunks_one_node"}`` (distinct
        serving nodes touched, and the largest chunk run any single node
        served — the spread ROADMAP item 5's placement work is judged
        against). Objects come back in request order, each verified
        against its recipe's layout fingerprint."""
        if not self.batch_reads:
            return [self._read_object_serial(n) for n in names]
        src = getattr(session, "src", "client")

        # -- plan: OMAP probes grouped per (live-)primary node ------------
        by_primary: dict[str, list[int]] = {}
        for idx, name in enumerate(names):
            live = self._live(self.omap_targets(name))
            by_primary.setdefault(live[0] if live else "", []).append(idx)
        entries: list[OMAPEntry | None] = [None] * len(names)
        for primary in sorted(by_primary):
            for idx in by_primary[primary]:
                entries[idx] = self._omap_lookup(names[idx], src=src)
        for name, entry in zip(names, entries):
            if entry is None:
                raise ReadError(f"object {name!r} not found")

        # -- first-reader cache: distinct fps only, in first-appearance order
        need: list[Fingerprint] = []
        seen_fps: set[Fingerprint] = set()
        total_refs = 0
        for entry in entries:
            for fp in entry.chunk_fps:
                total_refs += 1
                if fp not in seen_fps:
                    seen_fps.add(fp)
                    need.append(fp)
        self.stats.fetch_elisions += total_refs - len(need)

        # -- fetch waves: one ChunkReadBatch per target node per wave -----
        fetched: dict[Fingerprint, bytes] = {}
        served_by: dict[Fingerprint, str] = {}
        tried: dict[Fingerprint, set[str]] = {fp: set() for fp in need}
        pending = need
        last: Exception | None = None
        first_wave = True
        while pending:
            per_node: dict[str, list[Fingerprint]] = {}
            for fp in pending:
                t = next(
                    (t for t in self._live(self.chunk_targets(fp))
                     if t not in tried[fp]),
                    None,
                )
                if t is None:
                    raise ReadError(
                        f"chunk {fp} unreadable on all replicas: {last}"
                    )
                tried[fp].add(t)
                per_node.setdefault(t, []).append(fp)
            if not first_wave:
                self.stats.read_fallback_rounds += 1
            first_wave = False
            misses: list[Fingerprint] = []
            for t in sorted(per_node):
                fps = per_node[t]
                self.stats.read_batches += 1
                try:
                    reply = self.transport.send(
                        src, t, ChunkReadBatch(tuple(fps)), self.now
                    )
                except (MessageDropped, NodeDown) as e:
                    # The whole unicast failed: every fp it carried walks
                    # on to its next replica in the follow-up wave.
                    last = e
                    misses.extend(fps)
                    continue
                for fp, data in zip(fps, reply.chunks):
                    if data is None:
                        last = ChunkMissing(t, fp)
                        misses.append(fp)
                    else:
                        fetched[fp] = data
                        served_by[fp] = t
                        if session is not None:
                            session.presence_note(fp)
            pending = misses

        # -- assemble + verify per object, in request order ---------------
        out: list[bytes] = []
        for name, entry in zip(names, entries):
            data = b"".join(fetched[fp] for fp in entry.chunk_fps)
            if object_fp(entry.chunk_fps) != entry.object_fp:
                raise ReadError(f"object {name!r}: layout fingerprint mismatch")
            self.stats.reads_ok += 1
            if frag_out is not None and entry.chunk_fps:
                per_node_counts: dict[str, int] = {}
                for fp in entry.chunk_fps:
                    t = served_by[fp]
                    per_node_counts[t] = per_node_counts.get(t, 0) + 1
                frag_out.append({
                    "name": name,
                    "chunks": len(entry.chunk_fps),
                    "nodes": len(per_node_counts),
                    "max_chunks_one_node": max(per_node_counts.values()),
                })
            out.append(data)
        return out

    def _read_object_serial(self, name: str) -> bytes:
        """The pre-batching read shape (one OMAP probe, then one serial
        ``ChunkRead`` per chunk with per-chunk replica walking) — kept as
        the oracle the batched engine is proven byte-identical to."""
        entry = self._omap_lookup(name, src="client")
        if entry is None:
            raise ReadError(f"object {name!r} not found")
        parts: list[bytes] = []
        for fp in entry.chunk_fps:
            parts.append(self._read_chunk(fp))
        data = b"".join(parts)
        if object_fp(entry.chunk_fps) != entry.object_fp:
            raise ReadError(f"object {name!r}: layout fingerprint mismatch")
        self.stats.reads_ok += 1
        return data

    def _omap_lookup(
        self, name: str, src: str = "client", strict: bool = False
    ) -> OMAPEntry | None:
        """Probe the live OMAP replicas for ``name``. With ``strict=True``
        (the write path's idempotence/replace check) a lost probe with no
        surviving answer raises instead of reporting 'absent' — assuming
        absence could skip releasing a replaced version's refs, leaking
        refcounts that GC can never reclaim."""
        lost = False
        for t in self._live(self.omap_targets(name)):
            try:
                e = self.transport.send(src, t, OmapGet(name), self.now)
            except (MessageDropped, NodeDown):
                lost = True
                continue
            if e is not None:
                # A tombstone answers the probe (the name is known-deleted,
                # no further replica need be asked) but reads as absence.
                return None if e.deleted else e
        if strict and lost:
            raise WriteError(f"OMAP lookup for {name!r} lost in transit")
        return None

    def _read_chunk(self, fp: Fingerprint) -> bytes:
        last: Exception | None = None
        for t in self._live(self.chunk_targets(fp)):
            try:
                return self.transport.send("client", t, ChunkRead(fp), self.now)
            except (ChunkMissing, MessageDropped, NodeDown) as e:
                last = e
        raise ReadError(f"chunk {fp} unreadable on all replicas: {last}")

    # ---------------------------------------------------------------- delete
    def delete_object(self, name: str, _src: str = "client") -> bool:
        """Tombstone-first delete, mirroring the write path's replace
        hardening: the versioned tombstone is committed to the OMAP
        replicas FIRST (>=1 ack, like ``_commit_omap``) and the recipe's
        chunk refs are released strictly AFTER. A mid-delete failure
        therefore leaves the name either fully readable (the commit never
        landed; a maybe-applied tombstone is conditionally undeleted
        receiver-side) or fully tombstoned with at worst leaked refcounts
        that the cluster-wide audit reclaims — never a readable recipe
        whose refs were half-released. Primary-routed like the write path,
        so a node<->node partition severs tombstone replication exactly as
        it severs commit replication; recovery then converges the
        survivors by commit version."""
        omap_nodes = self._live(self.omap_targets(name))
        if not omap_nodes:
            raise WriteError(f"no live OMAP target for {name!r}")
        primary = omap_nodes[0]
        entry = self._omap_lookup(name, src=primary)
        if entry is None:
            return False
        self._txn_counter += 1
        txn = self._txn_counter
        self._fault("before_tombstone", name=name, txn=txn)
        committed = False
        displaced: OMAPEntry | None = None
        unconfirmed: list[tuple[str, MessageDropped]] = []
        for t in omap_nodes:
            try:
                resp = self.transport.send(
                    primary, t, OmapDelete(name, txn), self.now
                )
                if displaced is None and isinstance(resp, OMAPEntry):
                    displaced = resp
                committed = True
            except MessageDropped as e:
                unconfirmed.append((t, e))
            except NodeDown:
                pass
        if not committed:
            for t, e in unconfirmed:
                self._cancel_unconfirmed(
                    primary, t, e, omap_name=name, undelete_version=txn
                )
            raise WriteError(f"delete {name!r}: no OMAP replica acked the tombstone")
        self._fault("before_delete_decref", name=name, txn=txn)
        # Release the refs of the entry the tombstone ACTUALLY displaced
        # (response-carried by the first applying replica, like the write
        # path's replace). The plan-time ``entry`` is stale the moment a
        # concurrent session replaces or deletes the name between our
        # lookup and our tombstone: a raced second delete sees prev =
        # tombstone (refs already released — release nothing), a delete
        # raced by a newer WRITE sees prev = that newer version only if
        # our tombstone out-versioned it (then its refs are exactly the
        # ones to drop). Either way: exactly-once.
        if displaced is not None and not displaced.deleted:
            self._release_entry_refs(displaced, src=primary)
            # The recipe's refs are released: cached "exists" evidence for
            # its chunks may go stale as soon as GC reclaims them —
            # invalidate now.
            self._invalidate_presence(
                primary, tuple(displaced.chunk_fps), "delete"
            )
        return True

    def _release_entry_refs(self, entry: OMAPEntry, src: str) -> None:
        """Release an entry's chunk refs, one DecrefBatch per node. The
        write path's replace passes the entry from its strict lookup here
        directly — re-probing could lose the probe under a lossy policy
        and leak the old version's refcounts forever."""
        per_node: dict[str, list[Fingerprint]] = {}
        for fp in entry.chunk_fps:
            for t in self._live(self.chunk_targets(fp)):
                per_node.setdefault(t, []).append(fp)
        for t, fps in per_node.items():
            try:
                self.transport.send(src, t, DecrefBatch(tuple(fps)), self.now)
            except (MessageDropped, NodeDown):
                pass

    # ------------------------------------------------------------- rebalance
    def set_map(self, new_map: ClusterMap) -> None:
        """Topology change + storage rebalance (paper Fig 1b).

        Content placement means we only *move* chunks; no dedup-metadata
        location rewrite happens anywhere (the paper's key win). The move
        itself is the recovery subsystem's per-node rebalance driver
        (``core/recovery.py``): CIT entries travel with their chunks
        (MigrateChunk); OMAP entries move by name hash (OmapPut with
        migrate=True). Under a lossy delivery policy a move can be lost in
        flight — replicas and the digest repair round (``scrub``) are the
        repair story, exactly as for node loss.
        """
        from repro_torch.core.recovery import rebalance

        for nid in new_map.nodes:
            if nid not in self.nodes:
                self.nodes[nid] = StorageNode(nid)
        self.cmap = new_map
        for n in self.nodes.values():
            n.set_cmap(new_map, self.now)
        if self._sessions:
            self._wire_gc_hooks()  # nodes added by the new map
        rebalance(self)

    def add_node(self, weight: float = 1.0) -> str:
        nid = f"oss{len(self.nodes)}"
        self.set_map(self.cmap.with_node(nid, weight))
        return nid

    def remove_node(self, nid: str) -> None:
        self.set_map(self.cmap.without_node(nid))

    # -------------------------------------------------------------- recovery
    def scrub(self) -> int:
        """Re-replication repair, digest-driven (``core/recovery.py``):
        nodes exchange per-placement-group digests over the transport, only
        divergent groups are expanded, and every missing byte copy / CIT
        entry ships as a ``RepairChunk`` from a surviving holder. Returns
        byte copies restored."""
        from repro_torch.core.recovery import repair_round

        return repair_round(self)

    def recover(self):
        """Full post-failure reconciliation round: OMAP repair ->
        digest-diff chunk repair -> cluster-wide refcount audit -> GC
        (``core/recovery.py``). This is the post-partition heal path, and
        what reclaims references leaked when a ``TxnCancel`` was itself
        lost after an applied-but-unacked op. Returns a
        ``RecoveryReport``."""
        from repro_torch.core.recovery import run_recovery

        return run_recovery(self)

    # --------------------------------------------------------------- metrics
    def unique_bytes_stored(self) -> int:
        seen: set[Fingerprint] = set()
        total = 0
        for node in self.nodes.values():
            for fp, data in node.chunk_store.items():
                if fp not in seen:
                    seen.add(fp)
                    total += len(data)
        return total

    def physical_bytes_stored(self) -> int:
        return sum(n.stored_bytes() for n in self.nodes.values())

    def space_savings(self) -> float:
        logical = self.stats.logical_bytes_written
        if logical == 0:
            return 0.0
        return 1.0 - self.unique_bytes_stored() / logical

    def dedup_ratio(self) -> float:
        u = self.unique_bytes_stored()
        return self.stats.logical_bytes_written / u if u else 0.0

    def chunk_distribution(self) -> dict[str, int]:
        return {nid: len(n.chunk_store) for nid, n in self.nodes.items()}

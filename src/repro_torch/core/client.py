"""DedupClient — the public client session over a DedupCluster.

The session facade is the single write/read surface
(``put``/``put_many``/``get``/``get_many``/``delete``/``flush``/
``close``); the
legacy ``DedupCluster.write_object``/``write_objects`` entry points are
thin shims over a cache-disabled default session. A session owns the two
bounded caches from ``core/write_cache.py``:

* the **write-back buffer**: ``put`` accepts objects without writing
  them (returning immediately, s3ql-style); the dirty set drains on
  ``flush``/``close``/``get``/``delete``/``put_many`` or automatically
  once the buffered bytes reach ``wave_bytes``;
* the **streaming ingest planner**: ``put_many`` chunks + fingerprints
  in bounded waves (O(wave) host memory) instead of materializing the
  whole batch, handing each wave to the cluster's coalesced
  ``_write_wave`` engine — wave k is on the wire while wave k+1 chunks;
* the **presence cache** (``presence_cache`` > 0): a bounded LRU
  fingerprint set taught by acked write outcomes and by batched read
  hits (restored chunk bytes are the same positive existence evidence
  an acked write outcome is). Hits turn repeat
  chunks into presence-asserted ref-only ops — no bytes travel and no
  CIT probe is booked. A presence-enabled session registers itself on
  the transport (``extra_handlers``) under its session id and receives
  ``PresenceInvalidate`` fan-outs on delete / GC reclaim / tombstone
  reap; the handler is idempotent, so chaos redelivery is harmless, and
  a LOST invalidation only costs a fallback byte resend (see
  docs/write_cache.md for the safety argument).

Message-shape parity: a session with both caches disabled (the default,
and what the shims use) produces byte-for-byte the legacy message
sequence — same ChunkOpBatches, same lookups, same net_bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch import obs
from repro_torch.core.fingerprint import Fingerprint
from repro_torch.core.messages import PresenceInvalidate
from repro_torch.core.write_cache import PendingWrites, PresenceCache, WriteBackCache


@dataclass
class DedupClient:
    """One client session. ``presence_cache`` is the presence-LRU capacity
    in fingerprints (0 = disabled); ``wave_bytes`` bounds both the
    streaming ingest wave and the write-back buffer's auto-flush
    threshold (0 = unbounded, the legacy one-wave shape)."""

    cluster: object
    presence_cache: int = 0
    wave_bytes: int = 0
    # Transport endpoint name for everything this session sends. The
    # default keeps every legacy edge key ("client" -> node) byte-identical;
    # concurrent workload sessions open with distinct names (c0, c1, ...)
    # so per-edge stats attribute contention per client.
    src: str = "client"
    session_id: str | None = None
    closed: bool = False
    presence: PresenceCache | None = field(default=None, repr=False)
    wcache: WriteBackCache | None = field(default=None, repr=False)
    pending: PendingWrites | None = field(default=None, repr=False)
    invalidations_received: int = 0
    # Scheduled-session state: nonzero while a wave this session sent is
    # un-committed (in flight). The Scheduler's event log reads it to
    # record which sessions were concurrently in flight at each step.
    in_flight: int = 0

    def __post_init__(self) -> None:
        c = self.cluster
        self.wcache = WriteBackCache(
            c.chunking, wave_bytes=self.wave_bytes, sink=c.stats
        )
        self.pending = PendingWrites(
            flush_threshold=self.wave_bytes, on_flush=self._put_pipeline
        )
        if self.presence_cache > 0:
            self.presence = PresenceCache(self.presence_cache, sink=c.stats)
            c._register_session(self)

    # ------------------------------------------------------------- transport
    def handle(self, msg, now: int, env=None) -> str:
        """Transport delivery into the session: only ``PresenceInvalidate``
        is addressed to clients. Idempotent by construction (dropping a
        fingerprint twice is a no-op), so duplicated/reordered/late copies
        need no seen-window."""
        if isinstance(msg, PresenceInvalidate):
            self.invalidations_received += 1
            if self.presence is not None:
                self.presence.invalidate_many(msg.fps)
            return "ok"
        raise TypeError(f"client session cannot handle {type(msg).__name__}")

    # ----------------------------------------------------- presence plumbing
    # The hooks ``DedupCluster._write_wave`` calls; all three are no-ops on
    # a cache-disabled session, preserving legacy behavior exactly.
    def presence_hit(self, fp: Fingerprint) -> bool:
        return self.presence is not None and self.presence.hit(fp)

    def presence_note(self, fp: Fingerprint) -> None:
        if self.presence is not None:
            self.presence.note(fp)

    def presence_drop(self, fp: Fingerprint) -> None:
        if self.presence is not None:
            self.presence.drop(fp)

    # ------------------------------------------------------------ public API
    def put(self, name: str, data: bytes) -> None:
        """Write-back accept: buffer the object and return. The write
        happens at the next ``flush``/``close``/``put_many`` (or any read/
        delete through this session), or automatically once the buffer
        reaches ``wave_bytes``. Fingerprints surface from ``flush``."""
        self._check_open()
        self.pending.add(name, data)

    def put_many(self, items: list[tuple[str, bytes]]) -> list[Fingerprint]:
        """Synchronous batched write in bounded streaming waves; returns
        one object fingerprint per item, in order. Any buffered ``put``s
        flush first so the session's writes apply in submission order."""
        self._check_open()
        self._drain_pending()
        return self._put_pipeline(items)

    def get(self, name: str) -> bytes:
        self._check_open()
        self._drain_pending()  # read-your-writes
        return self.cluster.read_objects([name], session=self)[0]

    def get_many(self, names: list[str]) -> list[bytes]:
        """Coalesced batch restore: plan every object at once and fetch
        each node's chunks in one ``ChunkReadBatch`` unicast, with
        cross-object duplicate-fetch elision — see
        ``DedupCluster.read_objects``. Returns the objects' bytes in
        request order. Acked hits teach this session's presence cache
        (restored bytes are existence evidence, same as an acked write),
        so a restore primes subsequent ``put``s for probe elision."""
        self._check_open()
        self._drain_pending()  # read-your-writes
        return self.cluster.read_objects(list(names), session=self)

    def delete(self, name: str) -> bool:
        self._check_open()
        self._drain_pending()
        return self.cluster.delete_object(name)

    def flush(self) -> dict[str, Fingerprint]:
        """Drain the write-back buffer; returns name -> object fingerprint
        for the objects this flush wrote (last-buffered wins per name)."""
        self._check_open()
        items = self.pending.drain()
        fps = self._put_pipeline(items)
        return dict(zip((name for name, _ in items), fps))

    def close(self) -> None:
        """Flush buffered writes and unregister from the cluster. The
        session's cache counters remain folded into ``cluster.stats``."""
        if self.closed:
            return
        self._drain_pending()
        if self.presence is not None:
            self.cluster._unregister_session(self)
        self.closed = True

    # -------------------------------------------------------------- internals
    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("DedupClient session is closed")

    def _drain_pending(self) -> None:
        if len(self.pending):
            self._put_pipeline(self.pending.drain())

    def _put_pipeline(self, items: list[tuple[str, bytes]]) -> list[Fingerprint]:
        """The batched write pipeline (moved here from the legacy
        ``DedupCluster.write_objects``). Semantically identical to looping
        ``write_object`` over ``items`` — same fingerprints, refcounts,
        OMAP state, rollback behavior and fault event points; on failure
        the exception propagates after earlier items committed, exactly
        like the loop — but vectorized and coalesced where the loop is
        serial:

        1. chunking (vectorized CDC) + fingerprinting run per bounded WAVE
           (one ``fingerprint_many`` pass per wave), so peak host memory
           is O(wave), not O(batch);
        2. chunk ops for a whole wave are grouped per target node into one
           ``ChunkOpBatch`` unicast each (cross-object coalescing), so
           control messages scale with nodes touched, not objects x nodes;
        3. a wave-local fp->first-writer cache turns chunks repeated
           *across* objects into ref-only ops, and the session's presence
           cache (when enabled) does the same across waves and batches —
           duplicate bytes never hit the wire.

        ``lookup_unicasts`` counts fingerprint lookups carried
        (batch-invariant, minus presence elisions); ``control_msgs``
        counts messages, which coalescing reduces; ``net_bytes`` can only
        shrink — for batches that commit; a mid-batch failure has already
        shipped the tail's bytes, which transport counters do not
        un-count.

        Transport-policy caveat: the coalesced ChunkOpBatch is emitted by
        the client-side ingest layer (src="client", like the read path),
        so node<->node ``partition`` policies do not sever it even though
        they would sever the serial loop's primary-routed unicasts. To
        evaluate partitions against the paper's primary-routed write
        path, set ``coalesce_batches=False`` on the cluster.
        """
        c = self.cluster
        if not items:
            return []
        nbytes = sum(len(data) for _, data in items)
        with obs.span("cluster.put_many", objects=len(items), bytes=nbytes):
            batched = (
                c.batch_unicasts
                if c.batch_unicasts is not None
                else c.fault_injector is None
            )
            # A presence-enabled session routes even single objects through the
            # wave engine so every write teaches (and can consult) the cache;
            # cache-disabled sessions keep the legacy single-object branch.
            coalesce = len(items) > 1 or self.presence is not None
            if not (batched and c.coalesce_batches and coalesce):
                # Per-object path (fault injector listening / batching off /
                # single object): chunk lazily per object — peak dirty bytes
                # stay O(object) — and keep every per-chunk event window.
                out: list[Fingerprint] = []
                for name, data in items:
                    _, _, chunks, fps = self.wcache.prepare(name, data)
                    try:
                        out.append(c._write_prepared(name, data, chunks, fps, batched))
                    finally:
                        self.wcache.release()
                return out

            # Coalesced path: bounded waves (split at wave_bytes and at name
            # repeats — every prev-object check in a wave must see committed
            # OMAP state, so a batch that rewrites a name it wrote earlier in
            # the same batch splits at the repeat).
            out = []
            for wave in self.wcache.waves(items):
                out.extend(c._write_wave(wave, session=self))
            return out

    # ------------------------------------------------------- scheduled session
    def put_wave_actor(
        self, items: list[tuple[str, bytes]], commit_sink: list | None = None
    ):
        """Resumable ``put_many``: a generator actor for the discrete-event
        ``Scheduler`` (core/simclock.py). Yields an integer tick delay
        after each wave's SEND, deferring its COMMIT until the actor is
        resumed — the window in which other sessions' actors run, so N
        sessions genuinely interleave waves on one cluster.

        Pipelining: on resume, the ``waves`` generator chunks +
        fingerprints wave k+1 FIRST (while wave k is still un-committed —
        counted in ``stats.waves_overlapped``, the PR 8 caveat closed),
        then wave k commits, then wave k+1 plans. The commit-before-plan
        order is load-bearing — a wave split at a repeated name relies on
        the previous wave's commit being visible to its plan-time lookup —
        and because chunking emits no messages, the wire sequence is
        IDENTICAL to the synchronous ``put_many`` for a single session
        (the parity pin in tests/test_workload.py). Dirty-byte accounting
        note: ``peak_dirty_bytes`` books one wave at a time even though
        overlap keeps wave k's chunks resident while k+1 chunks — the
        true pipelined peak is one send-window plus one chunking wave.

        Returns ``(fps, committed)`` via ``StopIteration.value``: the
        object fingerprints in item order, and the ``(name, version)``
        commit records the concurrent-session oracle replays.
        ``commit_sink``, when given a list, receives the same records
        incrementally as each wave commits — they survive a mid-batch
        ``WriteError`` (which a generator's return value does not), so a
        chaos-faulted run still knows exactly which objects committed
        before the failure."""
        self._check_open()
        c = self.cluster
        out: list[Fingerprint] = []
        committed = commit_sink if commit_sink is not None else []
        pending_state: dict | None = None
        try:
            for wave in self.wcache.waves(items):
                if pending_state is not None:
                    # waves() just chunked this wave while the previous one
                    # was still in flight: overlap occurred.
                    c.stats.waves_overlapped += 1
                    try:
                        out.extend(c._wave_commit(pending_state, session=self))
                    finally:
                        committed.extend(pending_state["committed"])
                        pending_state = None
                        self.in_flight = 0
                state = c._wave_plan(wave, session=self)
                c._wave_send(state, session=self)
                pending_state = state
                self.in_flight = 1
                yield 1
            if pending_state is not None:
                try:
                    out.extend(c._wave_commit(pending_state, session=self))
                finally:
                    committed.extend(pending_state["committed"])
                    pending_state = None
                    self.in_flight = 0
        finally:
            if pending_state is not None:
                # Abandoned mid-flight (generator closed, or an error before
                # the commit): drop the audit registration so the refcount
                # audit can eventually reconcile the orphaned refs.
                c.release_inflight_wave(pending_state["batch_txn"])
                self.in_flight = 0
        return out, committed

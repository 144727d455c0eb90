"""StorageNode — one shared-nothing object storage server (OSD/OSS).

Persistent across crash/restart: the chunk store (disk) and the DM-Shard
(stored like a normal replicated object, per paper §2.2).
Volatile (lost on crash): the consistency manager's pending flag flips —
losing them is precisely the failure mode the tagged-consistency design
tolerates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dmshard import DMShard, INVALID, VALID, CITEntry, OMAPEntry
from repro_torch.core.fingerprint import Fingerprint, name_fp, sha256_fp
from repro_torch.core.gc import GarbageCollector
from repro_torch.core.messages import (
    ChunkOp,
    ChunkOpBatch,
    ChunkRead,
    ChunkReadBatch,
    ChunkReadBatchReply,
    DecrefBatch,
    DigestReply,
    DigestRequest,
    Message,
    MigrateChunk,
    OmapDelete,
    OmapGet,
    OmapPut,
    RawPut,
    RefAudit,
    RefOnlyWrite,
    RepairChunk,
    TombstoneReap,
    TxnCancel,
)
from repro_torch.core.transport import BoundedIdSet, Envelope, SeenWindow


# Sink for ref-only ops, which never register async flips (they either ride
# an existing valid entry or repair one whose bytes are already present).
_NO_REGISTER: list = []


@dataclass
class DirtyTracker:
    """Per-placement-group dirty epochs — the cheap metadata that makes
    recovery incremental. Every mutating message bumps the dirty epoch of
    the placement group it touched (group key = the placement tuple under
    the node's cluster-map share, computed at mutation time); an
    incremental digest probe (``DigestRequest.since_epoch``) then
    re-digests only groups dirty at or after the probe's floor. A
    cluster-map change invalidates every key (groups are placement tuples
    OF a map), so ``rekey`` marks the whole node dirty at the remap epoch
    — rebalance traffic is never silently skipped. Memory is O(groups
    touched since the map epoch), not O(entries).

    Durability: marks ride the shard, not RAM — every mark corresponds to
    a durable shard/chunk-store mutation, so a crash loses neither (the
    divergence a crash CREATES is what it missed while down, and that
    dirt lives on the peers' trackers; the two-phase incremental summary
    collection probes the rejoined member for peer-reported groups)."""

    groups: dict = field(default_factory=dict)   # placement tuple -> last dirty epoch
    all_dirty_at: int = 0                        # node birth / map change: everything dirty

    def rekey(self, now: int) -> None:
        self.groups.clear()
        self.all_dirty_at = max(self.all_dirty_at, now)

    def mark(self, group: tuple, now: int) -> None:
        if now > self.groups.get(group, -1):
            self.groups[group] = now

    def dirty_since(self, since: int) -> "set | None":
        """The groups to re-digest for a probe with floor ``since``; None
        means 'everything' (the map changed, or the node is younger than
        the floor covers)."""
        if since <= self.all_dirty_at:
            return None
        return {g for g, e in self.groups.items() if e >= since}


@dataclass
class NodeStats:
    disk_bytes_written: int = 0
    disk_bytes_read: int = 0
    chunk_writes: int = 0
    dedup_hits: int = 0
    cit_lookups: int = 0
    consistency_checks: int = 0
    repairs: int = 0
    dup_msgs_suppressed: int = 0   # duplicate deliveries answered from the window
    poisoned_discards: int = 0     # late copies of cancelled messages discarded
    out_of_order: int = 0          # arrivals with a seq below the edge high-water
    cancels_applied: int = 0       # TxnCancel compensations that found the op applied
    seen_evictions: int = 0        # ids the bounded seen-window pushed out (pressure)
    seen_high_water: int = 0       # peak seen-window occupancy
    digests_served: int = 0        # recovery digest requests answered
    repairs_adopted: int = 0       # RepairChunk deliveries that stored bytes or a CIT entry
    audit_increfs: int = 0         # references an audit correction restored
    audit_decrefs: int = 0         # references an audit-tagged DecrefBatch released
    decrefs_unbacked: int = 0      # releases of a ref this replica never kept
                                   # (missed incref / cancelled ack-lost op)
    audit_flag_flips: int = 0      # stuck-INVALID flags an audit correction repaired
    tombstones_written: int = 0    # delete tombstone records committed/adopted
    tombstones_reaped: int = 0     # aged tombstones removed by TombstoneReap
    stale_puts_refused: int = 0    # version-gated OmapPut/OmapDelete rejections
    groups_digested: int = 0       # placement-group summaries this node computed
    groups_skipped: int = 0        # clean groups an incremental probe skipped


@dataclass
class StorageNode:
    node_id: str
    alive: bool = True
    chunk_store: dict[Fingerprint, bytes] = field(default_factory=dict)   # "disk"
    shard: DMShard = field(default_factory=DMShard)
    cm: ConsistencyManager = field(default_factory=ConsistencyManager)
    gc: GarbageCollector = field(default_factory=GarbageCollector)
    stats: NodeStats = field(default_factory=NodeStats)
    # At-least-once receive state. ``seen`` (message id -> first response)
    # makes every retransmitted/duplicated delivery a state-free re-ack;
    # ``_poisoned`` holds cancelled ids whose copy may still be in flight.
    # Both persist across crash like the DM-Shard: delivery dedup metadata
    # is journaled with the ops it guards (losing it would re-open the
    # double-apply window for every pre-crash unicast).
    seen: SeenWindow = field(default_factory=SeenWindow)
    _poisoned: BoundedIdSet = field(default_factory=BoundedIdSet)
    _edge_seq_seen: dict[str, int] = field(default_factory=dict)
    # Cluster-map share (like an OSDMap epoch share) + per-placement-group
    # dirty epochs. The map share only feeds dirty-group KEYING — message
    # routing stays the sender's job; a node with no share (standalone unit
    # tests, baselines) just serves every digest probe in full.
    cmap: object = None
    dirty: DirtyTracker = field(default_factory=DirtyTracker)
    # Bounded clock skew (ROADMAP item 4). ``clock_offset`` is this node's
    # local-clock error relative to event time: everything that would read a
    # WALL clock in a real deployment — tombstone ``deleted_at`` stamping and
    # tombstone aging — goes through ``local_now``. Message delivery order and
    # version authority never consult it (versions are the cluster-monotonic
    # txn counter, not timestamps). ``skew_guard`` is the deployment's skew
    # BOUND: reap candidacy requires age past ``horizon + skew_guard``, so a
    # clock up to that much fast cannot age a tombstone out before every
    # correctly-clocked replica would agree it is reapable.
    clock_offset: int = 0
    skew_guard: int = 0

    def local_now(self, now: int) -> int:
        """This node's skewed local-clock reading at event time ``now``."""
        return now + self.clock_offset

    def set_cmap(self, cmap, now: int) -> None:
        """Adopt a cluster-map share; a CHANGED map re-keys every placement
        group, so the dirty tracker marks the whole node dirty at the remap
        epoch (rebalance traffic is incremental-repair traffic)."""
        if cmap != self.cmap:
            self.cmap = cmap
            self.dirty.rekey(now)

    def _mark_chunk_dirty(self, fp: Fingerprint, now: int) -> None:
        if self.cmap is not None:
            from repro_torch.core.placement import place

            self.dirty.mark(tuple(place(fp, self.cmap)), now)

    def _mark_name_dirty(self, name: str, now: int) -> None:
        if self.cmap is not None:
            from repro_torch.core.placement import place

            self.dirty.mark(tuple(place(name_fp(name), self.cmap)), now)

    # ------------------------------------------------------------------ life
    def crash(self) -> None:
        """Power-fail: drop volatile state. Disk + DM-Shard survive."""
        self.alive = False
        self.cm.crash()

    def restart(self) -> None:
        self.alive = True

    def _require_alive(self) -> None:
        if not self.alive:
            raise NodeDown(self.node_id)

    # ----------------------------------------------------------- message I/O
    def handle(self, msg: Message, now: int, env: Envelope | None = None):
        """Single entry point for every wire message (see messages.py).
        The transport delivers here; ``now`` is the receive timestamp (a
        delayed message arrives with a later one).

        At-least-once guard: when the delivery carries an ``Envelope``, its
        message id is checked against the bounded seen-window FIRST — a
        retransmitted or duplicated copy returns the cached response of the
        first application without touching any state (CIT refcounts, OMAP,
        chunk store, pending flips). Copies of a cancelled (poisoned) id
        are discarded. This is what makes every mutating message type
        (ChunkOpBatch / RefOnlyWrite / DecrefBatch / OmapPut / OmapDelete /
        MigrateChunk / TxnCancel) exactly-once at the state layer over an
        at-least-once wire."""
        self._require_alive()
        # Reads mutate nothing a duplicate could corrupt (repair-on-read is
        # idempotent), so they stay OUT of the seen-window: recording them
        # would let read traffic evict mutating message ids and silently
        # re-open the double-apply window the bound is sized for. Digest
        # probes are reads too — a duplicated DigestRequest just recomputes
        # the same summary. RepairChunk / RefAudit / audit DecrefBatch are
        # mutating and ride the window like every other recovery-era write.
        mutating = not isinstance(
            msg, (ChunkRead, ChunkReadBatch, OmapGet, DigestRequest)
        )
        if env is not None:
            if env.msg_id in self._poisoned:
                # A late copy of a message the sender already cancelled:
                # applying it would resurrect a rolled-back transaction.
                self.stats.poisoned_discards += 1
                return None
            last = self._edge_seq_seen.get(env.src, -1)
            if env.seq < last:
                self.stats.out_of_order += 1
            else:
                self._edge_seq_seen[env.src] = env.seq
            if mutating:
                cached = self.seen.get(env.msg_id)
                if cached is not self.seen.ABSENT:
                    self.stats.dup_msgs_suppressed += 1
                    return cached
        response = self._dispatch(msg, now, env.msg_id if env is not None else None)
        if env is not None and mutating:
            self.stats.seen_evictions += self.seen.record(env.msg_id, response)
            self.stats.seen_high_water = max(
                self.stats.seen_high_water, self.seen.high_water
            )
        return response

    def _dispatch(self, msg: Message, now: int, msg_id: int | None = None):
        if isinstance(msg, ChunkOpBatch):
            return self._handle_chunk_ops(msg.ops, now, msg.txn, msg_id)
        if isinstance(msg, OmapGet):
            return self.shard.omap_get(msg.name)
        if isinstance(msg, OmapPut):
            e = msg.entry
            applied, prev = self.shard.omap_apply(
                OMAPEntry(
                    e.name, e.object_fp, list(e.chunk_fps), e.size, e.version,
                    e.deleted, e.deleted_at,
                )
            )
            if applied:
                self._mark_name_dirty(e.name, now)
                if e.deleted:
                    self.stats.tombstones_written += 1
            else:
                # Version gate: a delayed commit (or a repair racing a
                # newer write) may not clobber a newer record or tombstone.
                self.stats.stale_puts_refused += 1
            # The replaced record rides the response so the committer can
            # release the exact version it displaced (entry or tombstone) —
            # the only race-safe source under concurrent replacers.
            return applied, prev
        if isinstance(msg, OmapDelete):
            applied, prev = self.shard.omap_tombstone(
                msg.name, msg.version, self.local_now(now)
            )
            if applied:
                self.stats.tombstones_written += 1
                self._mark_name_dirty(msg.name, now)
            else:
                self.stats.stale_puts_refused += 1
            return prev
        if isinstance(msg, TombstoneReap):
            reaped = self.shard.omap_reap(msg.name, msg.version)
            if reaped is not None:
                self.stats.tombstones_reaped += 1
                self._mark_name_dirty(msg.name, now)
                # The retained fps ride the response: the coordinator fans
                # them out as a last-chance presence invalidation.
                return ("reaped", tuple(reaped.chunk_fps))
            return "noop"
        if isinstance(msg, DecrefBatch):
            self.decref_chunks(list(msg.fps), now, audit=msg.audit)
            return True
        if isinstance(msg, RefOnlyWrite):
            return tuple(self._apply_ref_only(fp, now) for fp in msg.fps)
        if isinstance(msg, ChunkRead):
            return self.read_chunk(msg.fp, now)
        if isinstance(msg, ChunkReadBatch):
            return self._serve_read_batch(msg.fps, now)
        if isinstance(msg, MigrateChunk):
            return self._apply_migrate(msg, now)
        if isinstance(msg, DigestRequest):
            return self._serve_digest(msg, now)
        if isinstance(msg, RepairChunk):
            return self._apply_repair(msg, now)
        if isinstance(msg, RefAudit):
            return self._apply_ref_audit(msg, now)
        if isinstance(msg, TxnCancel):
            return self._apply_cancel(msg, now)
        if isinstance(msg, RawPut):
            # Unconditional store: baselines key RawPut by *name* hash too
            # (NoDedup), where a rewrite must replace the old bytes.
            self._disk_write(msg.fp, msg.data)
            return True
        raise TypeError(f"unhandled message type {type(msg).__name__}")

    # ------------------------------------------------------------- chunk I/O
    def receive_chunk(self, fp: Fingerprint, data: bytes, now: int, txn_id: int) -> str:
        """Fingerprint-routed chunk write (paper fig 2, OSS 4). Returns one of
        'dedup_hit' | 'repaired' | 'restored' | 'stored'."""
        self._require_alive()
        return self._handle_chunk_ops((ChunkOp(fp, data),), now, txn_id)[0]

    def receive_chunks(
        self, ops: list[tuple[Fingerprint, bytes]], now: int, txn_id: int
    ) -> list[str]:
        """Batched fingerprint-routed write: one unicast carrying many chunk
        ops (legacy tuple API; the wire form is a ``ChunkOpBatch``)."""
        self._require_alive()
        return self._handle_chunk_ops(
            tuple(ChunkOp(fp, data) for fp, data in ops), now, txn_id
        )

    def _handle_chunk_ops(
        self,
        ops: tuple[ChunkOp, ...],
        now: int,
        txn_id: int,
        msg_id: int | None = None,
    ) -> list[str]:
        """Apply one unicast's chunk ops in order. The CIT lookups are
        batched, and all async flag-flip registrations from the batch go to
        the consistency manager in one ``register_many`` call. Per-op state
        transitions are exactly those of ``receive_chunk`` applied in order
        (a duplicate fingerprint later in the batch sees the entry its
        earlier twin created)."""
        entries = self.shard.cit_lookup_many([op.fp for op in ops])
        out: list[str] = []
        register: list[Fingerprint] = []
        seen: set[Fingerprint] = set()
        for op, entry in zip(ops, entries):
            if op.fp in seen:
                entry = self.shard.cit_lookup(op.fp)
            seen.add(op.fp)
            if op.data is None:
                out.append(self._apply_ref_only(op.fp, now, entry))
            else:
                out.append(self._apply_receive(op.fp, op.data, entry, now, register))
        if register:
            self.cm.register_many(register, now, txn_id, msg_id)
        return out

    def _apply_receive(
        self,
        fp: Fingerprint,
        data: bytes | None,
        entry: CITEntry | None,
        now: int,
        register: list[Fingerprint],
    ) -> str:
        """One chunk op's state transition. ``data is None`` is a ref-only
        op: where a payload op would store bytes, it returns 'miss' instead
        (entry absent, or invalid with no local bytes to back a repair) and
        the sender falls back to shipping the chunk."""
        self.stats.cit_lookups += 1

        if entry is not None and entry.is_valid():
            # Duplicate write, valid flag: refcount increment granted.
            self.shard.cit_addref(fp, now=now)
            self._mark_chunk_dirty(fp, now)
            self.stats.dedup_hits += 1
            return "dedup_hit"

        if entry is not None:  # exists, flag INVALID -> consistency check
            self.stats.consistency_checks += 1
            if fp in self.chunk_store:  # stat() says bytes are present
                self.shard.cit_set_flag(fp, VALID, now)
                self.shard.cit_addref(fp, now=now)
                self._mark_chunk_dirty(fp, now)
                self.stats.repairs += 1
                return "repaired"
            if data is None:
                return "miss"
            # Bytes missing: store content first, then flip (async).
            self._disk_write(fp, data)
            self.shard.cit_addref(fp, now=now)
            register.append(fp)
            self._mark_chunk_dirty(fp, now)
            self.stats.repairs += 1
            return "restored"

        if data is None:
            return "miss"
        # Unique chunk: store with INVALID flag; flip is async (paper §2.4).
        self.shard.cit_insert(fp, len(data), now)
        self._disk_write(fp, data)
        self.shard.cit_addref(fp, now=now)
        register.append(fp)
        self._mark_chunk_dirty(fp, now)
        return "stored"

    def _apply_ref_only(
        self, fp: Fingerprint, now: int, entry: CITEntry | None = None
    ) -> str:
        if entry is None:
            entry = self.shard.cit_lookup(fp)
        return self._apply_receive(fp, None, entry, now, _NO_REGISTER)

    def _apply_cancel(self, msg: TxnCancel, now: int) -> str:
        """Resolve the sender's "ack lost, op applied?" ambiguity locally.

        If the referenced message id is in the seen-window, its op DID
        apply here: compensate — release exactly the refs its cached
        outcomes granted (a 'miss' took none) and drop the OMAP entry a
        cancelled commit wrote. If it is absent, the op never applied (or
        its copy is still in flight): poison the id so a late arrival is
        discarded instead of resurrecting the cancelled transaction.
        TxnCancel itself rides the same seen-window, so a retransmitted
        cancel never double-compensates.

        ``undelete`` compensates a cancelled DELETE: the tombstone is
        voided only if it is still in place at exactly the cancelled
        transaction's version (``ref_version`` — a newer write or newer
        delete won the race and stands), restoring the pre-delete entry
        the delete's cached response preserved."""
        cached = self.seen.get(msg.ref_msg_id)
        if cached is self.seen.ABSENT:
            self._poisoned.add(msg.ref_msg_id)
            return "noop"
        self.stats.cancels_applied += 1
        if msg.omap_name is not None:
            if msg.undelete:
                cur = self.shard.omap_get(msg.omap_name)
                if (
                    cur is not None and cur.deleted
                    and cur.version == msg.ref_version
                ):
                    if isinstance(cached, OMAPEntry):
                        self.shard.omap_put(cached)
                    else:
                        self.shard.omap_delete(msg.omap_name)
                    self._mark_name_dirty(msg.omap_name, now)
            else:
                # Cancelled commit: the cached (applied, replaced) response
                # says exactly what the put displaced — restore it. A put
                # the version gate refused never landed, so there is
                # nothing to undo; a put over a tombstone restores the
                # tombstone (deleting the name outright would void the
                # delete's resurrection guard).
                applied, prev = (
                    cached if isinstance(cached, tuple) and len(cached) == 2
                    else (True, None)
                )
                if applied:
                    if isinstance(prev, OMAPEntry):
                        self.shard.omap_put(prev)
                    else:
                        self.shard.omap_delete(msg.omap_name)
                    self._mark_name_dirty(msg.omap_name, now)
        outcomes = cached if isinstance(cached, (list, tuple)) else []
        for fp, outcome in zip(msg.fps, outcomes):
            if outcome != "miss":
                self.decref_chunk(fp, now)
        return "cancelled"

    def _apply_migrate(self, msg: MigrateChunk, now: int) -> str:
        """Rebalance/scrub: adopt chunk bytes and the CIT entry traveling
        with them (content placement — metadata needs no location rewrite)."""
        if msg.data is not None and msg.fp not in self.chunk_store:
            self.chunk_store[msg.fp] = msg.data
            self.stats.disk_bytes_written += len(msg.data)
        if msg.cit is not None:
            msg.cit.clone_into(self.shard, msg.fp, now)
        self._mark_chunk_dirty(msg.fp, now)
        return "ok"

    # ------------------------------------------------------------- recovery
    def _serve_digest(self, msg: DigestRequest, now: int) -> DigestReply:
        """Answer a recovery coordinator's digest probe over this node's OWN
        holdings (read-only — a duplicated probe recomputes harmlessly).

        An incremental probe (``since_epoch``) is filtered through the
        dirty tracker: only groups mutated at or after the floor are
        re-digested, clean ones are counted as skipped. The probe's map is
        adopted as this node's cluster-map share first — if it re-keys the
        placement groups, the tracker conservatively reports everything
        dirty. Summary omap probes additionally list this node's aged
        tombstones (the GC-horizon reap candidates)."""
        self.stats.digests_served += 1
        if msg.cmap is not None:
            self.set_cmap(msg.cmap, now)
        if msg.kind == "recipes":
            counts = self.shard.recipe_refs(msg.cmap, msg.live, self.node_id)
            return DigestReply(kind="recipes", groups={}, entries=counts, epoch=now)
        only = None
        if msg.since_epoch is not None and not msg.groups and not msg.detail_all:
            only = self.dirty.dirty_since(msg.since_epoch)
        if msg.kind == "omap":
            summary, entries, skipped = self.shard.omap_digest(
                msg.cmap, msg.groups, msg.detail_all,
                only_groups=only, summary_only=msg.summary_only,
            )
            tombs = None
            if not msg.groups and not msg.detail_all:
                # Aging reads the node's LOCAL clock (the one real thing a
                # deployment has), so the horizon is widened by the skew
                # bound: a clock ``skew_guard`` fast still cannot nominate
                # a tombstone before its true age reaches the horizon.
                tombs = self.shard.aged_tombstones(
                    self.local_now(now), self.gc.tombstone_horizon + self.skew_guard
                )
            self.stats.groups_digested += len(summary)
            self.stats.groups_skipped += skipped
            return DigestReply(
                kind="omap", groups=summary, entries=entries, epoch=now,
                skipped_groups=skipped, tombstones=tombs,
            )
        summary, entries, skipped = self.shard.chunk_digest(
            self.chunk_store, msg.cmap, msg.groups, msg.detail_all,
            only_groups=only, summary_only=msg.summary_only,
        )
        self.stats.groups_digested += len(summary)
        self.stats.groups_skipped += skipped
        return DigestReply(
            kind="chunks", groups=summary, entries=entries, epoch=now,
            skipped_groups=skipped,
        )

    def _apply_repair(self, msg: RepairChunk, now: int) -> tuple[str, str]:
        """Digest-diff repair: adopt-if-missing, precisely reported. The
        response tells the coordinator what actually changed so a repair
        raced by a rebalance (or a duplicated delivery replayed from the
        seen-window) is visibly a no-op instead of a silent double-count."""
        bytes_outcome = "present" if msg.fp in self.chunk_store else ""
        if msg.data is not None and not bytes_outcome:
            self.chunk_store[msg.fp] = msg.data
            self.stats.disk_bytes_written += len(msg.data)
            bytes_outcome = "stored"
        cit_outcome = ""
        if msg.cit is not None:
            cit_outcome = (
                "cit_stored"
                if msg.cit.clone_into(self.shard, msg.fp, now) is not None
                else "cit_present"
            )
        if bytes_outcome == "stored" or cit_outcome == "cit_stored":
            self.stats.repairs_adopted += 1
        return (bytes_outcome, cit_outcome)

    def _apply_ref_audit(self, msg: RefAudit, now: int) -> tuple[str, ...]:
        """Apply upward refcount corrections and flag repairs from the
        cluster-wide audit. Each item carries the reference count the
        cluster's OMAP recipes prove for this fingerprint; raising to it is
        idempotent by construction (and the message rides the seen-window
        regardless). Excess references arrive separately as audit-tagged
        DecrefBatch messages."""
        out: list[str] = []
        for fp, expected in msg.items:
            entry = self.shard.cit_lookup(fp)
            if entry is None:
                out.append("absent")
                continue
            action = "ok"
            if entry.refcount < expected:
                self.stats.audit_increfs += expected - entry.refcount
                self.shard.cit_addref(fp, expected - entry.refcount, now=now)
                self._mark_chunk_dirty(fp, now)
                action = "incref"
            if expected > 0 and entry.flag == INVALID and fp in self.chunk_store:
                # Recipes prove the chunk live and the bytes are on disk:
                # the async flip was lost (crash / cancelled txn race) —
                # the same consistency check the read path runs.
                self.shard.cit_set_flag(fp, VALID, now)
                self.stats.audit_flag_flips += 1
                action = "flag_valid" if action == "ok" else action + "+flag"
            out.append(action)
        return tuple(out)

    def read_chunk(self, fp: Fingerprint, now: int) -> bytes:
        self._require_alive()
        data = self.chunk_store.get(fp)
        if data is None:
            raise ChunkMissing(self.node_id, fp)
        if sha256_fp(data) != fp and fp.namespace == "sha256":
            raise ChunkCorrupt(self.node_id, fp)
        self.stats.disk_bytes_read += len(data)
        entry = self.shard.cit_lookup(fp)
        if entry is not None and entry.flag == INVALID and entry.refcount > 0:
            # Read-path consistency check: bytes verified present & referenced.
            self.shard.cit_set_flag(fp, VALID, now)
            self.stats.repairs += 1
        return data

    def _serve_read_batch(
        self, fps: tuple[Fingerprint, ...], now: int
    ) -> ChunkReadBatchReply:
        """Serve a coalesced restore fetch: per-fp hit/miss instead of the
        single-chunk raise, so one degraded chunk fails alone while the
        rest of the batch is kept. Hits run the same read-path consistency
        check as ``read_chunk`` (repair-on-read flag flip included). A
        corrupt chunk reports a miss like absent bytes — the sender's
        replica walk treats both as "this replica cannot serve it"."""
        chunks: list[bytes | None] = []
        for fp in fps:
            try:
                chunks.append(self.read_chunk(fp, now))
            except (ChunkMissing, ChunkCorrupt):
                chunks.append(None)
        return ChunkReadBatchReply(tuple(chunks))

    def decref_chunk(self, fp: Fingerprint, now: int) -> None:
        self._require_alive()
        entry = self.shard.cit_lookup(fp)
        if entry is None:
            return
        if entry.refcount == 0:
            # A release for a reference this replica never kept: either it
            # missed the incref while unreachable, or a TxnCancel already
            # compensated an ack-lost application — yet the object COMMITTED
            # on the replicas that did ack, so its later delete/replace
            # releases on every placement target. The sender's recipe is the
            # authority that the logical reference existed; locally there is
            # nothing to release, and going negative would punish this
            # replica for under-replication the refcount audit exists to
            # repair (``refs_under``). Mirror the normal zero transition so
            # the entry ages out through GC if nothing re-references it.
            self.stats.decrefs_unbacked += 1
            self._mark_chunk_dirty(fp, now)
            self.shard.cit_set_flag(fp, INVALID, now)
            return
        rc = self.shard.cit_addref(fp, -1, now=now)
        self._mark_chunk_dirty(fp, now)
        if rc == 0:
            # Tombstone through the same tagged machinery: flag invalid,
            # GC ages it out; a re-reference before GC repairs it back.
            self.shard.cit_set_flag(fp, INVALID, now)

    def decref_chunks(
        self, fps: list[Fingerprint], now: int, audit: bool = False
    ) -> None:
        """Batched refcount release (rollback / delete): one unicast.
        ``audit=True`` marks releases the cluster-wide refcount audit
        PROVED unreferenced by any recipe: entries driven to zero skip the
        GC aging wait (the recipe walk is the cross-match evidence aging
        normally buys) and any still-queued async flips for them are
        purged — they belong to the leaked transaction being reclaimed."""
        for fp in fps:
            self.decref_chunk(fp, now)
        if not audit:
            return
        self.stats.audit_decrefs += len(fps)
        dead = [fp for fp in dict.fromkeys(fps)
                if (e := self.shard.cit_lookup(fp)) is not None and e.refcount == 0]
        for fp in dead:
            self.gc.note_audit(self.shard, fp, now)
        if dead:
            self.cm.purge(dead)

    def has_chunk(self, fp: Fingerprint) -> bool:
        return fp in self.chunk_store

    def cit_entry(self, fp: Fingerprint) -> CITEntry | None:
        return self.shard.cit_lookup(fp)

    # ----------------------------------------------------------------- local
    def _disk_write(self, fp: Fingerprint, data: bytes) -> None:
        self.chunk_store[fp] = data
        self.stats.disk_bytes_written += len(data)
        self.stats.chunk_writes += 1

    def tick(self, now: int) -> None:
        if self.alive:
            self.cm.drain(
                self.shard, now, on_flip=lambda fp: self._mark_chunk_dirty(fp, now)
            )

    def run_gc(self, now: int) -> list[Fingerprint]:
        if not self.alive:
            return []
        removed = self.gc.run(self.shard, self.chunk_store, now)
        for fp in removed:
            self._mark_chunk_dirty(fp, now)
        return removed

    def stored_bytes(self) -> int:
        return sum(len(v) for v in self.chunk_store.values())


class NodeDown(RuntimeError):
    def __init__(self, node_id: str):
        super().__init__(f"storage node {node_id} is down")
        self.node_id = node_id


class ChunkMissing(RuntimeError):
    def __init__(self, node_id: str, fp: Fingerprint):
        super().__init__(f"chunk {fp} missing on {node_id}")
        self.node_id, self.fp = node_id, fp


class ChunkCorrupt(RuntimeError):
    def __init__(self, node_id: str, fp: Fingerprint):
        super().__init__(f"chunk {fp} corrupt on {node_id}")
        self.node_id, self.fp = node_id, fp

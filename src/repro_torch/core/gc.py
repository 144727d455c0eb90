"""Garbage collector (paper §2.4, last paragraph).

Periodically collects chunk fingerprints whose CIT commit flag is INVALID,
holds them for a pre-defined aging threshold, then *cross-matches* the held
set against the live CIT: any fingerprint whose entry changed in the meantime
(flag flipped valid, refcount grew, entry re-inserted) is spared; unchanged
ones are removed together with their stored chunk bytes.

No journal, no extra logging — the commit flag IS the garbage marker.

The collector also owns the OMAP delete-tombstone GC horizon
(``tombstone_horizon``): how long a tombstone must age before this node
lists it as a reap candidate in omap digest replies. Reaping itself is a
cluster decision — the recovery coordinator sends ``TombstoneReap`` only
once EVERY live placement target has listed the tombstone as aged (fully
acked), because a tombstone's whole job is to outlive any stale live
replica it still needs to beat. The horizon is therefore the maximum
replica lag the delete path tolerates: a node that rejoins after being
down longer than the horizon may resurrect a reaped name — the standard
anti-entropy tombstone trade-off, sized here at several times the chunk
aging threshold.

Tombstone aging is the one GC decision made against a *wall clock*
(``deleted_at``), so it is the one place clock skew bites: a node whose
clock runs fast nominates early, and under the wrong failure schedule
that reaps before the true horizon (tests/test_simclock.py). Nodes with
a configured skew bound (``StorageNode.skew_guard``, set by
``DedupCluster.set_clock_skew``) widen their nomination threshold to
``tombstone_horizon + skew_guard`` — see docs/concurrency.md. Under the
discrete-event Scheduler (core/simclock.py) GC runs as a recurring
actor interleaved with live client sessions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.dmshard import DMShard, INVALID, VALID
from repro_torch.core.fingerprint import Fingerprint


@dataclass(frozen=True)
class _Held:
    fp: Fingerprint
    observed_at: int
    observed_refcount: int


@dataclass
class GarbageCollector:
    threshold: int = 10            # sim-ticks a fingerprint must stay invalid
    tombstone_horizon: int = 30    # sim-ticks an OMAP delete tombstone must age
    held: dict[Fingerprint, _Held] = field(default_factory=dict)
    collected_chunks: int = 0
    collected_bytes: int = 0
    spared: int = 0
    repaired: int = 0
    audit_fed: int = 0             # entries fed pre-aged by a refcount audit
    # Reclaim hook: called with the fingerprints a run physically removed.
    # The cluster wires this (only while presence-caching client sessions
    # are registered) to queue PresenceInvalidate fan-outs — a reclaimed
    # chunk is the one event that turns cached "exists" evidence into a
    # would-be dangling reference, so it must reach the caches. Unset (the
    # default) costs nothing and changes nothing.
    on_reclaim: Callable[[list[Fingerprint]], None] | None = None

    def scan(self, shard: DMShard, now: int) -> None:
        """Phase 1: collect currently-invalid fingerprints into the held set."""
        for fp in shard.invalid_fps():
            if fp not in self.held:
                e = shard.cit_lookup(fp)
                assert e is not None
                self.held[fp] = _Held(fp, now, e.refcount)

    def note_audit(self, shard: DMShard, fp: Fingerprint, now: int) -> None:
        """Feed an audit result into the aging cross-match: the cluster-wide
        refcount audit PROVED ``fp`` unreferenced by any OMAP recipe, which
        is exactly the evidence the aging threshold normally waits to
        accumulate — so the entry enters the held set pre-aged and the next
        sweep may collect it immediately. The cross-match itself still
        applies: any refcount/flag change between the audit's observation
        and the sweep (a racing re-reference) spares the entry."""
        e = shard.cit_lookup(fp)
        if e is None or e.flag != INVALID:
            return
        self.held[fp] = _Held(fp, now - self.threshold, e.refcount)
        self.audit_fed += 1

    def sweep(self, shard: DMShard, chunk_store: dict[Fingerprint, bytes], now: int) -> list[Fingerprint]:
        """Phase 2: cross-match aged fingerprints; delete the unchanged ones.

        Returns the list of removed fingerprints.
        """
        removed: list[Fingerprint] = []
        for fp, h in list(self.held.items()):
            if now - h.observed_at < self.threshold:
                continue
            del self.held[fp]
            e = shard.cit_lookup(fp)
            if e is None:
                continue  # already gone
            # Cross-match: any sign of life since observation spares it.
            if e.flag != INVALID or e.refcount != h.observed_refcount:
                self.spared += 1
                continue
            if e.refcount > 0:
                # Referenced but still flag-invalid: this happens when the
                # async flip was lost to a crash AFTER the transaction
                # committed. Deleting would lose live data (race found by
                # tests/test_property_dedup.py). Run the paper's
                # consistency check instead: bytes present -> repair flag.
                if fp in chunk_store:
                    shard.cit_set_flag(fp, VALID, now)
                self.repaired += fp in chunk_store
                self.spared += 1
                continue
            # Unreferenced invalid entry past threshold => garbage.
            self.collected_chunks += 1
            self.collected_bytes += e.size
            shard.cit_remove(fp)
            chunk_store.pop(fp, None)
            removed.append(fp)
        return removed

    def run(self, shard: DMShard, chunk_store: dict[Fingerprint, bytes], now: int) -> list[Fingerprint]:
        self.scan(shard, now)
        removed = self.sweep(shard, chunk_store, now)
        if removed and self.on_reclaim is not None:
            self.on_reclaim(removed)
        return removed

"""Asynchronous tagged-consistency manager (paper §2.4).

Every incoming write I/O *registers* with the per-node consistency manager.
Once the data I/O completes, the manager flips the CIT commit flag
INVALID -> VALID **asynchronously** — no transaction lock, no journal.

Determinism adaptation (DESIGN.md §6.1): instead of a daemon thread, pending
flips live in an explicit queue with a due-time; the cluster's ``tick()``
drains due events on *alive* nodes. A node crash discards the queue — exactly
the window the paper's design tolerates: the chunk bytes are on disk but the
flag never flips, so the chunk either ages into garbage (GC) or is repaired by
the consistency check on the next duplicate write / read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.dmshard import DMShard, VALID
from repro_torch.core.fingerprint import Fingerprint
from repro_torch.core.transport import BoundedIdSet


@dataclass(frozen=True)
class PendingFlip:
    fp: Fingerprint
    due: int            # sim time at which the flip may be applied
    txn_id: int         # transaction that registered the write


@dataclass
class ConsistencyManager:
    """Volatile (lost on crash) per-node flag-flip queue."""

    async_delay: int = 1           # sim-ticks between data-I/O done and flip
    queue: list[PendingFlip] = field(default_factory=list)
    flips_applied: int = 0
    flips_lost_to_crash: int = 0
    flips_coalesced: int = 0       # duplicate due-flips merged per drain pass
    flips_deduped: int = 0         # registrations refused: message id already seen
    flips_purged: int = 0          # queued flips dropped by a refcount audit
    # At-least-once guard: message ids whose flips were already registered.
    # The node's seen-window suppresses duplicate deliveries before they
    # reach us; this bounded window is the flip queue's own belt-and-braces
    # (ids are cheap, so it can outlive the node window). Volatile like the
    # queue itself — after a crash both the flips and the guard are gone,
    # which is exactly the window the tagged-consistency design tolerates.
    _seen_msg_ids: "BoundedIdSet" = field(
        default_factory=lambda: BoundedIdSet(capacity=4096)
    )

    def register(self, fp: Fingerprint, now: int, txn_id: int) -> None:
        self.register_many((fp,), now, txn_id)

    def register_many(self, fps, now: int, txn_id: int, msg_id: int | None = None) -> None:
        """Register one transaction's worth of writes in a single call —
        a batched unicast registers its whole op list at once instead of
        queueing flips one by one. A ``msg_id`` that was already registered
        (retransmitted/duplicated unicast) is a no-op: the flips for that
        delivery are queued at most once."""
        if msg_id is not None:
            if msg_id in self._seen_msg_ids:
                self.flips_deduped += 1
                return
            self._seen_msg_ids.add(msg_id)
        due = now + self.async_delay
        self.queue.extend(PendingFlip(fp, due, txn_id) for fp in fps)

    def drain(self, shard: DMShard, now: int, on_flip=None) -> int:
        """Apply all due flips, coalesced into one shard pass: duplicate
        fingerprints registered by several writes flip once. Returns the
        number of flips applied. ``on_flip(fp)`` is invoked per applied
        flip — the node hooks it to bump the fingerprint's placement-group
        dirty epoch, so an always-on incremental repair round that starts
        between a write and its async flip sees the group as still
        settling instead of silently clean."""
        due = [p for p in self.queue if p.due <= now]
        self.queue = [p for p in self.queue if p.due > now]
        seen: set[Fingerprint] = set()
        n = 0
        for p in due:
            if p.fp in seen:
                self.flips_coalesced += 1
                continue
            seen.add(p.fp)
            e = shard.cit_lookup(p.fp)
            if e is None:
                continue  # entry GCed/removed before the flip landed
            if e.refcount == 0:
                # The registering transaction aborted and rolled its
                # reference back — "I/O transaction completes" never
                # happened for this write, so the flag must stay INVALID
                # and the chunk ages into garbage.
                continue
            shard.cit_set_flag(p.fp, VALID, now)
            if on_flip is not None:
                on_flip(p.fp)
            n += 1
        self.flips_applied += n
        return n

    def purge(self, fps) -> int:
        """Drop queued flips for fingerprints a refcount audit just proved
        unreferenced (belt-and-braces: ``drain`` already refuses to flip a
        refcount-0 entry, but the audit KNOWS these flips belong to a
        leaked/rolled-back transaction, so they should not linger and fire
        against a later re-insert of the same fingerprint). Returns the
        number of flips dropped."""
        doomed = set(fps)
        before = len(self.queue)
        self.queue = [p for p in self.queue if p.fp not in doomed]
        dropped = before - len(self.queue)
        self.flips_purged += dropped
        return dropped

    def crash(self) -> None:
        self.flips_lost_to_crash += len(self.queue)
        self.queue.clear()
        self._seen_msg_ids.clear()

    def pending(self) -> int:
        return len(self.queue)

    def next_due(self) -> int | None:
        """Earliest due-time among queued flips (None when idle) — the
        scheduler's drain probe: run-to-quiescence keeps ticking until
        every node's flip queue is empty, so 'quiet' means the flags are
        settled, not merely that no actor is runnable."""
        if not self.queue:
            return None
        return min(p.due for p in self.queue)

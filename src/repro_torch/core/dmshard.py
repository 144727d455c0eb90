"""DM-Shard: the per-storage-server deduplication metadata shard.

Two persistent structures, exactly as in the paper (§2.2):

* OMAP — Object Map: object name -> (object fingerprint, ordered chunk-fp
  list). Holds the layout/reconstruction logic; lives on the OSS selected by
  hashing the *object name*.
* CIT — Chunk Information Table: chunk fingerprint -> (refcount, commit flag,
  size). Holds the performance-sensitive dedup metadata; lives on the OSS
  selected by hashing the *chunk content* — so every lookup is a unicast.

Commit flag semantics (tagged consistency, paper §2.4):
  flag == INVALID (0): fingerprint may not point at valid stored content —
      either the async flip hasn't happened yet, the txn crashed, or the
      refcount dropped to zero (tombstone; our reuse of the same machinery).
  flag == VALID (1): chunk bytes are guaranteed present on this server.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from repro_torch.core.fingerprint import Fingerprint, name_fp

INVALID = 0
VALID = 1


def digest_hash(fp: Fingerprint, has_bytes: bool, has_cit: bool) -> int:
    """Order-independent per-entry hash for recovery digests. Presence of
    the chunk bytes and of the CIT entry are part of the identity — two
    replicas disagree exactly when one is missing either — while refcount
    and flag are deliberately EXCLUDED: replicas legitimately diverge there
    in transit (pending async flips), and reconciling refcounts is the
    audit's job, not the digest diff's."""
    h = hashlib.blake2s(digest_size=8)
    h.update(fp.namespace.encode())
    h.update(fp.value)
    h.update(bytes((has_bytes, has_cit)))
    return int.from_bytes(h.digest(), "big")


def omap_digest_hash(
    name: str, object_fp: Fingerprint | None, deleted: bool = False
) -> int:
    """Per-entry hash for OMAP digests: the identity is (name, object
    fingerprint, tombstone marker) — replicas holding different versions
    of a name, a tombstone where a peer holds the live entry (a delete
    one replica missed), or missing the name entirely digest differently.
    A tombstone has no object fingerprint; its marker byte is the
    identity."""
    h = hashlib.blake2s(digest_size=8)
    h.update(name.encode("utf-8"))
    if object_fp is not None:
        h.update(object_fp.namespace.encode())
        h.update(object_fp.value)
    h.update(bytes((deleted,)))
    return int.from_bytes(h.digest(), "big")


@dataclass
class CITEntry:
    refcount: int = 0
    flag: int = INVALID
    size: int = 0
    # Bookkeeping for GC aging (sim time when the flag last became INVALID).
    invalid_since: int | None = None
    # Sim time of the last refcount/flag mutation. The incremental audit's
    # in-flight-transaction gate: an entry touched at or after a background
    # round's start epoch may belong to a transaction still completing, so
    # corrections for it are deferred to the next round.
    mtime: int = 0

    def is_valid(self) -> bool:
        return self.flag == VALID

    def snapshot(self) -> "CITEntry":
        """Detached copy, safe to put on the wire (rebalance/scrub)."""
        return CITEntry(
            self.refcount, self.flag, self.size, self.invalid_since, self.mtime
        )

    def clone_into(self, shard: "DMShard", fp: Fingerprint, now: int) -> "CITEntry | None":
        """Copy this entry into ``shard`` under ``fp`` unless one already
        exists there. The single place CIT entries are duplicated across
        nodes (chunk migration, stray-tombstone moves, scrub repair)."""
        if shard.cit_lookup(fp) is not None:
            return None
        e = shard.cit_insert(fp, self.size, now)
        e.refcount = self.refcount
        e.flag = self.flag
        e.invalid_since = self.invalid_since
        return e


@dataclass
class OMAPEntry:
    name: str
    object_fp: Fingerprint | None
    chunk_fps: list[Fingerprint]
    size: int
    # Commit version: the committing transaction's cluster-monotonic id.
    # Recovery's OMAP repair elects the replica holding the HIGHEST version
    # as authority — placement order alone would let a primary that was
    # down across a replace resurrect the old version cluster-wide, and a
    # per-name counter would reset on delete+recreate (letting a stale
    # higher-versioned replica overwrite the fresh entry); the txn counter
    # only ever grows, so the latest commit always wins.
    version: int = 1
    # Delete tombstone: ``deleted=True`` records that this name was deleted
    # by transaction ``version`` at sim time ``deleted_at``. The record has
    # no live recipe (object_fp None — the delete released the refs;
    # ``chunk_fps`` merely RETAINS the released fingerprints for the reap's
    # presence-invalidation fan-out and is excluded from digest identity
    # and recipe_refs) but is replicated, digested, and repaired exactly
    # like a live entry, so a replica that missed the delete adopts the
    # tombstone instead of resurrecting the name. ``deleted_at`` travels
    # with the record unchanged: a late adopter inherits the ORIGINAL
    # deletion time, so the GC horizon ages cluster-consistently.
    deleted: bool = False
    deleted_at: int | None = None


@dataclass
class DMShard:
    """One shard; hosted by exactly one StorageNode, replicated like data."""

    omap: dict[str, OMAPEntry] = field(default_factory=dict)
    cit: dict[Fingerprint, CITEntry] = field(default_factory=dict)

    # --- CIT ops (unicast targets of fingerprint-routed I/O) ---------------
    def cit_lookup(self, fp: Fingerprint) -> CITEntry | None:
        return self.cit.get(fp)

    def cit_insert(self, fp: Fingerprint, size: int, now: int) -> CITEntry:
        if fp in self.cit:
            raise KeyError(f"CIT entry exists for {fp}")
        e = CITEntry(refcount=0, flag=INVALID, size=size, invalid_since=now, mtime=now)
        self.cit[fp] = e
        return e

    def cit_set_flag(self, fp: Fingerprint, flag: int, now: int) -> None:
        e = self.cit[fp]
        if e.flag != flag:
            e.flag = flag
            e.invalid_since = now if flag == INVALID else None
            e.mtime = max(e.mtime, now)

    def cit_addref(self, fp: Fingerprint, delta: int = 1, now: int | None = None) -> int:
        e = self.cit[fp]
        e.refcount += delta
        if e.refcount < 0:
            raise AssertionError(f"negative refcount for {fp}")
        if now is not None:
            e.mtime = max(e.mtime, now)
        return e.refcount

    def cit_remove(self, fp: Fingerprint) -> None:
        del self.cit[fp]

    # --- batched CIT ops (one unicast carries many chunk ops) ---------------
    def cit_lookup_many(self, fps: list[Fingerprint]) -> list[CITEntry | None]:
        """Batched lookup — the payload of one batched unicast message."""
        cit = self.cit
        return [cit.get(fp) for fp in fps]

    def cit_insert_many(
        self, items: list[tuple[Fingerprint, int]], now: int
    ) -> list[CITEntry]:
        return [self.cit_insert(fp, size, now) for fp, size in items]

    def cit_addref_many(self, fps: list[Fingerprint], delta: int = 1) -> list[int]:
        return [self.cit_addref(fp, delta) for fp in fps]

    # --- OMAP ops (object-name-routed I/O) ----------------------------------
    def omap_put(self, entry: OMAPEntry) -> None:
        self.omap[entry.name] = entry

    def omap_apply(self, entry: OMAPEntry) -> tuple[bool, OMAPEntry | None]:
        """Version-gated put: the cluster-monotonic commit-version authority
        rule applied receiver-side. The record lands only when it is at
        least as new as what the replica holds — so a DELAYED commit
        arriving after a newer replace or a newer tombstone cannot
        resurrect the old version, and a tombstone cannot clobber a
        recreate it lost the race to. Returns ``(applied, replaced)``:
        whether the record landed, and the record it replaced (entry or
        tombstone, None when the name was absent or the put was refused).
        The replaced record rides the commit's response so the SENDER can
        release exactly the version its put displaced — under concurrent
        sessions two replacers may both have planned against the same
        previous version, and releasing the plan-time fetch twice would
        corrupt refcounts; the response-carried record is released exactly
        once, by the writer that actually displaced it."""
        cur = self.omap.get(entry.name)
        if cur is not None and cur.version > entry.version:
            return False, None
        self.omap[entry.name] = entry
        return True, cur

    def omap_get(self, name: str) -> OMAPEntry | None:
        return self.omap.get(name)

    def omap_delete(self, name: str) -> OMAPEntry | None:
        return self.omap.pop(name, None)

    def omap_tombstone(
        self, name: str, version: int, now: int
    ) -> tuple[bool, OMAPEntry | None]:
        """Commit a delete tombstone at ``version`` (the deleting txn's
        cluster-monotonic id). A strictly newer record already in place
        wins — the delete is stale — otherwise the tombstone replaces
        whatever is held (including nothing: a replica that missed the put
        entirely still records the delete, guarding against the put's late
        copy). Returns ``(applied, previous_entry)``; the previous LIVE
        entry rides the response into the sender's seen-window so a
        cancelled delete can restore it.

        The tombstone RETAINS the replaced recipe's chunk fingerprints
        (``chunk_fps``; carried forward from a previous tombstone on
        re-delete). They are not part of the digest identity and
        ``recipe_refs`` still skips tombstones — the recipe is released —
        but the reap can then return them, giving presence caches a
        last-chance invalidation for deletes whose original fan-out was
        lost (e.g. across a partition)."""
        prev = self.omap.get(name)
        if prev is not None and prev.version > version:
            return False, None
        retained = list(prev.chunk_fps) if prev is not None else []
        self.omap[name] = OMAPEntry(
            name, None, retained, 0, version, deleted=True, deleted_at=now
        )
        return True, prev

    def omap_reap(self, name: str, version: int) -> OMAPEntry | None:
        """GC-horizon reap: remove the tombstone record iff the held entry
        is a tombstone at exactly ``version`` (a newer write or delete is
        untouched). Idempotent — the coordinator only sends this once every
        live placement target proved it holds the aged tombstone. Returns
        the reaped record (its retained ``chunk_fps`` ride the response,
        feeding the coordinator's presence-invalidation fan-out) or None
        when nothing was reaped."""
        cur = self.omap.get(name)
        if cur is None or not cur.deleted or cur.version != version:
            return None
        del self.omap[name]
        return cur

    def aged_tombstones(self, now: int, horizon: int) -> dict[str, tuple[int, int]]:
        """Tombstones past the GC horizon (name -> (version, deleted_at)) —
        this node's reap candidates, listed in omap digest summary replies
        so the coordinator can check cluster-wide full-ack before reaping."""
        return {
            name: (e.version, e.deleted_at)
            for name, e in self.omap.items()
            if e.deleted and e.deleted_at is not None
            and now - e.deleted_at >= horizon
        }

    # --- recovery digests (per-placement-group content summaries) -----------
    def chunk_digest(
        self,
        chunk_store: dict[Fingerprint, bytes],
        cmap,
        groups: tuple = (),
        detail_all: bool = False,
        only_groups: set | None = None,
        summary_only: bool = False,
    ) -> tuple[dict, dict, int]:
        """Digest THIS shard's chunk/CIT holdings, grouped by the placement
        tuple each fingerprint hashes to under ``cmap``. Returns
        ``(summary, entries, skipped)``: summary maps group ->
        (count, xor-hash); entries (detail mode: ``groups`` named or
        ``detail_all``) map fp -> (has_bytes, has_cit, refcount, flag,
        size, mtime). With ``only_groups`` (the node's dirty set for an
        incremental probe) summaries cover just those groups and
        ``skipped`` counts the clean groups left un-digested;
        ``summary_only`` restricts summaries to the named ``groups``
        without expanding detail. Strictly node-local — the wire view of
        this node a recovery coordinator reconciles against."""
        from repro_torch.core.placement import place

        want = set(groups)
        detail = not summary_only and (detail_all or bool(want))
        summary: dict = {}
        entries: dict = {}
        skipped: set = set()
        for fp in set(self.cit) | set(chunk_store):
            g = tuple(place(fp, cmap))
            if not detail:
                if summary_only and g not in want:
                    continue
                if only_groups is not None and g not in only_groups:
                    skipped.add(g)
                    continue
                cnt, xo = summary.get(g, (0, 0))
                summary[g] = (cnt + 1, xo ^ digest_hash(fp, fp in chunk_store, fp in self.cit))
                continue
            if not detail_all and g not in want:
                continue
            e = self.cit.get(fp)
            entries[fp] = (
                fp in chunk_store,
                e is not None,
                e.refcount if e is not None else 0,
                e.flag if e is not None else INVALID,
                e.size if e is not None else 0,
                e.mtime if e is not None else 0,
            )
        return summary, entries, len(skipped)

    def omap_digest(
        self,
        cmap,
        groups: tuple = (),
        detail_all: bool = False,
        only_groups: set | None = None,
        summary_only: bool = False,
    ) -> tuple[dict, dict, int]:
        """Digest THIS shard's OMAP entries (tombstones included — a
        tombstone digests differently from the live entry it replaced and
        from absence, which is exactly what lets repair propagate deletes),
        grouped by object-name placement. Detail entries map name ->
        (object fingerprint, commit version, deleted, deleted_at) — the
        identity and authority a repair needs to pick a holder; the recipe
        itself travels with the repairing ``OmapPut``, not with the
        digest. ``only_groups`` / ``summary_only`` as in
        ``chunk_digest``; returns ``(summary, entries, skipped)``."""
        from repro_torch.core.placement import place

        want = set(groups)
        detail = not summary_only and (detail_all or bool(want))
        summary: dict = {}
        entries: dict = {}
        skipped: set = set()
        for name, e in self.omap.items():
            g = tuple(place(name_fp(name), cmap))
            if not detail:
                if summary_only and g not in want:
                    continue
                if only_groups is not None and g not in only_groups:
                    skipped.add(g)
                    continue
                cnt, xo = summary.get(g, (0, 0))
                summary[g] = (cnt + 1, xo ^ omap_digest_hash(name, e.object_fp, e.deleted))
            elif detail_all or g in want:
                entries[name] = (e.object_fp, e.version, e.deleted, e.deleted_at)
        return summary, entries, len(skipped)

    def recipe_refs(self, cmap, live: tuple, self_id: str) -> dict[Fingerprint, int]:
        """Aggregated chunk-reference counts from the recipes this node
        OWNS: it is the first live name-hash target of the entry under
        ``cmap`` given the coordinator's ``live`` set — so across the
        cluster every logical object is counted by exactly one owner, even
        though OMAP entries are replicated. Occurrences count: an object
        whose recipe repeats a chunk took one reference per occurrence.
        Tombstones carry no recipe (the delete released the refs) and are
        skipped."""
        from repro_torch.core.placement import place

        live_set = set(live)
        counts: dict[Fingerprint, int] = {}
        for name, e in self.omap.items():
            if e.deleted:
                continue
            owner = next(
                (t for t in place(name_fp(name), cmap) if t in live_set), None
            )
            if owner != self_id:
                continue
            for fp in e.chunk_fps:
                counts[fp] = counts.get(fp, 0) + 1
        return counts

    # --- introspection -------------------------------------------------------
    def stored_bytes(self) -> int:
        return sum(e.size for e in self.cit.values())

    def valid_bytes(self) -> int:
        return sum(e.size for e in self.cit.values() if e.is_valid())

    def invalid_fps(self) -> list[Fingerprint]:
        return [fp for fp, e in self.cit.items() if e.flag == INVALID]

"""Message-driven recovery subsystem: digest-diff repair, cluster-wide
refcount audit, post-partition reconciliation.

The paper's headline claim is robustness under sudden server failure; this
module is the repair half of that claim, built so every recovery action is
a typed message on the transport (``core/messages.py``) rather than an
omniscient cluster-level scan:

* **Digest exchange** — a recovery coordinator probes each node with
  ``DigestRequest``; the node answers with per-placement-group
  ``(count, xor-hash)`` summaries of its OWN holdings (``DigestReply``).
  Only groups whose replica digests disagree are expanded into per-entry
  detail listings, so reconciliation wire cost is O(groups) plus
  O(entries of the divergent slice) — the digest-based alternative to
  shipping (or omnisciently reading) whole tables.
* **Digest-diff repair** — for every fingerprint a live placement target
  is missing, a holder ships ``RepairChunk`` (bytes and/or a CIT snapshot
  reconstructed from wire-learned detail). Source selection prefers a
  holder whose shard actually has the CIT entry; when bytes and metadata
  live on different survivors, each ships from the node that has it.
* **Cluster-wide refcount audit** — expected reference counts are
  recomputed from OMAP recipes, walked by name-hash OWNER (each logical
  object counted by exactly one live owner even though OMAP is
  replicated), and reconciled against every CIT replica: excess refs are
  released through audit-tagged ``DecrefBatch`` messages (which feed the
  GC's aging cross-match), missing refs and stuck-INVALID flags are
  corrected through ``RefAudit``. This closes, by construction, the
  at-least-once residual window where a ``TxnCancel`` is itself lost
  after an applied-but-unacked op: the leaked references are exactly the
  ones no recipe accounts for.
* **Post-partition reconciliation** — ``run()`` chains OMAP repair →
  chunk digest repair → refcount audit → GC, converging a healed
  split-brain cluster to the state a never-partitioned one would hold.

State-access discipline: the coordinator learns remote state ONLY from
digest replies that traveled (and can be lost / duplicated / reordered)
on the wire. The only direct object access is *sender-local*: reading a
holder's own chunk store / OMAP to build the message that holder sends —
the same idiom as rebalance, where a node reads its own disk to transmit.

Deletes are recovery-safe: ``OmapDelete`` commits a VERSIONED tombstone
record that is replicated, digested and repaired exactly like a live
entry — authority is the highest commit version regardless of liveness,
so a tombstone beats any stale live replica (no resurrection) and a
recreate beats a stale tombstone, including across partitions. Tombstones
past the GC horizon are reaped only on cluster-wide full-ack proof
(every live placement target lists the aged tombstone at the same
version), via ``TombstoneReap``.

Recovery is also ALWAYS-ON capable: digests carry an epoch, nodes track
per-placement-group dirty epochs, and an incremental round
(``since_epoch``) re-digests only groups mutated since the last completed
round — clean groups are skipped and counted. A second summary-only probe
wave disambiguates "skipped because clean" from "holds nothing" for
groups a peer reported. ``RepairDaemon`` packages this as a background
loop that interleaves with live writes; its refcount audit excludes
fingerprints any replica touched at or after the round's start epoch
(in-flight transactions are deferred to the next round, not misjudged).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.dmshard import CITEntry, INVALID, VALID
from repro_torch.core.fingerprint import Fingerprint, name_fp
from repro_torch.core.messages import (
    DecrefBatch,
    DigestRequest,
    MigrateChunk,
    OmapPut,
    RefAudit,
    RepairChunk,
    TombstoneReap,
)
from repro_torch.core.node import NodeDown
from repro_torch.core.placement import place
from repro_torch.core.transport import MessageDropped

# The recovery coordinator's transport identity. Like the external
# "client", it is not a member of any partition group — recovery runs
# post-heal by definition — but every message it triggers between NODES
# (RepairChunk, holder-sourced OmapPut) is subject to the delivery policy.
RECOVERY_SRC = "recovery"


@dataclass
class RecoveryReport:
    """What one recovery round observed and corrected."""

    digest_msgs: int = 0          # DigestRequest probes sent (summary + detail)
    groups_checked: int = 0       # placement groups compared across replicas
    groups_mismatched: int = 0    # groups whose replica digests disagreed
    omap_repaired: int = 0        # OMAP entries restored onto missing replicas
    chunks_repaired: int = 0      # chunk byte copies restored (scrub's currency)
    cit_repaired: int = 0         # CIT entry snapshots restored
    repair_bytes: int = 0         # chunk bytes shipped by RepairChunk
    refs_over: int = 0            # excess references released by the audit
    refs_under: int = 0           # missing references restored by the audit
    flags_flipped: int = 0        # stuck-INVALID flags the audit repaired
    audit_msgs: int = 0           # correction messages (DecrefBatch + RefAudit)
    audit_skipped: bool = False   # recipes unreadable from a live node -> no audit
    missing_entries: int = 0      # recipe-referenced fps with no CIT entry on a target
    unrecoverable: int = 0        # fps whose bytes survive on no holder
    gc_removed: int = 0           # chunks GC reclaimed during the round
    unreachable: int = 0          # digest probes lost (node skipped this round)
    groups_digested: int = 0      # group summaries nodes actually computed
    groups_skipped: int = 0       # clean groups incremental probes skipped
    tombstones_reaped: int = 0    # aged tombstone removals acked (full-ack reap)
    audit_deferred: int = 0       # fps excluded from the audit as in-flight

    @property
    def corrections(self) -> int:
        return self.refs_over + self.refs_under + self.flags_flipped


@dataclass
class RecoveryRound:
    """One recovery pass, split into explicit phases so callers (and
    tests) can interleave cluster events — a rebalance landing between
    digest collection and repair must not double-repair a migrated chunk:
    placement is re-resolved against the CURRENT map at every send, and
    the repair handler is adopt-if-missing either way."""

    cluster: object
    src: str = RECOVERY_SRC
    # Incremental floor: only placement groups a node marked dirty at or
    # after this epoch are re-digested (None = full round, every group).
    since_epoch: int | None = None
    # Audit concurrency gate: fingerprints whose CIT entry ANY replica
    # mutated at or after this epoch belong to transactions in flight
    # while the round runs — they are deferred, not judged (None = quiesced
    # round, judge everything).
    exclude_after: int | None = None
    report: RecoveryReport = field(default_factory=RecoveryReport)
    _chunk_digests: dict = field(default_factory=dict)   # nid -> {group: (count, xor)}
    _aged_tombstones: dict = field(default_factory=dict) # nid -> {name: (ver, at)}
    _tombstones_collected: bool = False
    # None = repair_omap has not run this round (standalone audits are the
    # caller's responsibility); False = it ran but lost probes, so OMAP
    # replicas may still be incomplete and the audit must not trust the
    # recipe walk (an unrepaired owner under-counts its objects' refs).
    _omap_repair_complete: bool | None = None

    # ------------------------------------------------------------- plumbing
    def _live(self) -> list[str]:
        return [nid for nid, n in self.cluster.nodes.items() if n.alive]

    def _ask(self, nid: str, msg: DigestRequest):
        """One digest probe; a reply lost past the retry budget skips the
        node for this round (counted) instead of failing recovery."""
        self.report.digest_msgs += 1
        try:
            return self.cluster.transport.send(self.src, nid, msg, self.cluster.now)
        except (MessageDropped, NodeDown):
            self.report.unreachable += 1
            return None

    def _send(self, src: str, dst: str, msg) -> object | None:
        try:
            return self.cluster.transport.send(src, dst, msg, self.cluster.now)
        except (MessageDropped, NodeDown):
            return None

    @staticmethod
    def _mismatched(replies: dict) -> tuple[set, dict]:
        """Compare each placement group's digest across every node that
        should hold it (its members — the group key IS the placement
        tuple) and every node that reports content for it (a stray holder
        left behind by an interrupted rebalance). Returns
        ``(all_groups, {group: nodes_to_detail})`` for the groups whose
        digests disagree; a member with no reply is unknown and excluded,
        a replying member without the group digests as empty — exactly a
        mismatch when a peer holds content for it."""
        groups: set = set()
        for r in replies.values():
            groups.update(r.keys())
        out: dict = {}
        for g in sorted(groups, key=repr):
            have = {n for n, r in replies.items() if g in r}
            consider = have | {n for n in g if n in replies}
            if len(consider) < 2:
                continue
            digests = {replies[n].get(g, (0, 0)) for n in consider}
            if len(digests) > 1:
                out[g] = sorted(consider)
        return groups, out

    def _collect_summaries(self, kind: str) -> dict:
        """Collect per-group summaries from every live node; the heart of
        both full and incremental rounds. A full round (``since_epoch``
        None) is one probe wave. An incremental round is two:

        1. every node digests only its DIRTY groups (clean ones are
           skipped server-side and counted), and — for omap probes —
           lists its aged tombstones;
        2. for each group some peer DID report, every group member that
           replied but skipped it is re-probed ``summary_only`` for just
           those groups — otherwise ``_mismatched`` would read "skipped
           because clean" as "holds nothing" and repair against a hole.

        Groups clean on EVERY holder are never compared — the incremental
        win. A stray group whose content was never touched stays invisible
        to incremental rounds; the periodic full round still finds it."""
        c = self.cluster
        replies: dict = {}
        for nid in self._live():
            r = self._ask(
                nid,
                DigestRequest(kind=kind, cmap=c.cmap, since_epoch=self.since_epoch),
            )
            if r is None:
                continue
            replies[nid] = dict(r.groups)
            self.report.groups_digested += len(r.groups)
            self.report.groups_skipped += r.skipped_groups
            if kind == "omap":
                if r.tombstones:
                    self._aged_tombstones[nid] = dict(r.tombstones)
                self._tombstones_collected = True
        if self.since_epoch is not None:
            need: dict[str, set] = {}
            all_groups: set = set()
            for r in replies.values():
                all_groups.update(r)
            for g in all_groups:
                for member in g:
                    if member in replies and g not in replies[member]:
                        need.setdefault(member, set()).add(g)
            for nid in sorted(need):
                r = self._ask(
                    nid,
                    DigestRequest(
                        kind=kind,
                        cmap=c.cmap,
                        groups=tuple(sorted(need[nid], key=repr)),
                        summary_only=True,
                    ),
                )
                if r is not None:
                    replies[nid].update(r.groups)
                    self.report.groups_digested += len(r.groups)
        return replies

    # ------------------------------------------------- phase 1: OMAP repair
    def repair_omap(self) -> int:
        """Reconcile OMAP replica sets by name-placement-group digest diff;
        a replica missing an entry adopts it from a holder (the holder
        sends ``OmapPut(migrate=True)`` — its own shard read sender-side,
        the recipe traveling as a stored record). Must run before the
        audit: an owner replica that missed a commit while unreachable
        would otherwise under-count expected references and the audit
        would release live data."""
        c = self.cluster
        lost_before = self.report.unreachable
        replies = self._collect_summaries("omap")
        _, mismatched = self._mismatched(replies)
        repaired = 0
        for g, consider in mismatched.items():
            details: dict = {}
            for nid in consider:
                r = self._ask(nid, DigestRequest(kind="omap", cmap=c.cmap, groups=(g,)))
                if r is not None:
                    details[nid] = r.entries
            names: set = set()
            for entries in details.values():
                names.update(entries)
            for name in sorted(names):
                targets = place(name_fp(name), c.cmap)  # CURRENT map, not digest-time
                order = {t: i for i, t in enumerate(targets)}
                holders = [n for n in targets if name in details.get(n, ())]
                # Stray holders (an interrupted rebalance retained the
                # entry off-placement) are last-resort sources: without
                # them a move whose every delivery was lost would leave
                # the entry unreachable by name-hash lookup forever.
                holders += [
                    n for n in sorted(details)
                    if n not in targets and name in details[n]
                ]
                if not holders:
                    continue
                # Version authority: the replica holding the HIGHEST commit
                # version wins (every replace AND every delete bumps the
                # cluster-monotonic version), with placement order breaking
                # ties. Placement order alone is wrong precisely when
                # recovery matters: a primary that was down across a
                # replace holds the OLD version and would resurrect it
                # cluster-wide. Tombstones are records like any other: a
                # tombstone at the highest version is the authority (the
                # delete propagates, no resurrection), and a live recreate
                # above a tombstone's version wins right back.
                authority = min(
                    holders,
                    key=lambda n: (-details[n][name][1], order.get(n, len(targets))),
                )
                auth_version = details[authority][name][1]
                entry = c.nodes[authority].shard.omap_get(name)  # sender-local
                if entry is None:
                    continue
                for t in targets:
                    if t not in details or t == authority or not c.nodes[t].alive:
                        continue
                    held = details[t].get(name)
                    if held is not None and held[1] == auth_version:
                        continue  # replica already holds the authoritative version
                    if self._send(authority, t, OmapPut(entry, migrate=True)) is not None:
                        repaired += 1
                # A stray holding a STALE version upgrades in place too —
                # otherwise its group summary diverges forever and every
                # later round re-details the group. Strays holding nothing
                # adopt nothing: repair converges replicas, rebalance (or
                # reap) drains strays.
                for t in sorted(details):
                    if t in targets or t == authority or not c.nodes[t].alive:
                        continue
                    held = details[t].get(name)
                    if held is None or held[1] == auth_version:
                        continue
                    if self._send(authority, t, OmapPut(entry, migrate=True)) is not None:
                        repaired += 1
        # Any lost probe means a replica's OMAP state is unknown — a node
        # that silently missed commits could still be elected recipe owner
        # with incomplete recipes, so the audit must not run this round.
        self._omap_repair_complete = self.report.unreachable == lost_before
        self.report.omap_repaired += repaired
        return repaired

    # --------------------------------------------- phase 2: chunk digests
    def collect_digests(self) -> dict:
        """Per-placement-group chunk/CIT summaries from every live node.
        Kept separate from ``repair_chunks`` so a topology change between
        the two is an explicit, testable hazard."""
        self._chunk_digests = self._collect_summaries("chunks")
        return self._chunk_digests

    def repair_chunks(self) -> int:
        """Digest-diff repair: expand mismatched groups into detail
        listings, then ship every missing byte copy / CIT snapshot from a
        surviving holder to each live placement target. Placement is
        resolved against the CURRENT cluster map at send time, so entries
        migrated by a rebalance since digest collection are skipped rather
        than repaired to a stale target. Returns byte copies restored
        (the old ``scrub`` contract)."""
        c = self.cluster
        if not self._chunk_digests:
            self.collect_digests()
        groups, mismatched = self._mismatched(self._chunk_digests)
        self.report.groups_checked += len(groups)
        self.report.groups_mismatched += len(mismatched)
        restored = 0
        for g, consider in mismatched.items():
            details: dict = {}
            for nid in consider:
                r = self._ask(
                    nid, DigestRequest(kind="chunks", cmap=c.cmap, groups=(g,))
                )
                if r is not None:
                    details[nid] = r.entries
            fps: set = set()
            for entries in details.values():
                fps.update(entries)
            for fp in sorted(fps):
                restored += self._repair_fp(fp, details)
        self.report.chunks_repaired += restored
        return restored

    def _repair_fp(self, fp: Fingerprint, details: dict) -> int:
        """Repair one fingerprint from wire-learned detail: for each live
        CURRENT-map target missing bytes or the CIT entry, pick sources —
        preferring a holder that has BOTH — and ship ``RepairChunk``. The
        CIT snapshot is built from the digest detail, never read from a
        foreign shard; the chunk bytes are the sending holder's own disk."""
        c = self.cluster
        absent = (False, False, 0, INVALID, 0, 0)
        has_bytes = [n for n, e in details.items() if e.get(fp, absent)[0]]
        has_cit = [n for n, e in details.items() if e.get(fp, absent)[1]]

        def snap_from(nid: str) -> CITEntry:
            _, _, refcount, flag, size, _ = details[nid][fp]
            return CITEntry(
                refcount, flag, size, None if flag == VALID else c.now
            )

        restored = 0
        for t in place(fp, c.cmap):
            if t not in details or not c.nodes[t].alive:
                continue  # unknown state (joined after digests) or down
            t_bytes, t_cit = details[t].get(fp, absent)[:2]
            need_bytes, need_cit = not t_bytes, not t_cit
            if not (need_bytes or need_cit):
                continue
            # Prefer a single holder carrying both bytes and metadata —
            # the fix for the old scrub's have[0] bug, which snapshotted
            # the CIT from an arbitrary holder even when it had no entry.
            full = [n for n in has_bytes if n in has_cit and n != t]
            if need_bytes:
                src = full[0] if full else next(
                    (n for n in has_bytes if n != t), None
                )
                data = (
                    c.nodes[src].chunk_store.get(fp)  # sender-local disk read
                    if src is not None
                    else None
                )
                if src is None:
                    # bytes survive on no holder; a surviving CIT entry is
                    # still repaired below so the group's digests converge
                    self.report.unrecoverable += 1
                elif data is not None:  # None = raced away since the digest
                    snap = snap_from(src) if src in has_cit and need_cit else None
                    resp = self._send(src, t, RepairChunk(fp, data, snap))
                    if resp is not None and resp[0] == "stored":
                        restored += 1
                        self.report.repair_bytes += len(data)
                    if resp is not None and resp[1] == "cit_stored":
                        self.report.cit_repaired += 1
                        need_cit = False
                    if snap is not None:
                        need_cit = False  # attempted with the bytes already
            if need_cit and has_cit:
                src = next((n for n in has_cit if n != t), None)
                if src is None:
                    continue
                resp = self._send(src, t, RepairChunk(fp, None, snap_from(src)))
                if resp is not None and resp[1] == "cit_stored":
                    self.report.cit_repaired += 1
        return restored

    # ------------------------------------------------- phase 3: ref audit
    def audit_refcounts(self) -> int:
        """Cluster-wide refcount audit. Expected counts walk the recipes
        by name-hash owner (one live owner per logical object); actual
        counts come from full CIT detail digests. Divergence becomes
        correction messages:

        * actual > expected — references no recipe accounts for (the lost
          TxnCancel leak, rolled-back garbage): an audit-tagged
          ``DecrefBatch`` releases the excess, and entries driven to zero
          skip the GC aging wait (the recipe walk is the cross-match).
        * actual < expected — a replica that missed increfs while
          unreachable: ``RefAudit`` raises it.
        * stuck INVALID with live recipes and bytes on disk — ``RefAudit``
          flips the flag (the lost-async-flip repair, audit flavor).

        Safety gate: if ANY live node's recipe digest is lost — or the
        round's OMAP repair phase lost probes, leaving replicas possibly
        unrepaired — the audit is skipped: partial expected counts would
        release references belonging to the unheard node's objects.

        Concurrency gate (``exclude_after``): a fingerprint whose CIT
        entry ANY replica mutated at or after the round's start epoch may
        belong to a transaction still completing — its refs were taken but
        its commit (or its async flag flip) has not landed, so the recipe
        walk would misread it as leaked. Such fingerprints are deferred to
        the next round (counted as ``audit_deferred``), which lets the
        audit run CONCURRENTLY with live writes instead of requiring a
        quiesced cluster."""
        if self._omap_repair_complete is False:
            self.report.audit_skipped = True
            return 0
        c = self.cluster
        live = tuple(sorted(self._live()))
        expected: dict[Fingerprint, int] = {}
        for nid in live:
            r = self._ask(
                nid, DigestRequest(kind="recipes", cmap=c.cmap, live=live)
            )
            if r is None:
                self.report.audit_skipped = True
                return 0
            for fp, n in r.entries.items():
                expected[fp] = expected.get(fp, 0) + n
        actual: dict[str, dict] = {}
        for nid in live:
            r = self._ask(
                nid, DigestRequest(kind="chunks", cmap=c.cmap, detail_all=True)
            )
            if r is not None:
                actual[nid] = r.entries

        young: set = set()
        if self.exclude_after is not None:
            for nid in actual:
                for fp, d in actual[nid].items():
                    if d[5] >= self.exclude_after:
                        young.add(fp)
            self.report.audit_deferred += len(young)
        # Sent-but-uncommitted waves (a Scheduler session yielded between
        # its send and commit phases): their chunk mtimes can PREDATE the
        # round start, so the epoch gate above misses them, yet their refs
        # have no committed recipe — the recipe walk would misread them as
        # leaked and decref live data. This is the coordinator's own
        # in-flight transaction knowledge (same authority as
        # ``exclude_after``), not cross-node state: the synchronous write
        # path commits in the same call as its send, so the set is always
        # empty outside scheduled runs.
        inflight = getattr(c, "inflight_audit_fps", None)
        if inflight is not None:
            fresh = inflight() - young
            if fresh:
                young |= fresh
                self.report.audit_deferred += len(fresh)

        decrefs: dict[str, list[Fingerprint]] = {}
        corrections: dict[str, list] = {}
        for nid in sorted(actual):
            for fp in sorted(actual[nid]):
                if fp in young:
                    continue
                _, has_cit, refcount, flag, _, _ = actual[nid][fp]
                targets = place(fp, c.cmap)  # CURRENT map: migrated chunks
                if nid not in targets:
                    continue  # stray awaiting rebalance — not audit's call
                exp = expected.get(fp, 0)
                if not has_cit:
                    if exp > 0:
                        self.report.missing_entries += 1
                    continue
                if refcount > exp:
                    decrefs.setdefault(nid, []).extend([fp] * (refcount - exp))
                    self.report.refs_over += refcount - exp
                elif refcount < exp:
                    corrections.setdefault(nid, []).append((fp, exp))
                    self.report.refs_under += exp - refcount
                elif exp > 0 and flag == INVALID and actual[nid][fp][0]:
                    corrections.setdefault(nid, []).append((fp, exp))
                    self.report.flags_flipped += 1

        for nid, fps in decrefs.items():
            if self._send(self.src, nid, DecrefBatch(tuple(fps), audit=True)) is not None:
                self.report.audit_msgs += 1
        for nid, items in corrections.items():
            if self._send(self.src, nid, RefAudit(tuple(items))) is not None:
                self.report.audit_msgs += 1
        return self.report.corrections

    # ------------------------------------------- phase 4: tombstone reap
    def reap_tombstones(self) -> int:
        """GC-horizon tombstone reap, gated on cluster-wide full-ack proof:
        a tombstone is reaped only when EVERY live placement target under
        the current map listed it as aged at the SAME version — i.e. the
        delete is fully replicated and no stale live replica remains for
        it to beat. Anything less (a target unreachable, still holding the
        live entry, or holding a different version) keeps the tombstone
        for the next round; repair converges the replicas first. The reap
        itself is version-conditional at the receiver, so a recreate that
        lands between proof and reap survives.

        A successful reap's response carries the tombstone's retained
        chunk fingerprints (the deleted recipe); the coordinator fans them
        out as ``PresenceInvalidate`` to registered client sessions — the
        last-chance invalidation for a delete whose original fan-out was
        lost (e.g. the session was partitioned away when the delete ran)."""
        c = self.cluster
        if not self._tombstones_collected:
            self._collect_summaries("omap")
        candidates: dict[str, dict[str, int]] = {}
        for nid, tombs in self._aged_tombstones.items():
            for name, (version, _at) in tombs.items():
                candidates.setdefault(name, {})[nid] = version
        reaped = 0
        reap_fps: set = set()
        for name in sorted(candidates):
            listers = candidates[name]
            if len(set(listers.values())) != 1:
                continue  # replicas disagree on the delete: repair first
            version = next(iter(listers.values()))
            targets = [
                t for t in place(name_fp(name), c.cmap) if c.nodes[t].alive
            ]
            if not targets or any(t not in listers for t in targets):
                continue  # not fully acked by every live placement target
            for t in sorted(listers):
                if not c.nodes[t].alive:
                    continue
                resp = self._send(self.src, t, TombstoneReap(name, version))
                if isinstance(resp, tuple) and resp[0] == "reaped":
                    reaped += 1
                    reap_fps.update(resp[1])
        if reap_fps:
            c._invalidate_presence(self.src, tuple(sorted(reap_fps)), "reap")
        self.report.tombstones_reaped += reaped
        return reaped

    # ------------------------------------------------------- phase 5: GC
    def collect_garbage(self, rounds: int = 2) -> int:
        """Reclaim what the audit tombstoned (pre-aged: collected on the
        first sweep) plus ordinary aged garbage, to a fixed point."""
        c = self.cluster
        removed = sum(len(fps) for fps in c.run_gc().values())
        threshold = max(
            (n.gc.threshold for n in c.nodes.values()), default=10
        )
        for _ in range(rounds):
            c.tick(threshold + 1)
            removed += sum(len(fps) for fps in c.run_gc().values())
        self.report.gc_removed += removed
        return removed

    # ------------------------------------------------------------ full run
    def run(self) -> RecoveryReport:
        self.repair_omap()
        self.collect_digests()
        self.repair_chunks()
        self.audit_refcounts()
        self.reap_tombstones()
        self.collect_garbage()
        return self.report


@dataclass
class RepairDaemon:
    """Always-on incremental repair: runs epoch-scoped recovery rounds
    concurrently with live traffic instead of waiting for an operator's
    post-mortem ``recover()``.

    Each ``step()`` starts a round at the current sim time and scopes it
    two ways: digests cover only placement groups dirtied at or after the
    LAST COMPLETED round's start (``since_epoch`` — the dirty trackers
    make clean groups free), and the refcount audit defers fingerprints
    mutated at or after THIS round's start (``exclude_after`` — in-flight
    transactions are never misjudged). GC runs one un-forced sweep per
    step — aging happens on the cluster's own clock, the daemon doesn't
    fast-forward time the way the post-mortem path does.

    The epoch floor only advances when a round heard every node: a round
    with lost probes repairs what it can but the next round re-covers the
    same window, so missed dirt cannot slip between rounds."""

    cluster: object
    last_completed: int = 0
    rounds_run: int = 0
    reports: list = field(default_factory=list)

    def step(self) -> RecoveryReport:
        c = self.cluster
        start = c.now
        r = RecoveryRound(c, since_epoch=self.last_completed, exclude_after=start)
        r.repair_omap()
        r.collect_digests()
        r.repair_chunks()
        r.audit_refcounts()
        r.reap_tombstones()
        removed = sum(len(fps) for fps in c.run_gc().values())
        r.report.gc_removed += removed
        if r.report.unreachable == 0:
            self.last_completed = start
        self.rounds_run += 1
        self.reports.append(r.report)
        return r.report

    def actor(self, interval: int):
        """This daemon as a discrete-event actor: one ``step()`` per
        ``interval`` ticks, forever. Register on a Scheduler with
        ``sched.spawn(daemon.actor(50), name="repair")`` — or use
        ``sched.every(interval, daemon.step, name="repair")``, which is
        the same shape; this helper exists so the daemon's cadence can
        live with the daemon. Repair rounds then interleave with live
        client sessions on the shared event heap (docs/concurrency.md)
        instead of running only when a test harness remembers to call
        ``step()`` between its own operations."""
        while True:
            self.step()
            yield interval


def run_recovery(cluster) -> RecoveryReport:
    """Full post-failure reconciliation round (the split-brain heal path):
    OMAP repair -> digest-diff chunk repair -> cluster-wide refcount audit
    -> tombstone reap -> GC."""
    return RecoveryRound(cluster).run()


def repair_round(cluster) -> int:
    """Digest-driven re-replication repair (the ``scrub`` contract):
    returns chunk byte copies restored."""
    r = RecoveryRound(cluster)
    r.collect_digests()
    return r.repair_chunks()


def rebalance(cluster) -> None:
    """Storage rebalance after a topology change (paper Fig 1b), driven
    per node: every node pushes its own misplaced chunks (with their CIT
    entries — content placement means metadata moves with content, never
    by location rewrite), stray tombstones, and OMAP entries to the new
    placement targets, as ``MigrateChunk`` / ``OmapPut(migrate=True)``
    unicasts. All reads are sender-local (a node reading its own disk and
    shard to build its outgoing messages).

    Loss discipline: the source RETAINS its local copy until at least one
    move is acked — a lossy policy that eats every ``MigrateChunk`` must
    not erase the last surviving copy (the old pop-first order destroyed
    data irrecoverably under replicas=1 + a drop policy). A retained
    off-placement copy is a stray holder: the digest repair round
    discovers it (strays join the group comparison) and re-ships it to
    the proper targets, and the next rebalance retries the move."""
    new_map = cluster.cmap
    for nid, node in list(cluster.nodes.items()):
        if not node.alive:
            continue
        # --- migrate chunks + their CIT entries --------------------------
        for fp in list(node.chunk_store.keys()):
            targets = place(fp, new_map)
            if nid in targets:
                continue
            data = node.chunk_store[fp]
            entry = node.shard.cit_lookup(fp)
            snap = entry.snapshot() if entry is not None else None
            moved = False
            delivered = False
            for t in targets:
                if not cluster.nodes[t].alive:
                    continue
                needs_bytes = fp not in cluster.nodes[t].chunk_store
                msg = MigrateChunk(fp, data if needs_bytes else None, snap)
                try:
                    cluster.transport.send(nid, t, msg, cluster.now)
                except (MessageDropped, NodeDown):
                    continue
                delivered = True
                if needs_bytes:
                    moved = True
            if not delivered:
                continue  # nothing acked: keep the local copy (stray holder)
            node.chunk_store.pop(fp)
            if entry is not None:
                node.shard.cit_remove(fp)
            if moved:
                cluster.stats.rebalance_chunks_moved += 1
                cluster.stats.rebalance_bytes_moved += len(data)
        # --- stray CIT entries without local bytes (tombstones) ---------
        for fp in list(node.shard.cit.keys()):
            targets = place(fp, new_map)
            if nid in targets:
                continue
            entry = node.shard.cit_lookup(fp)
            if entry is None:
                continue
            snap = entry.snapshot()
            delivered = False
            for t in targets:
                if not cluster.nodes[t].alive:
                    continue
                try:
                    cluster.transport.send(
                        nid, t, MigrateChunk(fp, None, snap), cluster.now
                    )
                except (MessageDropped, NodeDown):
                    continue
                delivered = True
            if delivered:
                node.shard.cit_remove(fp)
        # --- migrate OMAP entries by object-name hash --------------------
        for name in list(node.shard.omap.keys()):
            targets = place(name_fp(name), new_map)
            if nid in targets:
                continue
            e = node.shard.omap_get(name)
            assert e is not None
            delivered = False
            for t in targets:
                if not cluster.nodes[t].alive:
                    continue
                try:
                    cluster.transport.send(
                        nid, t, OmapPut(e, migrate=True), cluster.now
                    )
                except (MessageDropped, NodeDown):
                    continue
                delivered = True
            if delivered:
                node.shard.omap_delete(name)

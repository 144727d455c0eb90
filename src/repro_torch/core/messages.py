"""Typed wire messages between shared-nothing storage nodes.

Every cluster interaction — chunk writes, OMAP operations, refcount
releases, reads, rebalance moves — is a message sent through
``repro_torch.core.transport.Transport``. Each message computes its own wire
footprint so payload + control accounting lives in one place instead of
being hand-maintained at every call site:

    wire_bytes(dst, response) = CONTROL_MSG_BYTES            (header/ack)
                              + payload_bytes(dst, response) (request data)
                              + response_payload_bytes(response)

Accounting conventions (all preserved from the pre-transport model so the
benchmark trajectories stay comparable):

* chunk payload is free when the op *originates* on the destination — the
  primary already holds those bytes (``ChunkOp.origin``);
* with ``fp_first`` (beyond-paper probe-before-send), chunk bytes only
  travel for ops that were not dedup hits, which is knowable only after
  delivery — hence ``payload_bytes`` takes the response;
* OMAP commit records are control-only; *migrating* a stored OMAP entry
  during rebalance ships a CONTROL_MSG_BYTES-sized record (``migrate=True``);
* ``lookups()`` counts the CIT fingerprint lookups a message carries —
  the unicast-vs-broadcast currency of the paper's Fig 2 argument.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dmshard import CITEntry, OMAPEntry
from repro_torch.core.fingerprint import Fingerprint

CONTROL_MSG_BYTES = 64  # modeled size of a lookup/refcount message header
ACK_MSG_BYTES = 64      # modeled size of the per-delivery ack on the reverse edge

# Recovery digest wire model (docs/recovery.md): a summary digest costs a
# fixed record per placement group, detail listings cost a record per entry.
# Digest-diff recovery trades these small records against shipping (or
# omnisciently scanning) whole CIT/OMAP tables — the scalable-reconciliation
# argument of the disaster-recovery literature.
DIGEST_GROUP_BYTES = 16   # per-group summary record: (count, xor-of-hashes)
DIGEST_ENTRY_BYTES = 56   # per-fp detail record: fp + (has_bytes, refcount, flag, size, mtime)
RECIPE_REF_BYTES = 40     # per (chunk_fp, count) recipe-reference pair (audit)
OMAP_DIGEST_ENTRY_BYTES = 64  # per-name detail record: name hash + object fp + version + tombstone marker
TOMBSTONE_RECORD_BYTES = 24   # per aged-tombstone candidate: name hash + version + age
PRESENCE_FP_BYTES = 32        # per fingerprint in a presence-cache invalidation fan-out


class Message:
    """Base for all wire messages. Subclasses are frozen dataclasses."""

    TYPE: str = "message"

    def payload_bytes(self, dst: str, response=None) -> int:
        """Request payload crossing the wire toward ``dst``."""
        return 0

    def response_payload_bytes(self, response) -> int:
        """Response payload crossing the wire back to the sender."""
        return 0

    def lookups(self) -> int:
        """CIT fingerprint lookups carried by this message."""
        return 0

    def wire_bytes(self, dst: str, response=None) -> int:
        return (
            CONTROL_MSG_BYTES
            + self.payload_bytes(dst, response)
            + self.response_payload_bytes(response)
        )


@dataclass(frozen=True)
class ChunkOp:
    """One fingerprint-routed chunk operation inside a ChunkOpBatch.

    ``data is None`` is a *ref-only* op: the sender knows the bytes already
    exist on the destination (intra-batch duplicate or reference write) and
    asks only for a refcount increment — nothing but the fingerprint travels.
    ``origin`` is the OSS that produced the op (the object's primary): ops
    delivered to their own origin cost no network payload.

    ``presence=True`` marks a ref-only op asserted from a client presence
    cache: the sender holds positive (possibly stale) evidence the chunk
    already exists cluster-wide, so the op is a blind incref *record*
    rather than a fingerprint *query* — it is excluded from ``lookups()``
    (the probe-elision win). The receiver still validates locally and
    answers 'miss' when the evidence was stale; the sender then falls back
    to shipping the bytes, so stale presence degrades, never dangles.
    """

    fp: Fingerprint
    data: bytes | None = None
    origin: str = "client"
    presence: bool = False


@dataclass(frozen=True)
class ChunkOpBatch(Message):
    """One unicast carrying many chunk ops — possibly for many objects
    (cross-object coalescing: ``write_objects`` emits one of these per
    target node for the whole batch). Ops apply in order; the response is
    the per-op outcome list ('dedup_hit'|'repaired'|'restored'|'stored'|
    'miss')."""

    TYPE = "chunk_op_batch"
    ops: tuple[ChunkOp, ...] = ()
    txn: int = 0
    fp_first: bool = False  # beyond-paper: 64B probe first, bytes on miss only

    def payload_bytes(self, dst: str, response=None) -> int:
        total = 0
        outcomes = response if response is not None else [None] * len(self.ops)
        for op, outcome in zip(self.ops, outcomes):
            if op.data is None or op.origin == dst:
                continue
            if self.fp_first and outcome == "dedup_hit":
                continue  # probe hit: bytes never traveled
            total += len(op.data)
        return total

    def lookups(self) -> int:
        return sum(1 for op in self.ops if not op.presence)


@dataclass(frozen=True)
class OmapPut(Message):
    """Object-name-routed OMAP record write. A transaction commit record is
    modeled as control-only; ``migrate=True`` (rebalance) ships the stored
    entry as a CONTROL_MSG_BYTES record, as in the pre-transport model."""

    TYPE = "omap_put"
    entry: OMAPEntry = None  # type: ignore[assignment]
    migrate: bool = False

    def payload_bytes(self, dst: str, response=None) -> int:
        return CONTROL_MSG_BYTES if self.migrate else 0


@dataclass(frozen=True)
class OmapGet(Message):
    TYPE = "omap_get"
    name: str = ""


@dataclass(frozen=True)
class OmapDelete(Message):
    """Object-name-routed delete: commits a versioned TOMBSTONE record in
    place of the live entry (never a bare removal — a replica that missed
    the delete while unreachable would be indistinguishable from one that
    missed the put, and OMAP repair would resurrect the name). ``version``
    is the deleting transaction's cluster-monotonic id, the same authority
    currency as ``OMAPEntry.version``: a tombstone beats any stale live
    replica and a newer recreate beats the tombstone, by version, never by
    placement order. Control-only on the wire; the response is the live
    entry the tombstone replaced (cached in the seen-window so a
    conditional cancel can restore it)."""

    TYPE = "omap_delete"
    name: str = ""
    version: int = 0


@dataclass(frozen=True)
class TombstoneReap(Message):
    """GC-horizon reap (coordinator -> holder): physically remove the
    tombstone record for ``name`` iff the holder still has a tombstone at
    exactly ``version`` — a newer write or newer delete is left untouched.
    Sent only once the recovery round has proof the tombstone is FULLY
    ACKED (every live placement target listed it as aged past the GC
    horizon), so no stale live replica can remain that the tombstone still
    needs to beat. Control-only on the request wire; a successful reap's
    response carries the tombstone's retained chunk fingerprints (the
    deleted recipe, ``PRESENCE_FP_BYTES`` each) so the coordinator can fan
    out a last-chance ``PresenceInvalidate``."""

    TYPE = "tombstone_reap"
    name: str = ""
    version: int = 0

    def response_payload_bytes(self, response: object) -> int:
        if isinstance(response, tuple) and len(response) == 2:
            return PRESENCE_FP_BYTES * len(response[1])
        return 0


@dataclass(frozen=True)
class DecrefBatch(Message):
    """Batched refcount release (delete / transaction rollback): one unicast
    releasing many references on one node. A fingerprint may appear more
    than once (one decrement each). ``audit=True`` marks corrections emitted
    by the cluster-wide refcount audit: references the audit *proved*
    unreferenced by any OMAP recipe skip the GC aging wait (the audit's
    recipe walk IS the cross-match evidence aging normally buys)."""

    TYPE = "decref_batch"
    fps: tuple[Fingerprint, ...] = ()
    audit: bool = False


@dataclass(frozen=True)
class RefOnlyWrite(Message):
    """Reference-only write: increment refcounts for ``fps`` without moving
    data (checkpointer device-fp fast path). Each fp is a CIT lookup; the
    response is a per-fp 'ok'|'miss' tuple ('miss' = entry absent or
    invalid with no local bytes — the caller falls back to a full write)."""

    TYPE = "ref_only_write"
    fps: tuple[Fingerprint, ...] = ()

    def lookups(self) -> int:
        return len(self.fps)


@dataclass(frozen=True)
class ChunkRead(Message):
    """Fingerprint-routed chunk fetch; the chunk bytes come back in the
    response."""

    TYPE = "chunk_read"
    fp: Fingerprint = None  # type: ignore[assignment]

    def response_payload_bytes(self, response) -> int:
        return len(response) if isinstance(response, (bytes, bytearray)) else 0


@dataclass(frozen=True)
class ChunkReadBatch(Message):
    """One unicast fetching many chunks from one node — possibly for many
    objects (the restore-side twin of ``ChunkOpBatch``'s cross-object
    coalescing: ``read_objects`` emits one of these per target node per
    wave, after eliding intra-batch duplicate fingerprints through its
    first-reader cache). Control-only on the request wire, like
    ``ChunkRead``; the returned chunk bytes are charged as response
    payload via ``ChunkReadBatchReply.reply_bytes`` so payload parity
    with the serial shape holds exactly. Reads are content-addressed
    fetches, not CIT queries, so ``lookups()`` stays 0 — same as the
    serial read path."""

    TYPE = "chunk_read_batch"
    fps: tuple[Fingerprint, ...] = ()

    def response_payload_bytes(self, response) -> int:
        if isinstance(response, ChunkReadBatchReply):
            return response.reply_bytes()
        return 0


@dataclass(frozen=True)
class ChunkReadBatchReply(Message):
    """Per-fp outcome of a ``ChunkReadBatch``, parallel to the request's
    ``fps``: the chunk bytes on a hit, ``None`` on a miss (bytes absent —
    or corrupt — on this replica). Reporting misses per fp instead of
    raising lets one degraded chunk fail alone: the sender re-requests
    ONLY the misses from the next untried replica in a follow-up batch
    (``ClusterStats.read_fallback_rounds``) while the hits are kept.
    Wire cost is the hit bytes; misses ride the control header for free."""

    TYPE = "chunk_read_batch_reply"
    chunks: tuple = ()  # tuple[bytes | None, ...] parallel to request fps

    def reply_bytes(self) -> int:
        return sum(len(b) for b in self.chunks if b is not None)


@dataclass(frozen=True)
class MigrateChunk(Message):
    """Rebalance/scrub move: chunk bytes (``data``; None when the
    destination already holds them) plus the CIT entry snapshot that travels
    with its chunk — the paper's 'metadata moves with content' property."""

    TYPE = "migrate_chunk"
    fp: Fingerprint = None  # type: ignore[assignment]
    data: bytes | None = None
    cit: CITEntry | None = None

    def payload_bytes(self, dst: str, response=None) -> int:
        return len(self.data) if self.data is not None else 0


@dataclass(frozen=True)
class DigestRequest(Message):
    """Recovery digest probe (coordinator -> node). The node summarizes its
    OWN holdings — it never answers for anyone else — and the reply rides
    the ack like every response.

    ``kind``:
      * ``"chunks"``  — per-placement-group (count, xor-hash) summary of the
        node's chunk/CIT holdings; with ``groups`` set, a per-fp detail
        listing for exactly those groups; with ``detail_all=True``, details
        for everything (the audit's actual-refcount source).
      * ``"omap"``    — the same two-level digest over OMAP entries, grouped
        by object-name placement.
      * ``"recipes"`` — aggregated chunk-reference counts from the recipes
        this node *owns* (it is the first LIVE name-hash target given
        ``live``) — the audit's expected-refcount source; each logical
        object is counted by exactly one owner.

    The cluster map travels with the request (versioned, tiny — modeled as
    control-only, like an OSDMap epoch share) so the node groups by the
    placement the coordinator is reconciling against.

    Incremental (epoch-scoped) digests: with ``since_epoch`` set, the node
    summarizes ONLY the placement groups its dirty-epoch tracker marked at
    or after that epoch (write/delete/rebalance traffic bumps a group's
    dirty epoch; a cluster-map change marks everything dirty) and reports
    how many clean groups it skipped — the always-on repair loop's way of
    re-digesting just the slice that changed since its last completed
    round. ``summary_only`` asks for exact (count, xor) summaries of the
    named ``groups`` with no per-entry detail: the coordinator's second
    probe to members that reported a group clean when some peer reported
    it dirty (an explicit empty summary is then distinguishable from
    "not probed")."""

    TYPE = "digest_request"
    kind: str = "chunks"
    cmap: object = None           # ClusterMap (placement the digest is keyed by)
    groups: tuple = ()            # () = summary; else detail for these groups
    detail_all: bool = False      # detail for every group (audit)
    live: tuple[str, ...] = ()    # live set for recipe ownership (kind="recipes")
    since_epoch: int | None = None  # incremental: summarize groups dirty since
    summary_only: bool = False    # with ``groups``: summaries, no detail

    def response_payload_bytes(self, response) -> int:
        if isinstance(response, DigestReply):
            return response.reply_bytes()
        return 0


@dataclass(frozen=True)
class DigestReply(Message):
    """A node's digest of its own holdings (the response riding a
    ``DigestRequest`` ack). ``groups`` maps placement-group key ->
    ``(count, xor_hash)``; ``entries`` carries detail records:

      * chunks detail: fp -> (has_bytes, has_cit, refcount, flag, size, mtime)
      * omap detail:   name -> (object_fp, version, deleted, deleted_at)
      * recipes:       fp -> reference count from owned recipes

    ``epoch`` is the node's serve time — the epoch the digest describes.
    With an incremental request (``since_epoch``), ``skipped_groups``
    counts the clean placement groups the node did NOT re-digest, and an
    omap summary reply additionally lists the node's aged tombstone
    candidates (``tombstones``: name -> (version, deleted_at), only those
    past the GC horizon) so the coordinator can reap fully-acked ones —
    O(aged tombstones) wire, never a table walk.

    Wire cost is per record (see the DIGEST_*/RECIPE_*/TOMBSTONE_*
    constants) — the whole point of digest-based reconciliation: summaries
    are O(groups), details are fetched only for groups that disagree."""

    TYPE = "digest_reply"
    kind: str = "chunks"
    groups: dict = None           # type: ignore[assignment]
    entries: dict = None          # type: ignore[assignment]
    epoch: int = 0                # node's serve time (the digest's epoch)
    skipped_groups: int = 0       # clean groups an incremental probe skipped
    tombstones: dict | None = None  # name -> (version, deleted_at), aged only

    def reply_bytes(self) -> int:
        total = DIGEST_GROUP_BYTES * len(self.groups or ())
        total += TOMBSTONE_RECORD_BYTES * len(self.tombstones or ())
        n = len(self.entries or ())
        if self.kind == "recipes":
            total += RECIPE_REF_BYTES * n
        elif self.kind == "omap":
            total += OMAP_DIGEST_ENTRY_BYTES * n
        else:
            total += DIGEST_ENTRY_BYTES * n
        return total


@dataclass(frozen=True)
class RepairChunk(Message):
    """Digest-diff repair move (holder -> target): chunk bytes (``data``;
    None for a metadata-only repair) and/or the CIT entry snapshot a target
    is missing. Unlike the rebalance ``MigrateChunk`` the snapshot here is
    reconstructed from wire-learned digest details, not read from a foreign
    shard. Receiver-side it is adopt-if-missing (idempotent) and rides the
    seen-window like every mutating message; the response reports what was
    actually adopted ('stored'|'present', 'cit_stored'|'cit_present'|'')."""

    TYPE = "repair_chunk"
    fp: Fingerprint = None  # type: ignore[assignment]
    data: bytes | None = None
    cit: CITEntry | None = None

    def payload_bytes(self, dst: str, response=None) -> int:
        return len(self.data) if self.data is not None else 0


@dataclass(frozen=True)
class RefAudit(Message):
    """Refcount-audit correction (coordinator -> CIT owner): for each
    ``(fp, expected_refcount)`` item the node raises a refcount that is
    BELOW what the cluster's recipes reference (a replica that missed
    increfs while unreachable) and repairs a stuck-INVALID flag when the
    recipes prove the chunk live and the bytes are present (the lost
    async-flip case). Excess references travel separately as audit-tagged
    ``DecrefBatch`` messages. Control-only on the wire; ``lookups()``
    counts the CIT probes carried."""

    TYPE = "ref_audit"
    items: tuple = ()             # ((fp, expected_refcount), ...)

    def lookups(self) -> int:
        return len(self.items)


@dataclass(frozen=True)
class TxnCancel(Message):
    """Conditional compensation for the at-least-once ambiguity window.

    When a sender exhausts its retry budget with ``maybe_applied`` — some
    attempt reached the receiver but no ack came back — it cannot tell
    "ack lost, op applied" from "op lost". ``TxnCancel`` resolves it AT the
    receiver: if ``ref_msg_id`` is in the receiver's seen-window the
    original message applied, so its effects are compensated (refcounts
    released per the cached per-op outcomes; the OMAP entry removed when
    ``omap_name`` is set). If it is NOT seen, the id is poisoned so a copy
    still in flight is discarded on arrival instead of resurrecting the
    cancelled transaction. Control-only on the wire.

    ``undelete=True`` cancels an unconfirmed ``OmapDelete`` instead of an
    unconfirmed commit: if the tombstone at exactly ``ref_version`` is
    still in place, the pre-delete entry (the delete's cached response)
    is restored — a newer write or newer delete is left untouched."""

    TYPE = "txn_cancel"
    ref_msg_id: int = 0
    fps: tuple[Fingerprint, ...] = ()
    omap_name: str | None = None
    undelete: bool = False
    ref_version: int = 0


@dataclass(frozen=True)
class PresenceInvalidate(Message):
    """Presence-cache invalidation fan-out (node/coordinator -> client
    session): the listed fingerprints may no longer exist cluster-wide, so
    any cached "exists" evidence for them must be dropped. Emitted on
    delete (the recipe's refs were released), on GC reclaim (the aged
    sweep physically removed chunks), and on tombstone reap (last-chance
    re-invalidation riding the reap proof). Delivery is best-effort on
    purpose: the handler is idempotent (dropping an fp twice is a no-op)
    and a LOST invalidation only leaves stale presence, which the
    receiver-side validation of presence-asserted ops already degrades to
    a fallback byte resend — correctness never rests on this message
    arriving. ``reason`` is one of 'delete'|'gc'|'reap' (stats only).
    Costs ``PRESENCE_FP_BYTES`` per fingerprint on the wire."""

    TYPE = "presence_invalidate"
    fps: tuple[Fingerprint, ...] = ()
    reason: str = "delete"

    def payload_bytes(self, dst: str, response=None) -> int:
        return PRESENCE_FP_BYTES * len(self.fps)


@dataclass(frozen=True)
class RawPut(Message):
    """Baseline-only store: raw bytes placed under a fingerprint with no
    CIT transaction (central-dedup data push, no-dedup object store)."""

    TYPE = "raw_put"
    fp: Fingerprint = None  # type: ignore[assignment]
    data: bytes = b""

    def payload_bytes(self, dst: str, response=None) -> int:
        return len(self.data)


MESSAGE_TYPES = (
    ChunkOpBatch,
    OmapPut,
    OmapGet,
    OmapDelete,
    TombstoneReap,
    DecrefBatch,
    RefOnlyWrite,
    ChunkRead,
    ChunkReadBatch,
    ChunkReadBatchReply,
    MigrateChunk,
    DigestRequest,
    DigestReply,
    RepairChunk,
    RefAudit,
    TxnCancel,
    PresenceInvalidate,
    RawPut,
)

"""Baselines the paper compares against.

* CentralDedupCluster — one deduplication metadata server: every fingerprint
  lookup and every chunking/fingerprinting operation funnels through it
  (paper Fig 4b/5a baseline). The central op counter is the contention model
  used by benchmarks/fig5a.
* DiskLocalDedupCluster — per-node (per-disk/BtrFS-style) dedup only: no
  cluster-wide duplicate detection (paper Table 2 baseline). Objects land by
  name hash; duplicates on different nodes are NOT found.
* NoDedupCluster — baseline storage system, straight-through writes
  (paper Fig 4a "Baseline Ceph").

All wire traffic goes through the same ``Transport`` as DedupCluster, so
``stats.net_bytes``/``stats.control_msgs`` are transport views here too.
Central-server *internal* work (CIT lookups against its own tables) is
deliberately NOT network traffic — it is the serialized bottleneck the
``central_ops`` counter models for fig5a.

The baselines model the *happy path* only: they use the default reliable
delivery policy and have no rollback/accounting for lost, delayed,
duplicated, or reordered messages. The message-failure surface
(drop/delay/partition/duplicate/reorder/ack_loss/chaos) and the
at-least-once retry machinery are DedupCluster features; constructing a
baseline over a non-reliable transport raises
``UnsupportedTransportPolicy`` instead of silently producing wrong stats
(every write path re-checks, so a policy swapped in after construction is
caught too).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.chunking import ChunkingSpec, chunk_object
from repro_torch.core.cluster import ClusterStats, ReadError, WriteError
from repro_torch.core.dmshard import OMAPEntry
from repro_torch.core.fingerprint import Fingerprint, name_fp, object_fp, sha256_fp
from repro_torch.core.messages import ChunkOp, ChunkOpBatch, ChunkRead, OmapPut, RawPut
from repro_torch.core.node import StorageNode
from repro_torch.core.placement import ClusterMap, place
from repro_torch.core.transport import Transport

__all__ = [
    "CentralDedupCluster",
    "DiskLocalDedupCluster",
    "NoDedupCluster",
    "ReadError",
    "UnsupportedTransportPolicy",
    "WriteError",
]


class UnsupportedTransportPolicy(RuntimeError):
    """A baseline was given a non-reliable delivery policy. Baselines model
    the happy path only — running them over a lossy transport would not
    fail loudly, it would quietly produce WRONG stats (no rollback, no
    retries, no idempotent receive paths). Use DedupCluster for any
    fault-injection study."""

    def __init__(self, cluster_kind: str, policy) -> None:
        kind = getattr(policy, "kind", None) or getattr(policy, "__name__", repr(policy))
        super().__init__(
            f"{cluster_kind} models reliable delivery only; delivery policy "
            f"{kind!r} is unsupported (drop/delay/partition/duplicate/reorder/"
            f"ack_loss/chaos and custom policies are DedupCluster features)"
        )


def _require_reliable(cluster) -> None:
    """Reject any policy not tagged as the built-in ``reliable()`` — a
    custom callable cannot be proven lossless, so it is rejected too."""
    policy = cluster.transport.policy
    if getattr(policy, "kind", None) != "reliable" or getattr(policy, "lossy", True):
        raise UnsupportedTransportPolicy(type(cluster).__name__, policy)
    if cluster.transport.retry_budget:
        raise UnsupportedTransportPolicy(type(cluster).__name__, policy)


def _init_transport_stats(cluster) -> None:
    """Shared lazy wiring for the baseline dataclasses: a Transport over the
    live nodes dict and the legacy stats facade on top of it. Rejects
    non-reliable transports up front — and the write/read paths re-check,
    catching a lossy policy swapped in after construction."""
    if cluster.transport is None:
        cluster.transport = Transport(handlers=cluster.nodes)
    _require_reliable(cluster)
    if cluster.stats is None:
        cluster.stats = ClusterStats(cluster.transport, cluster.nodes)


@dataclass
class CentralDedupCluster:
    """All dedup metadata + chunking/fingerprinting on ONE server."""

    cmap: ClusterMap
    chunking: ChunkingSpec = field(default_factory=ChunkingSpec)
    nodes: dict[str, StorageNode] = field(default_factory=dict)
    transport: Transport | None = None
    stats: ClusterStats | None = None
    now: int = 0
    # central metadata structures (the bottleneck)
    central_cit: dict[Fingerprint, tuple[int, str]] = field(default_factory=dict)  # fp -> (refcount, node)
    central_omap: dict[str, OMAPEntry] = field(default_factory=dict)
    central_ops: int = 0          # serialized ops through the central server
    central_cpu_bytes: int = 0    # bytes chunked+fingerprinted centrally

    def __post_init__(self) -> None:
        _init_transport_stats(self)

    @classmethod
    def create(cls, n_nodes: int, chunking: ChunkingSpec | None = None) -> "CentralDedupCluster":
        ids = tuple(f"oss{i}" for i in range(n_nodes))
        c = cls(cmap=ClusterMap(1, ids), chunking=(chunking or ChunkingSpec()).normalized())
        for nid in ids:
            c.nodes[nid] = StorageNode(nid)
        return c

    def write_object(self, name: str, data: bytes) -> Fingerprint:
        _require_reliable(self)
        self.stats.logical_bytes_written += len(data)
        # client -> central server (everything funnels through it)
        self.transport.client_transfer("central", len(data))
        self.central_cpu_bytes += len(data)
        chunks = chunk_object(data, self.chunking)
        fps = [sha256_fp(c) for c in chunks]
        for fp, chunk in zip(fps, chunks):
            self.central_ops += 1               # serialized CIT lookup
            hit = self.central_cit.get(fp)
            if hit is not None:
                rc, nid = hit
                self.central_cit[fp] = (rc + 1, nid)
                self.nodes[nid].stats.dedup_hits += 1
                continue
            nid = place(fp, self.cmap, 1)[0]
            # central -> storage node: raw data push, no CIT transaction
            self.transport.send("central", nid, RawPut(fp, chunk), self.now)
            self.central_cit[fp] = (1, nid)
        self.central_ops += 1                   # OMAP write
        self.central_omap[name] = OMAPEntry(name, object_fp(fps), fps, len(data))
        self.stats.writes_ok += 1
        return self.central_omap[name].object_fp

    def read_object(self, name: str) -> bytes:
        _require_reliable(self)
        self.central_ops += 1
        e = self.central_omap.get(name)
        if e is None:
            raise ReadError(name)
        out = []
        for fp in e.chunk_fps:
            self.central_ops += 1
            rc_nid = self.central_cit.get(fp)
            if rc_nid is None:
                raise ReadError(f"central CIT lost {fp}")
            out.append(self.transport.send("central", rc_nid[1], ChunkRead(fp), self.now))
        self.stats.reads_ok += 1
        return b"".join(out)

    def unique_bytes_stored(self) -> int:
        return sum(n.stored_bytes() for n in self.nodes.values())

    def space_savings(self) -> float:
        logical = self.stats.logical_bytes_written
        return 1.0 - self.unique_bytes_stored() / logical if logical else 0.0


@dataclass
class DiskLocalDedupCluster:
    """Per-node dedup only (paper Table 2 'Disk-based Dedup Approach')."""

    cmap: ClusterMap
    chunking: ChunkingSpec = field(default_factory=ChunkingSpec)
    nodes: dict[str, StorageNode] = field(default_factory=dict)
    transport: Transport | None = None
    stats: ClusterStats | None = None
    now: int = 0

    def __post_init__(self) -> None:
        _init_transport_stats(self)

    @classmethod
    def create(cls, n_nodes: int, chunking: ChunkingSpec | None = None) -> "DiskLocalDedupCluster":
        ids = tuple(f"oss{i}" for i in range(n_nodes))
        c = cls(cmap=ClusterMap(1, ids), chunking=(chunking or ChunkingSpec()).normalized())
        for nid in ids:
            c.nodes[nid] = StorageNode(nid)
        return c

    def write_object(self, name: str, data: bytes) -> Fingerprint:
        _require_reliable(self)
        self.stats.logical_bytes_written += len(data)
        nid = place(name_fp(name), self.cmap, 1)[0]   # object placed by name
        node = self.nodes[nid]
        self.transport.client_transfer(nid, len(data))
        chunks = chunk_object(data, self.chunking)
        fps = [sha256_fp(c) for c in chunks]
        # local dedup transaction: ops originate and apply on the same node
        ops = tuple(ChunkOp(fp, chunk, origin=nid) for fp, chunk in zip(fps, chunks))
        self.transport.send(nid, nid, ChunkOpBatch(ops, txn=0), self.now)
        # per-disk dedup has no async window: the flag update is part of the
        # local write, so flips drain synchronously.
        node.cm.drain(node.shard, self.now + node.cm.async_delay)
        self.transport.send(
            nid, nid, OmapPut(OMAPEntry(name, object_fp(fps), fps, len(data))), self.now
        )
        self.stats.writes_ok += 1
        return object_fp(fps)

    def read_object(self, name: str) -> bytes:
        _require_reliable(self)
        nid = place(name_fp(name), self.cmap, 1)[0]
        node = self.nodes[nid]
        e = node.shard.omap_get(name)
        if e is None:
            raise ReadError(name)
        data = b"".join(node.chunk_store[fp] for fp in e.chunk_fps)
        self.stats.reads_ok += 1
        return data

    def unique_bytes_stored(self) -> int:
        return sum(n.stored_bytes() for n in self.nodes.values())

    def space_savings(self) -> float:
        logical = self.stats.logical_bytes_written
        return 1.0 - self.unique_bytes_stored() / logical if logical else 0.0


@dataclass
class NoDedupCluster:
    """Baseline storage system without any deduplication (Fig 4a 'Baseline')."""

    cmap: ClusterMap
    nodes: dict[str, StorageNode] = field(default_factory=dict)
    transport: Transport | None = None
    stats: ClusterStats | None = None
    objects: dict[str, str] = field(default_factory=dict)  # name -> node

    def __post_init__(self) -> None:
        _init_transport_stats(self)

    @classmethod
    def create(cls, n_nodes: int) -> "NoDedupCluster":
        ids = tuple(f"oss{i}" for i in range(n_nodes))
        c = cls(cmap=ClusterMap(1, ids))
        for nid in ids:
            c.nodes[nid] = StorageNode(nid)
        return c

    def write_object(self, name: str, data: bytes) -> None:
        _require_reliable(self)
        self.stats.logical_bytes_written += len(data)
        nid = place(name_fp(name), self.cmap, 1)[0]
        # whole object travels client -> node as one raw store
        self.transport.send("client", nid, RawPut(name_fp(name), data), 0)
        self.stats.writes_ok += 1

    def read_object(self, name: str) -> bytes:
        _require_reliable(self)
        nid = place(name_fp(name), self.cmap, 1)[0]
        data = self.nodes[nid].chunk_store.get(name_fp(name))
        if data is None:
            raise ReadError(name)
        self.stats.reads_ok += 1
        return data

    def unique_bytes_stored(self) -> int:
        return sum(n.stored_bytes() for n in self.nodes.values())

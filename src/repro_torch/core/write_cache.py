"""Client-side write-back chunk cache and fingerprint presence cache.

Two bounded host-side structures, modeled on s3ql's ``block_cache``
(bounded dirty set, upload in waves, explicit flush/invalidation) and the
casstor ``existing_blocks`` distributed-set idea, that close ROADMAP open
item 2:

* ``WriteBackCache`` — the dirty-chunk staging buffer. ``write_objects``
  used to materialize every chunk for the whole batch up front (~2x batch
  bytes of peak host memory); the cache instead chunks + fingerprints
  lazily, emitting bounded *waves*: while wave k's ``ChunkOpBatch``es are
  on the wire, only wave k's chunks are resident, so a multi-GB ingest
  holds O(wave) not O(batch) host memory. ``peak_dirty_bytes`` records
  the high-water mark (a deterministic function of the workload).

* ``PresenceCache`` — a bounded LRU set of fingerprints the client has
  POSITIVE wire evidence for: every acked chunk op whose outcome proves
  the chunk stored cluster-wide ('stored'/'restored'/'dedup_hit'/
  'repaired') teaches the cache. A later write of the same content sends
  a presence-asserted ref-only op (``ChunkOp(presence=True)``): no chunk
  bytes travel and the op is excluded from the CIT-probe accounting
  (``ChunkOpBatch.lookups()``) — the probe-elision win on repeat-heavy
  traffic.

Safety argument (the part chaos policies must not break): presence is an
*optimization hint*, never an authority. The receiving CIT owner always
validates a presence-asserted op against its own shard and answers
``'miss'`` when the entry is gone or invalid without local bytes; the
writer then falls back to shipping the chunk bytes (``_write_wave``'s
fallback resend). So a stale cache — invalidation lost, delayed,
reordered, or duplicated — degrades to exactly the pre-cache probe path
and can never mint a dangling reference. ``PresenceInvalidate`` fan-outs
(on delete, GC reclaim, and tombstone reap) exist to keep the hit rate
honest, not to keep the cluster correct; see docs/write_cache.md.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

from repro_torch.core.chunking import ChunkingSpec, chunk_object
from repro_torch.core.fingerprint import Fingerprint, fingerprint_many

# Outcomes that prove a chunk is stored (bytes + CIT entry) on its owner —
# the only evidence the presence cache accepts. Batched restore hits
# (``ChunkReadBatchReply`` chunks) carry the same proof — the bytes were
# just served from their owner — so ``read_objects`` teaches sessions per
# acked hit through the same ``note()`` path.
PRESENCE_OUTCOMES = frozenset({"stored", "restored", "dedup_hit", "repaired"})


class PresenceCache:
    """Bounded LRU set of fingerprints with positive existence evidence.

    ``sink`` (optional) is any object with ``cache_hits`` /
    ``cache_misses`` / ``cache_evictions`` / ``cache_invalidations``
    integer attributes — in practice the cluster's ``ClusterStats`` — so
    per-session activity lands in the cluster-wide deterministic columns
    as it happens. The cache also keeps its own counters for standalone
    inspection."""

    def __init__(self, capacity: int, sink: object | None = None):
        if capacity <= 0:
            raise ValueError("PresenceCache capacity must be positive")
        self.capacity = capacity
        self.sink = sink
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._fps: OrderedDict[Fingerprint, None] = OrderedDict()

    def _bump(self, name: str, n: int = 1) -> None:
        if self.sink is not None:
            setattr(self.sink, name, getattr(self.sink, name) + n)

    def __len__(self) -> int:
        return len(self._fps)

    def __contains__(self, fp: Fingerprint) -> bool:
        return fp in self._fps

    def hit(self, fp: Fingerprint) -> bool:
        """Query for a write decision: True moves ``fp`` to MRU and counts
        a hit; False counts a miss (the op takes the ordinary probe path)."""
        if fp in self._fps:
            self._fps.move_to_end(fp)
            self.hits += 1
            self._bump("cache_hits")
            return True
        self.misses += 1
        self._bump("cache_misses")
        return False

    def note(self, fp: Fingerprint) -> None:
        """Record positive evidence (an acked storing outcome, or a
        batched read hit) for ``fp``; evicts the LRU entry beyond
        capacity."""
        if fp in self._fps:
            self._fps.move_to_end(fp)
            return
        self._fps[fp] = None
        while len(self._fps) > self.capacity:
            self._fps.popitem(last=False)
            self.evictions += 1
            self._bump("cache_evictions")

    def drop(self, fp: Fingerprint) -> bool:
        """Invalidate one fingerprint (idempotent)."""
        if self._fps.pop(fp, True) is None:
            self.invalidations += 1
            self._bump("cache_invalidations")
            return True
        return False

    def invalidate_many(self, fps: Iterable[Fingerprint]) -> int:
        """Apply a ``PresenceInvalidate`` fan-out; duplicates and unknown
        fingerprints are no-ops, so redelivery under chaos is harmless."""
        return sum(1 for fp in fps if self.drop(fp))

    def clear(self) -> None:
        self.invalidations += len(self._fps)
        self._bump("cache_invalidations", len(self._fps))
        self._fps.clear()


@dataclass
class WriteBackCache:
    """Bounded dirty-chunk staging buffer: turns an object batch into
    bounded, lazily prepared write waves.

    ``wave_bytes`` bounds the chunk bytes resident per wave (0 =
    unbounded, one wave per name-repeat segment — the legacy shape). A
    wave always admits at least one object, so a single object larger
    than the bound still writes (one-object wave); waves additionally
    split at a repeated object name, preserving ``write_objects``'s
    last-write-wins ordering guarantee. ``sink`` is the same stats object
    ``PresenceCache`` uses (``peak_dirty_bytes`` attribute)."""

    chunking: ChunkingSpec
    wave_bytes: int = 0
    sink: object | None = None
    dirty_bytes: int = 0
    peak_dirty_bytes: int = 0
    waves_emitted: int = 0

    def _note_dirty(self, nbytes: int) -> None:
        self.dirty_bytes += nbytes
        if self.dirty_bytes > self.peak_dirty_bytes:
            self.peak_dirty_bytes = self.dirty_bytes
            if self.sink is not None and self.dirty_bytes > getattr(
                self.sink, "peak_dirty_bytes", 0
            ):
                self.sink.peak_dirty_bytes = self.dirty_bytes

    def release(self) -> None:
        """Wave handed to the transport and committed: its chunks are no
        longer resident."""
        self.dirty_bytes = 0

    def prepare(self, name: str, data: bytes) -> tuple:
        """Chunk + fingerprint one object into the dirty set."""
        chunks = chunk_object(data, self.chunking)
        self._note_dirty(sum(len(c) for c in chunks))
        fps = fingerprint_many(chunks)
        return (name, data, chunks, fps)

    def _prepare_wave(self, wave: list[tuple[str, bytes]]) -> list[tuple]:
        """Chunk every object of one wave, then fingerprint the wave's
        chunks in ONE vectorized pass (the legacy whole-batch shape, at
        wave granularity)."""
        prepped = [
            (name, data, chunk_object(data, self.chunking))
            for name, data in wave
        ]
        for _, _, chunks in prepped:
            self._note_dirty(sum(len(c) for c in chunks))
        all_fps = fingerprint_many(
            [c for _, _, chunks in prepped for c in chunks]
        )
        out: list[tuple] = []
        off = 0
        for name, data, chunks in prepped:
            out.append((name, data, chunks, all_fps[off : off + len(chunks)]))
            off += len(chunks)
        self.waves_emitted += 1
        return out

    def waves(
        self, items: Iterable[tuple[str, bytes]]
    ) -> Iterator[list[tuple]]:
        """Lazily yield bounded, prepared write waves. Chunking +
        fingerprinting for wave k+1 happen only after wave k was yielded
        (and its dirty bytes released), which is the streaming-overlap
        seam: wave k is on the wire while k+1 is being chunked. Chunking
        is lossless, so an object's chunk bytes equal its data bytes and
        the bound can be checked before chunking.

        ``DedupClient.put_wave_actor`` drives this generator from the
        discrete-event Scheduler: resuming it chunks wave k+1 while wave
        k's sends are still uncommitted (``stats.waves_overlapped``),
        and the synchronous ``put_many`` path consumes it eagerly — the
        two orders are message-identical because chunking emits no
        messages (docs/concurrency.md)."""
        wave: list[tuple[str, bytes]] = []
        names_in_wave: set[str] = set()
        pending = 0
        for name, data in items:
            full = (
                self.wave_bytes > 0
                and wave
                and pending + len(data) > self.wave_bytes
            )
            if full or name in names_in_wave:
                yield self._prepare_wave(wave)
                self.release()
                wave, names_in_wave, pending = [], set(), 0
            wave.append((name, data))
            names_in_wave.add(name)
            pending += len(data)
        if wave:
            yield self._prepare_wave(wave)
            self.release()


@dataclass
class PendingWrites:
    """The write-back buffer behind ``DedupClient.put``: objects accepted
    but not yet written. ``flush_threshold`` (0 = never) auto-flushes via
    ``on_flush`` once the buffered object bytes reach the bound — the
    s3ql dirty-set discipline at object granularity."""

    flush_threshold: int = 0
    on_flush: Callable[[list[tuple[str, bytes]]], None] | None = None
    items: list[tuple[str, bytes]] = field(default_factory=list)
    buffered_bytes: int = 0

    def add(self, name: str, data: bytes) -> None:
        self.items.append((name, data))
        self.buffered_bytes += len(data)
        if (
            self.flush_threshold > 0
            and self.buffered_bytes >= self.flush_threshold
            and self.on_flush is not None
        ):
            self.on_flush(self.drain())

    def drain(self) -> list[tuple[str, bytes]]:
        items, self.items = self.items, []
        self.buffered_bytes = 0
        return items

    def __len__(self) -> int:
        return len(self.items)

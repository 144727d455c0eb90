"""Cluster-wide KV prefix-cache deduplication.

Prefix caching *is* the paper's technique applied to serving state: a KV
block's identity is the chain fingerprint of its token content and every
token before it (chain_fp), so identical prefixes — across requests AND
across serving replicas — map to the same block fingerprint, are placed on
the same node of the shared-nothing block store, refcounted in a CIT and
garbage-collected through commit-flag tombstones. There is no per-block
location table: placement is a pure function of the fingerprint (the
paper's rebalancing-for-free argument, here for elastic serving pools).

A copy of the JAX package's ``serving/kv_dedup.py`` over ``repro_torch.core``
(it never used JAX).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core import DedupCluster, Fingerprint, chain_fp, ReadError


@dataclasses.dataclass
class PrefixCacheStats:
    block_hits: int = 0
    block_misses: int = 0
    tokens_reused: int = 0
    tokens_computed: int = 0

    @property
    def hit_rate(self) -> float:
        t = self.block_hits + self.block_misses
        return self.block_hits / t if t else 0.0


def _token_block_fp(prev: Fingerprint | None, tokens: tuple[int, ...]) -> Fingerprint:
    raw = hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).digest()[:16]
    return chain_fp(prev, Fingerprint("sha256", raw))


class KVBlockCache:
    """Content-addressed KV block store over a shared-nothing DedupCluster.

    Blocks are `block_tokens` tokens wide; the stored payload is the
    serialized per-layer KV slice for those positions.
    """

    def __init__(self, cluster: DedupCluster, block_tokens: int = 16):
        self.cluster = cluster
        self.block_tokens = block_tokens
        self.stats = PrefixCacheStats()
        self._pins: dict[Fingerprint, int] = {}   # live-request pins
        self._lru: list[Fingerprint] = []         # eviction order (oldest first)

    def block_fps(self, tokens: list[int]) -> list[Fingerprint]:
        """Chain fingerprints for every complete block of this prompt."""
        out: list[Fingerprint] = []
        prev: Fingerprint | None = None
        bt = self.block_tokens
        for i in range(0, len(tokens) - len(tokens) % bt, bt):
            fp = _token_block_fp(prev, tuple(tokens[i : i + bt]))
            out.append(fp)
            prev = fp
        return out

    def match_prefix(self, tokens: list[int]) -> tuple[int, list[Fingerprint]]:
        """Longest cached prefix. Matched blocks are pinned for the request.
        Returns (n_cached_tokens, matched fps)."""
        fps = self.block_fps(tokens)
        matched: list[Fingerprint] = []
        for fp in fps:
            if self._lookup(fp):
                matched.append(fp)
                self.stats.block_hits += 1
            else:
                self.stats.block_misses += 1
                break
        for fp in matched:
            self._pin(fp)
        self.stats.tokens_reused += len(matched) * self.block_tokens
        return len(matched) * self.block_tokens, matched

    def _pin(self, fp: Fingerprint) -> None:
        self._pins[fp] = self._pins.get(fp, 0) + 1
        if fp in self._lru:
            self._lru.remove(fp)
        self._lru.append(fp)

    def _lookup(self, fp: Fingerprint) -> bool:
        name = f"kv/{fp.hex}"
        for t in self.cluster.omap_targets(name):
            node = self.cluster.nodes[t]
            if node.alive and node.shard.omap_get(name) is not None:
                return True
        return False

    def put_blocks(self, fps: list[Fingerprint], payloads: list[bytes]) -> None:
        """Idempotent (a concurrent identical put dedups to a no-op) and
        best-effort: publication failures (dead OMAP target, mid-write node
        loss) degrade to an uncached block, never to a request failure."""
        from repro_torch.core import WriteError

        for fp, payload in zip(fps, payloads):
            try:
                self.cluster.write_object(f"kv/{fp.hex}", payload)
                self._pin(fp)
            except WriteError:
                continue
        self.stats.tokens_computed += len(fps) * self.block_tokens

    def get_block(self, fp: Fingerprint) -> bytes:
        return self.cluster.read_object(f"kv/{fp.hex}")

    def release_blocks(self, fps: list[Fingerprint]) -> None:
        """Request finished: unpin. Blocks STAY cached for future prefix hits
        until evicted (that is the point of a prefix cache)."""
        for fp in fps:
            if fp in self._pins:
                self._pins[fp] -= 1
                if self._pins[fp] <= 0:
                    del self._pins[fp]

    def evict(self, max_blocks: int) -> int:
        """LRU-evict unpinned blocks down to max_blocks. Deleting the object
        drops chunk refcounts to 0 -> commit-flag tombstone -> the paper's GC
        reclaims the bytes (or a re-reference before GC repairs the entry)."""
        evicted = 0
        while len(self._lru) > max_blocks:
            victim = next((fp for fp in self._lru if fp not in self._pins), None)
            if victim is None:
                break
            self._lru.remove(victim)
            self.cluster.delete_object(f"kv/{victim.hex}")
            evicted += 1
        return evicted

"""Data pipelines.

* SyntheticLMData — deterministic token batches for training (host-sharded
  in real deployments; here a single-process generator with per-step seeds,
  so every data-parallel worker derives its shard from (step, worker_id)
  without coordination — the shared-nothing property again).
* make_dedup_objects — FIO-style object workload with a controlled dedup
  percentage, used by the paper-reproduction benchmarks (Fig 4b, 5a, Tab 2).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        toks = rng.integers(0, self.vocab, size=(self.global_batch, self.seq_len + 1), dtype=np.int64)
        # learnable structure: half the positions follow next = prev + 1
        # (mod vocab) — a strong local rule any LM can pick up in tens of steps
        rep = rng.random((self.global_batch, self.seq_len + 1)) < 0.5
        succ = (toks[:, :-1] + 1) % self.vocab
        toks[:, 1:][rep[:, 1:]] = succ[rep[:, 1:]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def host_shard(self, step: int, worker: int, n_workers: int) -> dict[str, np.ndarray]:
        b = self.batch(step)
        per = self.global_batch // n_workers
        sl = slice(worker * per, (worker + 1) * per)
        return {k: v[sl] for k, v in b.items()}


@dataclasses.dataclass(frozen=True)
class DedupWorkload:
    """FIO `dedupe_percentage`-style: each object is composed of blocks; a
    `dedup_pct` fraction of blocks is drawn from a small shared pool."""

    object_size: int
    n_objects: int
    dedup_pct: float        # 0..100, fraction of duplicate blocks
    block_size: int = 4096
    pool_blocks: int = 64
    seed: int = 0


def make_dedup_objects(w: DedupWorkload) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(w.seed)
    pool = [rng.bytes(w.block_size) for _ in range(w.pool_blocks)]
    objs: list[tuple[str, bytes]] = []
    blocks_per_obj = max(1, w.object_size // w.block_size)
    for i in range(w.n_objects):
        parts = []
        for _ in range(blocks_per_obj):
            if rng.random() * 100.0 < w.dedup_pct:
                parts.append(pool[rng.integers(0, w.pool_blocks)])
            else:
                parts.append(rng.bytes(w.block_size))
        data = b"".join(parts)[: w.object_size]
        name = f"obj-{w.seed}-{i}-{hashlib.md5(data[:64]).hexdigest()[:8]}"
        objs.append((name, data))
    return objs

"""Content-fingerprint-based placement (CRUSH-lite).

The paper feeds the chunk's SHA-1 fingerprint into CRUSH so that the
fingerprint *alone* (plus the current cluster map) determines which storage
server holds the chunk and its CIT entry. We implement the same contract with
weighted rendezvous (HRW) hashing:

* pure function of (fingerprint, cluster_map)  -> no location metadata, ever;
* minimal movement on topology change          -> only ~1/N of chunks move;
* weight-aware                                 -> heterogeneous nodes;
* replica sets = top-K rendezvous winners      -> fault tolerance.

The cluster map is versioned (epoch) like Ceph's OSDMap, which is what makes
elastic scaling a metadata no-op for dedup (§2 of the paper / DESIGN.md §2).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

from repro_torch.core.fingerprint import Fingerprint


@dataclass(frozen=True)
class ClusterMap:
    """Versioned shared-nothing cluster topology."""

    epoch: int
    nodes: tuple[str, ...]                       # node ids, "up" set
    weights: dict[str, float] = field(default_factory=dict)
    replicas: int = 1

    def weight(self, node: str) -> float:
        return self.weights.get(node, 1.0)

    def with_node(self, node: str, weight: float = 1.0) -> "ClusterMap":
        if node in self.nodes:
            raise ValueError(f"node {node} already in map")
        return ClusterMap(
            self.epoch + 1,
            self.nodes + (node,),
            {**self.weights, node: weight},
            self.replicas,
        )

    def without_node(self, node: str) -> "ClusterMap":
        if node not in self.nodes:
            raise ValueError(f"node {node} not in map")
        w = dict(self.weights)
        w.pop(node, None)
        return ClusterMap(
            self.epoch + 1,
            tuple(n for n in self.nodes if n != node),
            w,
            self.replicas,
        )

    def with_replicas(self, replicas: int) -> "ClusterMap":
        return replace(self, epoch=self.epoch + 1, replicas=replicas)


def _score(fp: Fingerprint, node: str) -> float:
    """Rendezvous score in (0,1], stable across runs (no PYTHONHASHSEED)."""
    h = hashlib.blake2s(digest_size=8)
    h.update(fp.namespace.encode())
    h.update(fp.value)
    h.update(node.encode())
    u = int.from_bytes(h.digest(), "big")
    return (u + 1) / float(1 << 64)


def place(fp: Fingerprint, cmap: ClusterMap, k: int | None = None) -> list[str]:
    """Top-k weighted-rendezvous winners for this fingerprint.

    Weighted HRW: score_n = -w_n / ln(u_n); highest wins. Equivalent to
    straw2's logarithmic straw lengths.
    """
    import math

    if not cmap.nodes:
        raise RuntimeError("empty cluster map")
    k = k or cmap.replicas
    scored = []
    for n in cmap.nodes:
        u = _score(fp, n)
        w = cmap.weight(n)
        if w <= 0:
            continue
        scored.append((-w / math.log(u) if u < 1.0 else float("inf"), n))
    scored.sort(key=lambda t: (-t[0], t[1]))
    return [n for _, n in scored[: max(1, k)]]


def primary(fp: Fingerprint, cmap: ClusterMap) -> str:
    return place(fp, cmap, 1)[0]

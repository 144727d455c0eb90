"""Content fingerprinting for the dedup substrate.

Two namespaces, never mixed (DESIGN.md §6.2):

* ``sha256_fp``   — host path. Canonical storage-cluster fingerprint of raw
  chunk bytes. 128-bit truncation of SHA-256 (the paper uses SHA-1; we keep
  the same 160->128-ish "content name" role with a non-broken hash).
* device fingerprints — produced by ``repro_torch.kernels.ops.fingerprint_chunks``
  (the CUDA kernel on the card, plain torch on the CPU). Used to dedup *on-device tensors* (checkpoint
  chunks, KV blocks) without pulling bytes to the host first.

A fingerprint is an opaque ``Fingerprint`` (hashable, orderable) carrying the
namespace tag so the two can never collide in one CIT.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable

FP_BITS = 128
FP_BYTES = FP_BITS // 8


@dataclass(frozen=True, order=True)
class Fingerprint:
    """128-bit content fingerprint, namespaced by its producer."""

    namespace: str  # "sha256" | "device" | "name"
    value: bytes    # exactly FP_BYTES

    def __post_init__(self) -> None:
        if len(self.value) != FP_BYTES:
            raise ValueError(f"fingerprint must be {FP_BYTES} bytes, got {len(self.value)}")

    @property
    def hex(self) -> str:
        return self.value.hex()

    def short(self) -> str:
        return f"{self.namespace}:{self.value[:6].hex()}"

    def as_int(self) -> int:
        return int.from_bytes(self.value, "big")

    def __repr__(self) -> str:  # compact in logs
        return f"fp({self.short()})"


def sha256_fp(data: bytes) -> Fingerprint:
    """Canonical chunk-content fingerprint (host storage path)."""
    return Fingerprint("sha256", hashlib.sha256(data).digest()[:FP_BYTES])


def fingerprint_many(chunks: Iterable[bytes]) -> list[Fingerprint]:
    """Batch fingerprinting: hash every chunk (of one object or of a whole
    write batch) in one pass. Results are exactly ``[sha256_fp(c) for c in
    chunks]``; batching keeps the hot write path to a single call site and
    lets the device path (``repro_torch.kernels.ops.fingerprint_tensor_chunks_many``)
    swap in without touching callers."""
    sha = hashlib.sha256
    nb = FP_BYTES
    return [Fingerprint("sha256", sha(c).digest()[:nb]) for c in chunks]


def name_fp(name: str) -> Fingerprint:
    """Object-name fingerprint — locates the primary OSS for an object
    (the paper's 'client performs object name hashing')."""
    return Fingerprint("name", hashlib.sha256(name.encode("utf-8")).digest()[:FP_BYTES])


def device_fp(words: Iterable[int]) -> Fingerprint:
    """Wrap the 4 uint32 lanes produced by the device fingerprint kernel."""
    ws = list(words)
    if len(ws) != 4:
        raise ValueError(f"device fingerprint needs 4 u32 words, got {len(ws)}")
    raw = b"".join(int(w & 0xFFFFFFFF).to_bytes(4, "big") for w in ws)
    return Fingerprint("device", raw)


def chain_fp(parent: Fingerprint | None, child: Fingerprint) -> Fingerprint:
    """Chained fingerprint: fp(prefix chain + block). Used for KV prefix-cache
    block identity (a block's identity includes everything before it)."""
    h = hashlib.sha256()
    if parent is not None:
        h.update(parent.namespace.encode())
        h.update(parent.value)
    h.update(child.namespace.encode())
    h.update(child.value)
    return Fingerprint("chain", h.digest()[:FP_BYTES])


def object_fp(chunk_fps: list[Fingerprint]) -> Fingerprint:
    """Whole-object fingerprint = hash over the ordered chunk fingerprints
    (the paper's OMAP 'object fingerprint')."""
    h = hashlib.sha256()
    for fp in chunk_fps:
        h.update(fp.namespace.encode())
        h.update(fp.value)
    return Fingerprint("sha256", h.digest()[:FP_BYTES])

"""Object chunking — host path.

The paper splits every object into small *fixed-size* chunks on the primary
OSS (512 KB default in the evaluation). We additionally provide windowed
content-defined chunking (CDC) whose boundary rule matches the CUDA CDC
kernel in ``repro_torch.kernels.cdc`` (boundary at i iff gear-window-hash(i) &
mask == 0), so host and device agree on boundaries.

The host CDC is numpy-vectorized: one 256-entry gear-table gather turns the
byte stream into uint32 table values, then the W=32 window hashes for *all*
positions are built with log2(W)=5 shifted adds (doubling: a window of 2m is
a window of m plus the previous window of m shifted left by m) — the same
formulation the device kernels compute, so results are bit-identical to the
scalar ``window_hash_at`` reference at every position. Boundary selection
(min/max-size enforcement) then walks only the candidate positions where
``hash & mask == 0``, so the per-chunk loop is O(#chunks), not O(#bytes).
``chunk_cdc_scalar`` keeps the original byte-at-a-time implementation as the
reference oracle for tests. ``window_hashes(backend="kernel")`` routes the
hash computation through ``repro_torch.kernels.ops`` (the CUDA kernel for a
CUDA tensor, the plain torch version for a CPU one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

DEFAULT_CHUNK_SIZE = 512 * 1024

# --- windowed gear hash (must match kernels/ref.py::cdc_window_hash) --------
_GEAR_MULT = 0x9E3779B1          # 32-bit golden-ratio multiplier
_WINDOW = 32                     # bytes of context per boundary decision


def _gear_table() -> list[int]:
    # Deterministic pseudo-random byte->u32 table (splitmix-ish), no RNG dep.
    tbl = []
    x = 0x243F6A88
    for _ in range(256):
        x = (x + 0x9E3779B9) & 0xFFFFFFFF
        z = x
        z = ((z ^ (z >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
        z = ((z ^ (z >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
        z = z ^ (z >> 16)
        tbl.append(z)
    return tbl


GEAR_TABLE = _gear_table()
_GEAR_NP = np.array(GEAR_TABLE, dtype=np.uint32)


def window_hash_at(data: bytes, i: int) -> int:
    """Gear hash of the W bytes ending at (and including) position i.
    Depends on at most _WINDOW bytes of context => parallelizable.

    Scalar reference; the vectorized path is ``window_hashes``."""
    h = 0
    lo = max(0, i - _WINDOW + 1)
    for b in data[lo : i + 1]:
        h = ((h << 1) + GEAR_TABLE[b]) & 0xFFFFFFFF
    return h


def window_hashes(
    data: bytes, *, backend: str = "numpy", device: "str | None" = None
) -> np.ndarray:
    """Vectorized ``window_hash_at`` for every position of ``data`` at once.

    Returns (len(data),) uint32. Positions i < W-1 use the short prefix
    window, exactly like the scalar reference and the kernel oracle.

    backend:
      * "numpy"  — host doubling scheme (default, no torch dependency)
      * "kernel" — route through ``repro_torch.kernels.ops.cdc_window_hashes``
                   on ``device`` (bit-identical)
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return np.zeros(0, dtype=np.uint32)
    if backend == "kernel":
        import torch

        from repro_torch.kernels import ops as kops

        t = torch.from_numpy(buf.copy()).to(kops.resolve_device(device))
        return kops.cdc_window_hashes(t).cpu().numpy()
    if backend != "numpy":
        raise ValueError(f"unknown window-hash backend {backend!r}")
    # Doubling: H_m[i] = gear hash of the (up to) m bytes ending at i.
    # H_{2m}[i] = H_m[i] + (H_m[i-m] << m), with H_m[j] = 0 for j < 0.
    h = _GEAR_NP[buf]
    tmp = np.empty_like(h)
    m = 1
    while m < _WINDOW:
        np.left_shift(h[:-m], np.uint32(m), out=tmp[m:])
        np.add(h[m:], tmp[m:], out=h[m:])
        m <<= 1
    return h


def cdc_mask(chunk_size: int) -> int:
    """Boundary mask targeting ~chunk_size average chunks."""
    return (1 << max(1, chunk_size.bit_length() - 1)) - 1


# Tile for the fused hash+candidate scan: big enough to amortize numpy call
# overhead, small enough that the per-tile uint32 arrays stay cache-resident
# (the untiled scan streams ~20 stream-sized arrays through DRAM and is
# 2-3x slower).
_SCAN_TILE = 64 * 1024


def _mask_window(mask: int) -> int:
    """Effective doubling-window for the boundary test ``hash & mask == 0``.

    The gear window hash is H_w[i] = sum_j table[b(i-j)] << j (mod 2^32), so
    a byte j positions back only influences bits >= j. For a scalar mask
    2^L - 1 the test reads only the low L bits, which are fixed once the
    doubling scheme reaches a window of size >= L — levels beyond that
    cannot change any masked bit. Masks wider than 16 bits need the next
    power of two (32), i.e. the full window: no savings."""
    L = mask.bit_length()
    if L > 16 or mask != (1 << L) - 1:
        return _WINDOW
    w = 1
    while w < L:
        w <<= 1
    return w


def _cdc_candidates(
    data: bytes, mask: int, *, backend: str = "numpy", device: "str | None" = None
) -> np.ndarray:
    """Positions i with window_hash(i) & mask == 0, as a sorted int array.

    The numpy path fuses the gear gather, the doubling scheme and the mask
    test tile-by-tile so intermediates never leave cache; only the (sparse)
    candidate indices are materialized. For scalar masks 2^L - 1 with
    L <= 16 the doubling scheme stops early (``_mask_window``) — identical
    candidates in fewer passes."""
    if backend != "numpy":
        h = window_hashes(data, backend=backend, device=device)
        return np.flatnonzero((h & np.uint32(mask)) == 0)
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    m32 = np.uint32(mask)
    w_eff = _mask_window(mask)
    halo = w_eff - 1
    hbuf = np.empty(_SCAN_TILE + halo, dtype=np.uint32)
    tmp = np.empty(_SCAN_TILE + halo, dtype=np.uint32)
    out: list[np.ndarray] = []
    for start in range(0, n, _SCAN_TILE):
        lo = max(0, start - halo)
        k = min(start + _SCAN_TILE, n) - lo
        h = hbuf[:k]
        np.take(_GEAR_NP, buf[lo : lo + k], out=h)
        m = 1
        while m < w_eff:
            np.left_shift(h[:-m], np.uint32(m), out=tmp[m:k])
            np.add(h[m:], tmp[m:k], out=h[m:])
            m <<= 1
        cand = np.flatnonzero((h[start - lo :] & m32) == 0)
        if cand.size:
            out.append(cand + start)
    if not out:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(out)


def _cdc_cuts(cand: np.ndarray, n: int, min_size: int, max_size: int) -> list[int]:
    """Boundary selection over precomputed candidate positions.

    Returns the inclusive end index of every chunk except the implicit tail.
    Walks only candidate positions (hash & mask == 0) plus max-size forced
    cuts — bit-identical to the scalar ``chunk_cdc_scalar`` loop."""
    cuts: list[int] = []
    start = 0
    while True:
        lo = start + min_size
        if lo >= n:
            break
        # The scalar loop first checks positions from lo upward; the max-size
        # condition (i - start + 1 >= max_size) fires no earlier than lo.
        hard = max(lo, start + max_size - 1)
        j = int(np.searchsorted(cand, lo))
        cut = hard
        if j < cand.size and int(cand[j]) <= hard:
            cut = int(cand[j])
        if cut >= n:
            break
        cuts.append(cut)
        start = cut + 1
    return cuts


@dataclass(frozen=True)
class ChunkingSpec:
    kind: str = "fixed"              # "fixed" | "cdc"
    chunk_size: int = DEFAULT_CHUNK_SIZE   # fixed size / CDC target size
    min_size: int = 0                # cdc only
    max_size: int = 0                # cdc only

    def normalized(self) -> "ChunkingSpec":
        if self.kind == "cdc":
            mn = self.min_size or self.chunk_size // 4
            mx = self.max_size or self.chunk_size * 4
            return ChunkingSpec("cdc", self.chunk_size, mn, mx)
        return self


@dataclass(frozen=True)
class ChunkSpec:
    """The consolidated chunking-parameter surface.

    Each layer used to spell the same knobs its own way: core took
    ``ChunkingSpec`` (0 min/max defaulting to ``target//4``/``target*4``),
    the checkpointer took ``fp_chunk_bytes``/``device_cdc``/
    ``cdc_min_bytes``/``cdc_max_bytes`` (defaulting to ``//2``/``*2``),
    and the device kernels took raw ``mask``/``min_size``/``max_size``
    kwargs. A ``ChunkSpec`` holds the FULLY RESOLVED values once — the
    constructors encode each legacy defaulting convention, so existing
    call sites keep their exact boundaries — and every consumer
    (``chunk_object``, ``kernels.ops.cdc_*(spec=...)``,
    ``CheckpointConfig.chunk_spec``) accepts it directly. The legacy
    spellings are still accepted and mapped for one release.

    ``device`` marks specs whose CDC hash + cut selection should run as
    the fused on-device launch rather than the host numpy scan."""

    kind: str = "fixed"                    # "fixed" | "cdc"
    target_bytes: int = DEFAULT_CHUNK_SIZE
    min_bytes: int = 0                     # cdc only; resolved, never 0 for cdc
    max_bytes: int = 0
    device: bool = False

    @property
    def mask(self) -> int:
        """Boundary mask targeting ~target_bytes average CDC chunks."""
        return cdc_mask(self.target_bytes)

    @classmethod
    def fixed(cls, target_bytes: int = DEFAULT_CHUNK_SIZE) -> "ChunkSpec":
        return cls("fixed", target_bytes)

    @classmethod
    def cdc(
        cls,
        target_bytes: int,
        *,
        min_bytes: int = 0,
        max_bytes: int = 0,
        device: bool = False,
    ) -> "ChunkSpec":
        """Core convention: unset min/max default to target//4 / target*4
        (matches ``ChunkingSpec.normalized``)."""
        return cls(
            "cdc",
            target_bytes,
            min_bytes or target_bytes // 4,
            max_bytes or target_bytes * 4,
            device,
        )

    @classmethod
    def for_checkpoint(
        cls,
        fp_chunk_bytes: int,
        *,
        min_bytes: int = 0,
        max_bytes: int = 0,
        device: bool = True,
    ) -> "ChunkSpec":
        """Checkpoint convention: unset min/max default to fp_chunk_bytes//2
        / fp_chunk_bytes*2 (matches the legacy ``CheckpointConfig`` fields);
        ``device=False`` maps legacy ``device_cdc=False`` to fixed-size
        chunking, exactly what the fp fast path did."""
        if not device:
            return cls("fixed", fp_chunk_bytes)
        return cls(
            "cdc",
            fp_chunk_bytes,
            min_bytes or max(1, fp_chunk_bytes // 2),
            max_bytes or fp_chunk_bytes * 2,
            True,
        )

    @classmethod
    def from_chunking(
        cls, spec: "ChunkingSpec", *, device: bool = False
    ) -> "ChunkSpec":
        s = spec.normalized()
        return cls(s.kind, s.chunk_size, s.min_size, s.max_size, device)

    def to_chunking(self) -> "ChunkingSpec":
        return ChunkingSpec(self.kind, self.target_bytes, self.min_bytes, self.max_bytes)

    def kernel_kwargs(self) -> dict:
        """The raw kwargs the device kernels spell chunking in."""
        return {
            "mask": self.mask,
            "min_size": self.min_bytes,
            "max_size": self.max_bytes,
        }


def chunk_fixed(data: bytes, chunk_size: int = DEFAULT_CHUNK_SIZE) -> Iterator[bytes]:
    for off in range(0, len(data), chunk_size):
        yield data[off : off + chunk_size]


def chunk_cdc(
    data: bytes,
    spec: ChunkingSpec,
    *,
    backend: str = "numpy",
    device: "str | None" = None,
) -> Iterator[bytes]:
    """Windowed-gear CDC, vectorized. Boundary after position i when
    h(i) & mask == 0, subject to [min_size, max_size]. mask targets
    ~chunk_size averages. Boundaries are bit-identical to
    ``chunk_cdc_scalar``.

    backend:
      * "numpy"  — tiled host scan (default)
      * "kernel" — window hashes on device, cut selection on host
      * "device" — hashes AND cut selection on device in one fused launch
                   (``repro_torch.kernels.ops.cdc_cut_offsets``); only the
                   final cut positions return to the host

    ``device`` is where the "kernel" and "device" backends run: CUDA unless
    the caller passes ``device="cpu"``.
    """
    spec = spec.normalized()
    if backend == "device":
        import torch

        from repro_torch.kernels import ops as kops

        cuts: "np.ndarray | list[int]" = kops.cdc_cut_offsets(
            torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()).to(
                kops.resolve_device(device)
            ),
            mask=cdc_mask(spec.chunk_size),
            min_size=spec.min_size,
            max_size=spec.max_size,
        ) if data else []
    else:
        cand = _cdc_candidates(
            data, cdc_mask(spec.chunk_size), backend=backend, device=device
        )
        cuts = _cdc_cuts(cand, len(data), spec.min_size, spec.max_size)
    start = 0
    for cut in cuts:
        yield data[start : cut + 1]
        start = cut + 1
    if start < len(data):
        yield data[start:]


def chunk_cdc_scalar(data: bytes, spec: ChunkingSpec) -> Iterator[bytes]:
    """Byte-at-a-time CDC — the reference oracle the vectorized path must
    reproduce boundary-for-boundary. Kept for tests; ~3 orders of magnitude
    slower than ``chunk_cdc``."""
    spec = spec.normalized()
    mask = cdc_mask(spec.chunk_size)
    start = 0
    i = start + spec.min_size
    n = len(data)
    while i < n:
        if (window_hash_at(data, i) & mask) == 0 or (i - start + 1) >= spec.max_size:
            yield data[start : i + 1]
            start = i + 1
            i = start + spec.min_size
        else:
            i += 1
    if start < n:
        yield data[start:]


def chunk_object(data: bytes, spec: "ChunkingSpec | ChunkSpec | None" = None) -> list[bytes]:
    backend = "numpy"
    if isinstance(spec, ChunkSpec):
        backend = "device" if spec.device else "numpy"
        spec = spec.to_chunking()
    spec = (spec or ChunkingSpec()).normalized()
    if spec.kind == "fixed":
        out = list(chunk_fixed(data, spec.chunk_size))
    elif spec.kind == "cdc":
        out = list(chunk_cdc(data, spec, backend=backend))
    else:
        raise ValueError(f"unknown chunking kind {spec.kind!r}")
    if data and not out:
        raise AssertionError("non-empty object produced no chunks")
    assert b"".join(out) == data, "chunking must be lossless"
    return out

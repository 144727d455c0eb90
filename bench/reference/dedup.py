"""Plain references of what a dedup checkpoint must hold.

* ``gear_table``, ``cut_positions`` and ``stream_fingerprints``
  work out the device wave again: the content-defined cut positions of a
  leaf's byte stream (a 32-byte gear window hash, a boundary where its
  masked bits are 0, chunks held between a minimum and a maximum size)
  and each chunk's 128-bit fingerprint (four lanes of a position-salted
  multilinear sum, each finished by murmur3's fmix32). Frozen copies of
  the arithmetic the checkpoint format defines, in int64 torch on any
  device, cut back to 32 bits after every operation.
* ``serialize`` spells a leaf as the checkpoint format stores it: a 4-byte
  big-endian header length, a JSON header with the dtype's name and the
  shape, then the raw little-endian bytes (bfloat16 as its 16 bits).
* ``check_checkpoint`` reads a checkpoint back from every storage node's
  own records and chunk store, and holds each object, chunk by chunk,
  against the bytes its leaf must serialize to, on at least as many
  replicas as the deployment states.

Nothing here imports the program; the storage nodes are only read.
"""

from __future__ import annotations

import json

import numpy as np
import torch

U32 = 0xFFFFFFFF
WINDOW = 32


def gear_table() -> torch.Tensor:
    """The 256 gear values: a splitmix-style sequence from 0x243F6A88 with
    step 0x9E3779B9, each finished by fmix32."""
    out, x = [], 0x243F6A88
    for _ in range(256):
        x = (x + 0x9E3779B9) & U32
        z = ((x ^ (x >> 16)) * 0x85EBCA6B) & U32
        z = ((z ^ (z >> 13)) * 0xC2B2AE35) & U32
        out.append(z ^ (z >> 16))
    return torch.tensor(out, dtype=torch.int64)


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & U32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def window_hashes(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 -> (n,) int64 gear hashes: sum_k table[b_{i-k}] << k over
    the (up to) 32 bytes ending at i, mod 2^32."""
    t = table.to(data.device)[data.long()]
    n = t.shape[0]
    h = torch.zeros_like(t)
    for k in range(min(WINDOW, n)):
        h[k:] = (h[k:] + (t[: n - k] << k)) & U32
    return h


def candidates(data: torch.Tensor, mask: int, piece: int = 1 << 26) -> np.ndarray:
    """Positions whose window hash has no bit of ``mask`` set, hashing the
    stream in pieces, each with the 31 bytes before it."""
    table = gear_table()
    found = []
    n = int(data.shape[0])
    for lo in range(0, n, piece):
        back = min(lo, WINDOW - 1)
        h = window_hashes(data[lo - back : min(n, lo + piece)], table)[back:]
        found.append((torch.nonzero((h & mask) == 0).flatten() + lo).cpu().numpy())
    return np.concatenate(found) if found else np.zeros(0, np.int64)


def cut_positions(data: torch.Tensor, mask: int, min_size: int, max_size: int) -> list[int]:
    """The last byte of every chunk but the tail: from each chunk's start,
    the first candidate at least ``min_size`` bytes on, or the byte that
    makes it ``max_size`` long if no candidate comes before it; the tail is
    what is left once fewer than ``min_size`` + 1 bytes remain."""
    n = int(data.shape[0])
    pos = candidates(data, mask)
    cuts, start = [], 0
    while start + min_size < n:
        lo = start + min_size
        hard = max(lo, start + max_size - 1)
        j = int(np.searchsorted(pos, lo))
        cut = int(pos[j]) if j < pos.size and pos[j] <= hard else hard
        if cut >= n:
            break
        cuts.append(cut)
        start = cut + 1
    return cuts


def row_width(max_size: int) -> tuple[int, int]:
    """(payload words, row words): a chunk's bytes fill ``payload`` words,
    its length the next one, and zero words pad the row to a multiple of
    128 words."""
    payload = -(-max_size // 4)
    width = payload + 1
    return payload, max(128, width + (-width) % 128)


def _rows(data: torch.Tensor, bounds: list[tuple[int, int]], max_size: int) -> torch.Tensor:
    """(len(bounds), width) int64 rows of 32-bit words, one per chunk
    [a, b): its bytes little-endian, zero-padded, its length in word
    ``payload``."""
    payload, width = row_width(max_size)
    rows = torch.zeros((len(bounds), width * 4), dtype=torch.uint8, device=data.device)
    for r, (a, b) in enumerate(bounds):
        rows[r, : b - a] = data[a:b]
    words = rows.view(torch.int32).to(torch.int64) & U32
    words[:, payload] = torch.tensor([b - a for a, b in bounds], dtype=torch.int64, device=data.device)
    return words


_A = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_B = (0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
_C = (0x94D049BB, 0xBF58476D, 0x2545F491, 0x9E3779B9)


def fingerprints(words: torch.Tensor) -> torch.Tensor:
    """(rows, width) int64 words -> (rows, 4) int64: lane l is
    fmix32(sum_i fmix32(w_i A_l + i B_l) + width C_l) with i = 1..width,
    every sum mod 2^32."""
    rows, width = words.shape
    pos = torch.arange(1, width + 1, dtype=torch.int64, device=words.device)
    out = torch.empty((rows, 4), dtype=torch.int64, device=words.device)
    for lane in range(4):
        acc = _fmix32((_mul32(words, _A[lane]) + _mul32(pos, _B[lane])) & U32).sum(dim=1) & U32
        out[:, lane] = _fmix32((acc + ((width * _C[lane]) & U32)) & U32)
    return out


def stream_fingerprints(data: torch.Tensor, cuts: list[int], max_size: int, block: int = 16) -> torch.Tensor:
    """(n_chunks, 4) int64 fingerprints of the chunks ``cuts`` end, rows
    built ``block`` at a time."""
    n = int(data.shape[0])
    starts = [0] + [c + 1 for c in cuts]
    bounds = list(zip(starts, [c + 1 for c in cuts] + [n]))
    return torch.cat([fingerprints(_rows(data, bounds[i : i + block], max_size))
                      for i in range(0, len(bounds), block)])


def stream_of(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes in memory order, as (n,) uint8 on its device."""
    flat = t.detach().contiguous().reshape(-1)
    return flat.to(torch.uint8) if flat.dtype == torch.bool else flat.view(torch.uint8)


_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16",
                torch.float64: "float64", torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.int8: "int8", torch.int16: "int16", torch.bool: "bool"}


def serialize(t: torch.Tensor) -> bytearray:
    header = json.dumps({"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape)}).encode()
    raw = stream_of(t).cpu().numpy()
    out = bytearray(4 + len(header) + raw.nbytes)
    out[:4] = len(header).to_bytes(4, "big")
    out[4 : 4 + len(header)] = header
    out[4 + len(header) :] = raw.data
    return out


def serialized_len(t: torch.Tensor) -> int:
    header = json.dumps({"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape)}).encode()
    return 4 + len(header) + t.numel() * t.element_size()


def _live_entries(cluster, name: str) -> list:
    out = []
    for node in cluster.nodes.values():
        e = node.shard.omap.get(name)
        if e is not None and not e.deleted:
            out.append(e)
    return out


def _held(cluster, fp, piece: bytes) -> tuple[int, int]:
    """(nodes whose chunk store holds ``piece`` under ``fp``, nodes that
    hold other bytes under it)."""
    same = bad = 0
    for node in cluster.nodes.values():
        got = node.chunk_store.get(fp)
        if got is not None:
            same, bad = (same + 1, bad) if got == piece else (same, bad + 1)
    return same, bad


def check_object(cluster, name: str, length: int, data, chunk_bytes: int, replicas: int, seen: set | None = None,
                 tag=None) -> list[str]:
    """Faults of one stored object of ``length`` bytes against the bytes it
    must hold (``data()`` gives them): its record on fewer than
    ``replicas`` nodes or differing between them, a chunk count or a
    chunk's bytes that differ, a chunk on fewer than ``replicas`` nodes. A
    (fingerprint, ``tag``, index) in ``seen`` was already held to the same
    bytes and is not read again."""
    entries = _live_entries(cluster, name)
    if len(entries) < replicas:
        return [f"{name}: recorded on {len(entries)} nodes, want {replicas}"]
    fps = list(entries[0].chunk_fps)
    if any(list(e.chunk_fps) != fps for e in entries[1:]):
        return [f"{name}: its replicas record different chunks"]
    n_pieces = max(1, -(-length // chunk_bytes))
    if len(fps) != n_pieces:
        return [f"{name}: {len(fps)} chunks recorded, {n_pieces} expected"]
    todo = [(i, fp) for i, fp in enumerate(fps) if seen is None or (fp, tag, i) not in seen]
    if not todo:
        return []
    buf = data()
    faults = []
    for i, fp in todo:
        same, bad = _held(cluster, fp, buf[i * chunk_bytes : (i + 1) * chunk_bytes])
        if same < replicas or bad:
            faults.append(f"{name}: chunk {i} right on {same} nodes, wrong on {bad}")
        elif seen is not None:
            seen.add((fp, tag, i))
    return faults


def read_back(cluster, name: str, chunk_bytes: int) -> bytes | None:
    """An object's bytes from the first node that records it and holds
    each of its chunks (None if none does)."""
    entries = _live_entries(cluster, name)
    if not entries:
        return None
    parts = []
    for fp in entries[0].chunk_fps:
        got = next((n.chunk_store[fp] for n in cluster.nodes.values() if fp in n.chunk_store), None)
        if got is None:
            return None
        parts.append(got)
    return b"".join(parts)


def check_checkpoint(cluster, prefix: str, name: str, leaves: dict[str, torch.Tensor], refs: dict[str, bool],
                     chunk_bytes: int, replicas: int, seen: set | None = None) -> list[str]:
    """Faults of checkpoint ``name`` against the leaves it must hold (key ->
    tensor) and whether each must have been written by reference: its
    manifest lists exactly those keys, objects and flags, and every object,
    the manifest too, is held by ``check_object``. Chunks of a leaf tensor
    held already (``seen``, shared across checkpoints) are not read again."""
    mname = f"{prefix}/{name}/MANIFEST"
    raw = read_back(cluster, mname, chunk_bytes)
    if raw is None:
        return [f"{mname}: not readable"]
    faults = check_object(cluster, mname, len(raw), lambda: raw, chunk_bytes, replicas)
    manifest = json.loads(raw.decode())
    want = [{"key": k, "object": f"{prefix}/{name}/{k}", "ref": refs[k]} for k in leaves]
    if manifest.get("name") != name or manifest.get("leaves") != want:
        faults.append(f"{mname}: lists {[(e['key'], e['ref']) for e in manifest.get('leaves', [])][:3]}..., "
                      f"want {[(e['key'], e['ref']) for e in want][:3]}...")
    for key, t in leaves.items():
        faults += check_object(cluster, f"{prefix}/{name}/{key}", serialized_len(t), lambda t=t: serialize(t),
                               chunk_bytes, replicas, seen, id(t))
    return faults

"""Windowed gear-hash CDC on the card: window hashes and the fused hash +
min/max-size cut selection, one CUDA source (``csrc/cdc.cu``) with a plain
torch twin for each entry.

``cdc_hashes_cuda`` replaces the Pallas TPU kernel ``_cdc_kernel`` (the
window hashes of one byte stream). ``cdc_cut_positions_cuda`` replaces
``_cdc_cut_kernel``: for a wave of byte streams it returns each stream's cut
positions, the bytes at which the scalar oracle ``chunk_cdc_scalar`` ends a
chunk. (The TPU kernel wrote a bool mask; ``cdc_cut_masks_cuda`` still
gives one, as a scatter of the positions, off the checkpoint path.) Both
kernels read the bytes themselves; the gear-table lookup happens inside
them. The TPU kernel carried "last cut + 1" across a sequential grid; a GPU
grid has no order, so the CUDA version splits the work into a parallel
candidate pass and a per-stream walk (design notes in the source).
"""

from __future__ import annotations

import ctypes
from itertools import accumulate

import numpy as np
import torch

from repro_torch.core.chunking import GEAR_TABLE
from repro_torch.kernels import _build, ref

# Positions per tile of csrc/cdc.cu's hashing kernels (kTile): 256 threads x 32.
TILE = 256 * 32
# Candidate slots per stream in csrc/cdc.cu (kListCap), and the names of the
# cut walk's two routes by the number the kernel reports.
LIST_CAP = 8192
ROUTES = ("list", "bitmap")
_GEAR = np.array(GEAR_TABLE, dtype=np.uint32)


def max_cuts(n: int, min_size: int) -> int:
    """Static bound on the number of cuts in an n-byte stream: every cut
    advances the chunk start by at least min_size + 1 bytes."""
    return n // (min_size + 1) + 1


def gear_values(data_u8: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 bytes -> (n,) int64 gear-table values (plain torch)."""
    table = torch.from_numpy(_GEAR.astype(np.int64)).to(data_u8.device)
    return table[data_u8.to(torch.int64)]


def cdc_hashes_plain(data_u8: torch.Tensor) -> torch.Tensor:
    return ref.cdc_hashes(gear_values(data_u8))


# The plain window hashes take a longer stream in pieces of this many bytes,
# each read with the WINDOW - 1 bytes before it (a hash sees only its
# window): a whole stream's int64 intermediates take ~32 B a byte, ~40 GB
# for a 1.2 GB stream.
PLAIN_PIECE = 1 << 27


def cdc_boundaries_plain(data_u8: torch.Tensor, mask: int) -> torch.Tensor:
    """(n,) uint8 bytes of one stream -> (n,) bool window-hash candidates,
    piece by piece (``PLAIN_PIECE``)."""
    n = int(data_u8.shape[0])
    if n <= PLAIN_PIECE:
        return ref.cdc_boundaries(gear_values(data_u8), mask)
    out = torch.empty((n,), dtype=torch.bool, device=data_u8.device)
    for lo in range(0, n, PLAIN_PIECE):
        hi = min(lo + PLAIN_PIECE, n)
        back = min(lo, ref.WINDOW - 1)
        out[lo:hi] = ref.cdc_boundaries(gear_values(data_u8[lo - back : hi]), mask)[back:]
    return out


def cdc_cut_masks_plain(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[torch.Tensor]:
    # Per-stream hashing: each stream sees its own zero prefix window.
    return [
        ref.cdc_cut_mask(cdc_boundaries_plain(s, mask), s.shape[0], min_size, max_size)
        for s in streams
    ]


def cdc_cut_positions_plain(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[tuple[torch.Tensor, int, int]]:
    """``cdc_cut_positions_cuda``'s result from the plain cut masks."""
    out = []
    for s, m in zip(streams, cdc_cut_masks_plain(streams, mask=mask, min_size=min_size, max_size=max_size)):
        n = int(s.shape[0])
        idx = torch.nonzero(m).flatten()
        n_cuts = int(idx.shape[0])
        pos = torch.full((max_cuts(n, min_size),), n, dtype=torch.int32, device=s.device)
        pos[:n_cuts] = idx.to(torch.int32)
        last = int(idx[-1]) if n_cuts else -1
        out.append((pos, n_cuts, n_cuts + int(last + 1 < n)))
    return out


class _Wave:
    """Device-side description of a wave of byte streams on the card
    (``Wave`` in csrc/cdc.cu) and the gear table, copied over in one piece. With
    ``min_size`` it also holds each stream's count of cut slots, ``m_cut``,
    and their prefix sums. Holds the streams it points at until it is
    dropped."""

    def __init__(self, streams: list[torch.Tensor], min_size: int | None = None):
        dev = streams[0].device
        for s in streams:
            if s.device != dev or s.dtype != torch.uint8 or s.ndim != 1:
                raise ValueError("streams must be 1-D uint8 tensors on one device")
        # The kernel reads 16 bytes per load: each stream starts 16-aligned.
        self.streams = [
            s if s.is_contiguous() and s.data_ptr() % 16 == 0 else s.clone()
            for s in streams
        ]
        self.lens = lens = [int(s.shape[0]) for s in self.streams]
        tile_off = [0, *accumulate(-(-n // TILE) for n in lens)]
        self.n_tiles = tile_off[-1]
        words = [s.data_ptr() for s in self.streams] + lens + tile_off + [0, *accumulate(lens)]
        self.m_cut = [] if min_size is None else [max_cuts(n, min_size) for n in lens]
        if self.m_cut:
            words += [0, *accumulate(self.m_cut)]
        # The gear table rides at the end, its 256 uint32 as 128 int64 slots.
        # From pinned memory the copy is queued on the stream like a kernel
        # (a pageable one waited for the stream to drain first). PyTorch's
        # pinned allocator holds the block until the copy is done; the wave
        # keeps it too.
        self.host = torch.empty((len(words) + _GEAR.size // 2,), dtype=torch.int64, pin_memory=True)
        host = self.host.numpy()
        host[: len(words)] = words
        host[len(words) :] = _GEAR.view(np.int64)
        self.meta = self.host.to(dev, non_blocking=True)

    def args(self) -> list[int]:
        """ptrs, lens, tile_off, pos_off[, cut_off], n_streams, n_tiles, gear."""
        s = len(self.streams)
        base, step = self.meta.data_ptr(), 8
        offsets = [0, s, 2 * s, 3 * s + 1] + ([4 * s + 2] if self.m_cut else [])
        gear = offsets[-1] + s + 1
        return [base + step * o for o in offsets] + [s, self.n_tiles, base + step * gear]


def cdc_hashes_cuda(data_u8: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 byte stream -> (n,) uint32 window hashes.

    A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor takes
    the plain torch twin. Bit-identical to ``ref.cdc_hashes`` of the gear
    values (short windows at the stream head included), at any length.
    """
    if data_u8.device.type != "cuda":
        return cdc_hashes_plain(data_u8)
    n = int(data_u8.shape[0])
    out = torch.empty((n,), dtype=torch.uint32, device=data_u8.device)
    if n == 0:
        return out
    wave = _Wave([data_u8])
    lib = _build.load("cdc")
    with torch.cuda.device(data_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdc_window_hashes_launch(*wave.args(), out.data_ptr(), stream)
    _build.check(err, "cdc_window_hashes_launch")
    cdc_hashes_cuda.launches += 1
    return out


cdc_hashes_cuda.launches = 0


def _check_cut_wave(streams: list[torch.Tensor], min_size: int, max_size: int) -> None:
    if not streams:
        raise ValueError("empty wave")
    if min_size < 1 or max_size < min_size:
        raise ValueError(f"need 1 <= min_size <= max_size, got {min_size}, {max_size}")
    if any(s.shape[0] == 0 for s in streams):
        raise ValueError("drop empty streams before the kernel")


def cdc_cut_positions_cuda(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[tuple[torch.Tensor, int, int]]:
    """Per-stream (n_i,) uint8 bytes -> per stream (cut positions, n_cuts,
    n_chunks).

    The positions are a (m_cut_i,) int32 view of one buffer for the wave,
    m_cut_i = ``max_cuts(n_i, min_size)``: the first n_cuts hold the
    inclusive chunk ends in order, the rest n_i. n_chunks counts the tail
    chunk after the last cut too. ONE kernel pair for the whole wave (a
    parallel candidate pass over every tile of every stream, then one block
    per stream selecting the cuts); the counts come back in the wave's one
    device-to-host copy. Positions are int32, so a stream must be shorter
    than 2^31 bytes. A CUDA wave launches the CUDA kernels (or raises); a
    CPU wave takes the plain torch twin.
    """
    _check_cut_wave(streams, min_size, max_size)
    if any(s.shape[0] >= 1 << 31 for s in streams):
        raise ValueError("cut positions are int32: streams must be shorter than 2^31 bytes")
    if streams[0].device.type != "cuda":
        return cdc_cut_positions_plain(streams, mask=mask, min_size=min_size, max_size=max_size)
    wave = _Wave(streams, min_size)
    dev = streams[0].device
    n = len(wave.streams)
    # Scratch: level-0 and level-1 bitmaps, candidate counts and lists.
    l0_words, l1_words = wave.n_tiles * 256, wave.n_tiles * 8
    scratch = torch.empty((l0_words + l1_words + n + n * LIST_CAP,), dtype=torch.int32, device=dev)
    # Out: (S, 3) counts rows, then the positions.
    out = torch.empty((3 * n + sum(wave.m_cut),), dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    lib = _build.load("cdc")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdc_cut_positions_launch(
            *wave.args(), ctypes.c_uint32(mask), min_size, max_size,
            base, base + 4 * l0_words, base + 4 * (l0_words + l1_words),
            base + 4 * (l0_words + l1_words + n), out.data_ptr() + 12 * n, out.data_ptr(), stream,
        )
    _build.check(err, "cdc_cut_positions_launch")
    cdc_cut_positions_cuda.launches += 1
    positions = out[3 * n :].split(wave.m_cut)  # while the kernels run
    rows = out[: 3 * n].view(n, 3).tolist()  # the wave's one device-to-host copy
    for _, _, route in rows:
        cdc_cut_positions_cuda.routes[ROUTES[route]] += 1
    return [(p, n_cuts, n_chunks) for p, (n_cuts, n_chunks, _) in zip(positions, rows)]


cdc_cut_positions_cuda.launches = 0
# Streams per route of the cut walk, over every launch.
cdc_cut_positions_cuda.routes = dict.fromkeys(ROUTES, 0)


def cdc_cut_masks_cuda(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[torch.Tensor]:
    """Per-stream (n_i,) uint8 bytes -> per-stream (n_i,) bool cut masks.

    A CUDA wave scatters ``cdc_cut_positions_cuda``'s positions into zeroed
    masks (``launches`` counts the calls that launch it); a CPU wave takes
    the plain torch twin. The checkpoint path takes the positions.
    """
    _check_cut_wave(streams, min_size, max_size)
    if streams[0].device.type != "cuda":
        return cdc_cut_masks_plain(
            streams, mask=mask, min_size=min_size, max_size=max_size
        )
    cuts = cdc_cut_positions_cuda(streams, mask=mask, min_size=min_size, max_size=max_size)
    cdc_cut_masks_cuda.launches += 1
    masks = torch.zeros((sum(int(s.shape[0]) for s in streams),), dtype=torch.bool, device=streams[0].device)
    masks = list(masks.split([int(s.shape[0]) for s in streams]))
    for m, (pos, n_cuts, _) in zip(masks, cuts):
        m[pos[:n_cuts].to(torch.int64)] = True
    return masks


cdc_cut_masks_cuda.launches = 0

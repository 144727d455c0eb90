"""Windowed gear-hash CDC on the card: window hashes and the fused hash +
min/max-size cut selection, one CUDA source (``csrc/cdc.cu``) with a plain
torch twin for each entry.

``cdc_hashes_cuda`` replaces the Pallas TPU kernel ``_cdc_kernel`` (the
window hashes of one byte stream). ``cdc_cut_masks_cuda`` replaces
``_cdc_cut_kernel``: for a wave of byte streams it returns each stream's
bool cut mask, bit i set iff the scalar oracle ``chunk_cdc_scalar`` ends a
chunk at byte i. Both read the bytes themselves; the gear-table lookup
happens inside the kernel. The TPU kernel carried "last cut + 1" across a
sequential grid; a GPU grid has no order, so the CUDA version splits the
work into a parallel candidate-bitmap pass and a per-stream walk (design
notes in the source).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.chunking import GEAR_TABLE
from repro_torch.kernels import _build, ref

# Positions per phase-A block of csrc/cdc.cu: kThreads (256) x 32.
TILE = 256 * 32
_GEAR = np.array(GEAR_TABLE, dtype=np.uint32)


def gear_values(data_u8: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 bytes -> (n,) int64 gear-table values (plain torch)."""
    table = torch.from_numpy(_GEAR.astype(np.int64)).to(data_u8.device)
    return table[data_u8.to(torch.int64)]


def cdc_hashes_plain(data_u8: torch.Tensor) -> torch.Tensor:
    return ref.cdc_hashes(gear_values(data_u8))


def cdc_cut_masks_plain(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[torch.Tensor]:
    # Per-stream hashing: each stream sees its own zero prefix window.
    return [
        ref.cdc_cut_mask(
            ref.cdc_boundaries(gear_values(s), mask), s.shape[0], min_size, max_size
        )
        for s in streams
    ]


class _Wave:
    """Device-side description of a wave of byte streams (``Wave`` in
    csrc/cdc.cu). Holds the streams it points at until it is dropped."""

    def __init__(self, streams: list[torch.Tensor]):
        dev = streams[0].device
        for s in streams:
            if s.device != dev or s.dtype != torch.uint8 or s.ndim != 1:
                raise ValueError("streams must be 1-D uint8 tensors on one device")
        # The kernel reads 16 bytes per load: each stream starts 16-aligned.
        self.streams = [
            s if s.is_contiguous() and s.data_ptr() % 16 == 0 else s.clone()
            for s in streams
        ]
        self.lens = [int(s.shape[0]) for s in self.streams]
        tiles = [-(-n // TILE) for n in self.lens]
        self.tile_off = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
        self.pos_off = np.concatenate([[0], np.cumsum(self.lens)]).astype(np.int64)
        self.n_tiles = int(self.tile_off[-1])
        self.total = int(self.pos_off[-1])
        host = np.concatenate(
            [
                np.array([s.data_ptr() for s in self.streams], dtype=np.uint64).view(np.int64),
                np.asarray(self.lens, dtype=np.int64),
                self.tile_off,
                self.pos_off,
            ]
        )
        self.meta = torch.from_numpy(host).to(dev)
        self.gear = torch.from_numpy(_GEAR).to(dev)

    def args(self) -> list[int]:
        """ptrs, lens, tile_off, pos_off, n_streams, n_tiles, gear."""
        s = len(self.streams)
        base, step = self.meta.data_ptr(), 8
        return [
            base,
            base + step * s,
            base + step * 2 * s,
            base + step * (3 * s + 1),
            s,
            self.n_tiles,
            self.gear.data_ptr(),
        ]


def cdc_hashes_cuda(data_u8: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 byte stream -> (n,) uint32 window hashes.

    A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor takes
    the plain torch twin. Bit-identical to ``ref.cdc_hashes`` of the gear
    values (short windows at the stream head included).
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


def cdc_cut_masks_cuda(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> list[torch.Tensor]:
    """Per-stream (n_i,) uint8 bytes -> per-stream (n_i,) bool cut masks.

    ONE kernel pair for the whole wave (a parallel candidate pass over every
    tile of every stream, then one warp per stream selecting the cuts). A
    CUDA wave launches the CUDA kernels (or raises); a CPU wave takes the
    plain torch twin.
    """
    if not streams:
        raise ValueError("empty wave")
    if min_size < 1 or max_size < min_size:
        raise ValueError(f"need 1 <= min_size <= max_size, got {min_size}, {max_size}")
    if any(s.shape[0] == 0 for s in streams):
        raise ValueError("drop empty streams before the kernel")
    if streams[0].device.type != "cuda":
        return cdc_cut_masks_plain(
            streams, mask=mask, min_size=min_size, max_size=max_size
        )
    wave = _Wave(streams)
    dev = streams[0].device
    l0 = torch.empty((wave.n_tiles * 256,), dtype=torch.int32, device=dev)
    l1 = torch.empty((wave.n_tiles * 8,), dtype=torch.int32, device=dev)
    cut = torch.zeros((wave.total,), dtype=torch.bool, device=dev)
    lib = _build.load("cdc")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdc_cut_masks_launch(
            *wave.args(), ctypes.c_uint32(mask), min_size, max_size,
            l0.data_ptr(), l1.data_ptr(), cut.data_ptr(), stream,
        )
    _build.check(err, "cdc_cut_masks_launch")
    cdc_cut_masks_cuda.launches += 1
    return list(cut.split(wave.lens))


cdc_cut_masks_cuda.launches = 0

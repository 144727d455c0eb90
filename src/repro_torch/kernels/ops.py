"""Public wrappers over the port's kernels (dedup and attention).

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor goes through the hand-written CUDA kernels (``csrc/``) or raises, a
CPU tensor takes the plain torch twins. Nothing falls back from one to the
other. "uint32" tensors are ``torch.uint32``; arithmetic on them goes
through int32 views, which hold the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fingerprint import Fingerprint, device_fp
from repro_torch.kernels.cdc import cdc_cut_positions_cuda, cdc_hashes_cuda
from repro_torch.kernels.cdc import max_cuts as _max_cuts
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda

# Semantic launch counters: one increment per wrapper call, whichever route
# it takes, so the one-launch-per-wave contract is assertable on the CPU
# too. The CUDA kernels' own counts are ``<wrapper>_cuda.launches``.
launch_counts = {"cdc": 0, "fingerprint": 0, "flash": 0}


def _count_launch(kind: str) -> None:
    launch_counts[kind] += 1


def launch_snapshot() -> dict[str, int]:
    """Copy of the cumulative launch counters (for delta accounting)."""
    return dict(launch_counts)


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the plain torch route")
    return dev


def _u8_to_u32(u8: torch.Tensor, words: int) -> torch.Tensor:
    """Zero-pad a flat byte tensor to ``words`` * 4 bytes and view it as
    little-endian uint32 words."""
    pad = words * 4 - u8.shape[0]
    if pad:
        u8 = torch.cat([u8, torch.zeros((pad,), dtype=torch.uint8, device=u8.device)])
    return u8.view(torch.uint32)


def fingerprint_chunks(words: torch.Tensor) -> torch.Tensor:
    """(n_chunks, n_words) uint32 -> (n_chunks, 4) uint32."""
    _count_launch("fingerprint")
    return fingerprint_chunks_cuda(words)


def flash_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, K, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Fused attention, ``scale = 1/sqrt(hd)``. Returns (B, Sq, H, hd).

    A CUDA tensor runs the hand-written kernel (``csrc/flash_attn.cu``) or
    raises; a CPU tensor takes the plain chunked attention. The JAX
    package's ``use_pallas`` switch and its 24k ``Skv`` cap (a TPU VMEM
    limit) are gone: the kernel streams K/V and takes any length."""
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    _count_launch("flash")  # after the call: a refused launch is not counted
    return out


def tensor_to_u32(x: torch.Tensor) -> torch.Tensor:
    """Bitcast any tensor to its flat little-endian uint32 stream.

    4- and 8-byte dtypes bitcast in memory order; sub-word dtypes (u8, bf16,
    f16, bool) pack little-endian, zero-padded to a word multiple. Matches
    ``np.frombuffer(arr.tobytes() + pad, "<u4")`` on the same values.
    """
    u8 = tensor_to_u8(x)
    return _u8_to_u32(u8, -(-u8.shape[0] // 4))


def tensor_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Bitcast any tensor to its flat byte stream, staying on its device."""
    flat = x.contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        return flat.to(torch.uint8)
    if flat.dtype == torch.uint8:
        return flat
    return flat.view(torch.uint8)


def fingerprint_tensor_chunks(x: torch.Tensor, chunk_bytes: int = 512 * 1024) -> torch.Tensor:
    """Fingerprint a tensor in chunk_bytes-sized pieces on its device.

    Returns (n_chunks, 4) uint32. Used by dedup checkpointing to name chunks
    without host round-trips.
    """
    return fingerprint_tensor_chunks_many([x], chunk_bytes)[0]


def _chunk_words(x: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """A tensor's bytes as (n_chunks, chunk_words) uint32 rows, zero-padded."""
    u8 = tensor_to_u8(x)
    n_rows = -(-u8.shape[0] // (chunk_words * 4))
    return _u8_to_u32(u8, n_rows * chunk_words).view(n_rows, chunk_words)


def fingerprint_tensor_chunks_many(
    tensors: list[torch.Tensor], chunk_bytes: int = 512 * 1024
) -> list[torch.Tensor]:
    """Batched ``fingerprint_tensor_chunks``: every tensor's chunks in ONE
    kernel launch. Each tensor is padded to a chunk_words multiple on its
    own (so results equal per-tensor calls). Returns one (n_chunks_i, 4)
    uint32 tensor per input."""
    if not tensors:
        return []
    chunk_words = max(128, chunk_bytes // 4)
    rows = [_chunk_words(x, chunk_words) for x in tensors]
    stacked = torch.cat([r.view(torch.int32) for r in rows]).view(torch.uint32)
    _count_launch("fingerprint")
    fps = fingerprint_chunks_cuda(stacked)
    return list(fps.split([r.shape[0] for r in rows]))


def device_fps_to_host(fps_u32: torch.Tensor) -> list[Fingerprint]:
    """Convert kernel output rows into namespaced Fingerprint objects."""
    rows = fps_u32.cpu().numpy()
    return [device_fp([int(w) for w in row]) for row in rows]


def cdc_window_hashes(data_u8: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 byte stream -> (n,) uint32 window hashes, bit-identical to
    the host ``repro_torch.core.chunking.window_hashes``."""
    _count_launch("cdc")
    return cdc_hashes_cuda(data_u8)


def cdc_boundaries(data_u8: torch.Tensor, mask: int) -> torch.Tensor:
    """(n,) uint8 byte stream -> (n,) bool boundary mask."""
    h = cdc_window_hashes(data_u8).view(torch.int32)
    return (h & _as_i32(mask)) == 0


def _as_i32(v: int) -> int:
    """The int32 with the bits of the uint32 ``v``."""
    return v - (1 << 32) if v >= 1 << 31 else v


# ---------------------------------------------------------------------------
# Device-resident CDC cut selection fused with fingerprinting: the whole
# chunk-naming stage (window hashes -> min/max-size cut selection -> per-chunk
# fingerprints) runs on the card, in exactly ONE CDC launch and ONE
# fingerprint launch per wave of streams.
# ---------------------------------------------------------------------------


def fp_row_words(max_size: int) -> tuple[int, int]:
    """Fused-fingerprint row geometry for chunks up to ``max_size`` bytes.

    Returns (payload_words, padded_width). A chunk's row is its bytes packed
    little-endian into ``payload_words`` uint32 (zero-padded), the chunk's
    byte length in the word right after the payload (so zero-extended chunks
    of different lengths can never collide), then zero padding to a
    lane-aligned ``padded_width``. Fingerprint of a chunk == ``ref.
    fingerprint_chunks`` of its row.
    """
    payload = -(-max_size // 4)
    width = payload + 1
    width = width + (-width) % 128
    return payload, max(128, width)


def _chunk_rows(stream_u8, cutpos, *, n: int, max_size: int, out: torch.Tensor) -> torch.Tensor:
    """Segment one stream into fixed-width fingerprint rows (plain torch).

    cutpos is the stream's (m_cut,) int32 cut positions (the first n_cuts
    valid, the rest n). Writes the stream's first ``out.shape[0]`` rows into
    ``out`` (a contiguous (k, width) 32-bit tensor, k <= m_cut + 1) and
    returns them as uint32: one row per chunk, and past n_chunks empty rows
    (length 0).
    """
    row_words, width = fp_row_words(max_size)
    row_bytes = row_words * 4
    dev = stream_u8.device
    k = out.shape[0]
    cuts = cutpos.to(torch.int64)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), cuts + 1])[:k]
    # Row i ends at cut i; the tail chunk (row n_cuts) and the empty rows
    # after it at n - 1 (the empty rows start at n + 1 and get length 0).
    ends = torch.cat([cuts, torch.full((1,), n - 1, dtype=torch.int64, device=dev)])[:k].clamp_(max=n - 1)
    lens = (ends - starts + 1).clamp(0, row_bytes)
    # One gather of k strided windows of the zero-extended stream: each row
    # holds the row_bytes after its start plus the width's padding bytes.
    padded = torch.cat([stream_u8, torch.zeros((width * 4,), dtype=torch.uint8, device=dev)])
    rows = torch.index_select(padded.unfold(0, width * 4, 1), 0, starts.clamp(0, n), out=out.view(torch.uint8))
    col = torch.arange(width * 4, device=dev)
    rows.masked_fill_(col[None, :] >= lens[:, None], 0)
    rows = rows.view(torch.int32)
    rows[:, row_words] = lens.to(torch.int32)
    return rows.view(torch.uint32)


def cdc_cut_and_fingerprint_many(
    streams: list[torch.Tensor],
    *,
    mask: int | None = None,
    min_size: int | None = None,
    max_size: int | None = None,
    spec=None,
) -> list[tuple[torch.Tensor, int, torch.Tensor, int]]:
    """Chunk + fingerprint a wave of byte streams on their device.

    streams: list of (n_i,) uint8 tensors (one per tensor/object), all on
    one device. Boundaries are bit-identical to ``chunk_cdc_scalar`` with the
    same mask/min/max; fingerprints follow the ``fp_row_words`` row contract.
    Pass either a ``core.chunking.ChunkSpec`` via ``spec=`` or the raw
    mask/min_size/max_size trio.

    Returns, per stream: (cut_positions (m_cut,) int32 — first ``n_cuts``
    valid, the rest n; n_cuts; fps (m_cut + 1, 4) uint32 — first
    ``n_chunks`` rows valid, the rest zero; n_chunks), m_cut =
    ``_max_cuts(n, min_size)``. Exactly one CDC launch + one fingerprint launch per call,
    regardless of wave size (empty streams short-circuit without a launch).
    """
    mask, min_size, max_size = _resolve_chunk_args(spec, mask, min_size, max_size)
    if min_size < 1:
        raise ValueError("pass a normalized ChunkingSpec (min_size >= 1)")
    nonempty = [s for s in streams if s.shape[0] > 0]
    if not nonempty:
        return [_empty_result(s) for s in streams]
    _count_launch("cdc")
    _count_launch("fingerprint")
    rows, per_stream = cut_wave_rows(nonempty, mask=mask, min_size=min_size, max_size=max_size)
    fps = fingerprint_chunks_cuda(rows).split([c for _, _, c in per_stream])
    live = iter(
        (cutpos, n_cuts, _pad_rows(f, cutpos.shape[0] + 1), n_chunks)
        for (cutpos, n_cuts, n_chunks), f in zip(per_stream, fps)
    )
    return [next(live) if s.shape[0] > 0 else _empty_result(s) for s in streams]


def cut_wave_rows(
    streams: list[torch.Tensor], *, mask: int, min_size: int, max_size: int
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, int, int]]]:
    """The CDC half of ``cdc_cut_and_fingerprint_many`` on a wave of
    non-empty streams: one cut-positions launch, then each stream's chunk
    rows.

    Returns (rows (sum n_chunks_i, width) uint32 stacked in stream order,
    and per stream (cutpos, n_cuts, n_chunks)). Only the rows that hold a
    chunk are built, each stream's written in place into one buffer for the
    wave (a full-width train state's wave is ~14 GB of rows)."""
    cuts = cdc_cut_positions_cuda(streams, mask=mask, min_size=min_size, max_size=max_size)
    counts = [n_chunks for _, _, n_chunks in cuts]
    _, width = fp_row_words(max_size)
    rows = torch.empty((sum(counts), width), dtype=torch.int32, device=streams[0].device)
    for s, (cutpos, _, _), out in zip(streams, cuts, rows.split(counts)):
        _chunk_rows(s, cutpos, n=int(s.shape[0]), max_size=max_size, out=out)
    return rows.view(torch.uint32), cuts


def _pad_rows(fps: torch.Tensor, m: int) -> torch.Tensor:
    """``fps`` (k, 4) followed by zero rows up to (m, 4)."""
    out = torch.zeros((m, 4), dtype=torch.int32, device=fps.device)
    out[: fps.shape[0]] = fps.view(torch.int32)
    return out.view(torch.uint32)


def _empty_result(s: torch.Tensor) -> tuple[torch.Tensor, int, torch.Tensor, int]:
    """The per-stream result of an empty stream."""
    return (
        torch.zeros((0,), dtype=torch.int32, device=s.device), 0,
        torch.zeros((0, 4), dtype=torch.int32, device=s.device).view(torch.uint32), 0,
    )


def cdc_cut_and_fingerprint(
    stream: torch.Tensor,
    *,
    mask: int | None = None,
    min_size: int | None = None,
    max_size: int | None = None,
    spec=None,
) -> tuple[torch.Tensor, int, torch.Tensor, int]:
    """Single-stream ``cdc_cut_and_fingerprint_many``."""
    return cdc_cut_and_fingerprint_many(
        [stream], mask=mask, min_size=min_size, max_size=max_size, spec=spec
    )[0]


def _resolve_chunk_args(
    spec, mask: int | None, min_size: int | None, max_size: int | None
) -> tuple[int, int, int]:
    """Map the ``ChunkSpec`` spelling onto the kernels' raw mask/min/max
    trio; explicit raw kwargs win over the spec."""
    if spec is not None:
        kw = spec.kernel_kwargs()
        mask = kw["mask"] if mask is None else mask
        min_size = kw["min_size"] if min_size is None else min_size
        max_size = kw["max_size"] if max_size is None else max_size
    if mask is None or min_size is None or max_size is None:
        raise TypeError("pass spec= or all of mask/min_size/max_size")
    return mask, min_size, max_size


def cdc_cut_offsets(
    data_u8: torch.Tensor,
    *,
    mask: int | None = None,
    min_size: int | None = None,
    max_size: int | None = None,
    spec=None,
) -> np.ndarray:
    """Device cut selection -> host int64 cut positions (inclusive chunk
    ends, tail excluded) — the device twin of ``chunking._cdc_cuts``.
    Accepts ``spec=`` (a ``core.chunking.ChunkSpec``) or the raw trio."""
    mask, min_size, max_size = _resolve_chunk_args(spec, mask, min_size, max_size)
    if int(data_u8.shape[0]) == 0:
        return np.zeros(0, dtype=np.int64)
    _count_launch("cdc")
    cutpos, n_cuts, _ = cdc_cut_positions_cuda([data_u8], mask=mask, min_size=min_size, max_size=max_size)[0]
    return cutpos[:n_cuts].cpu().numpy().astype(np.int64)

"""The benchmark's yardstick: published peaks of one NVIDIA H100 SXM and the
operations and bytes a step, an attention call or a checkpoint wave
needs, computed from shapes. ``flash_bound_ms``, ``flash_bwd_bound_ms``
and ``cut_bound_ms`` are copies of ``chip_smoke.py``'s; ``fp_bound_ms``
replaces its count read from the built kernel's code by one fixed from
the algorithm, and counts the wave's stream bytes, not the padded rows.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer operations a second: 132 SMs x 128 lanes at the 1.98 GHz
# boost clock (integer multiply-adds and adds also run on the FP32 lanes).
# Derived, not published: no metric is bounded by it; ``fp_bound_ms``
# reports the operations bound beside the bytes one.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations the fingerprint needs per 32-bit word of a row, from
# the algorithm: 4 lanes x (2 multiply-adds, 8 fmix32 steps, 1 add).
FP_OPS_PER_WORD = 4 * (2 + 8 + 1)


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the flash kernel's mask keeps visible."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_ms(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) lower bounds in ms of one flash call: 2 * (dqk +
    dv) FLOP per visible pair and query head (q.k and p.v) over the bf16
    tensor-core peak; q, k, v read once and the (B, Sq, H, dv) output
    written once over the HBM rate. ``q``, ``k``, ``v`` need only
    ``shape``, ``numel()`` and ``element_size()``."""
    b, sq, h, dqk = q.shape
    dv = v.shape[-1]
    flop = 2 * (dqk + dv) * b * h * attention_pairs(sq, k.shape[1], causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * q.element_size()
    return flop / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def flash_bwd_bound_ms(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) lower bounds in ms of one backward call: 2 * (3
    dqk + 2 dv) FLOP per visible pair and query head (q.k, dO.v and the
    products into dq, dk, dv) over the bf16 tensor-core peak; q, k, v, the
    output, dO and the lse read once and dq, dk, dv written once over the
    HBM rate."""
    b, sq, h, dqk = q.shape
    dv = v.shape[-1]
    flop = 2 * (3 * dqk + 2 * dv) * b * h * attention_pairs(sq, k.shape[1], causal, window)
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * b * sq * h * dv) * q.element_size() + 4 * b * h * sq
    return flop / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def cut_bound_ms(wave_bytes: int, m_cut: int, n_streams: int) -> tuple[float, float]:
    """(bytes, operations) lower bounds in ms of one cut-positions call:
    each stream byte read once and the (m_cut,) int32 positions and (S, 3)
    int32 counts written once, over the HBM rate; 4 integer operations per
    byte (gear lookup, shift-add, mask, compare) over the integer peak."""
    nbytes = wave_bytes + 4 * m_cut + 12 * n_streams
    return nbytes / HBM_BYTES_PER_S * 1e3, 4 * wave_bytes / INT32_OPS_PER_S * 1e3


def fp_bound_ms(wave_bytes: int, c_rows: int, width: int) -> tuple[float, float]:
    """(bytes, operations) lower bounds in ms of one fingerprint call over
    the chunks of a wave of ``wave_bytes``: every chunk byte read once and
    the (c_rows, 4) uint32 fingerprints written once over the HBM rate;
    ``FP_OPS_PER_WORD`` integer operations per word of the (c_rows, width)
    rows over the integer peak."""
    nbytes = wave_bytes + 16 * c_rows
    return nbytes / HBM_BYTES_PER_S * 1e3, FP_OPS_PER_WORD * c_rows * width / INT32_OPS_PER_S * 1e3


class Shape:
    """A tensor's shape and element size, for the bound functions."""

    def __init__(self, shape: tuple, element_size: int):
        self.shape, self._es = tuple(shape), element_size

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self._es


def attention_shapes(m: dict) -> tuple[Shape, Shape, Shape]:
    """q, k, v of one microbatch's attention call at the configuration's
    sizes (bf16)."""
    mb = m["global_batch"] // m["accum"]
    s = m["seq_len"]
    return (Shape((mb, s, m["n_heads"], m["head_dim"]), 2), Shape((mb, s, m["n_kv_heads"], m["head_dim"]), 2),
            Shape((mb, s, m["n_kv_heads"], m["head_dim"]), 2))

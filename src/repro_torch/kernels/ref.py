"""Plain torch oracles for the dedup kernels and for the flash kernel's
backward.

The dedup oracles define the *semantics*; the CUDA kernels in ``csrc/``
must match them bit-exactly (uint32 wrap-around arithmetic everywhere).
torch has no shift, add or sum on ``torch.uint32`` on the CPU, so the
arithmetic runs in int64 and every result is cut back to 32 bits with
``& 0xFFFFFFFF``. Products are split at 16 bits so that no intermediate
leaves the int64 range. Their inputs and outputs are ``torch.uint32``
tensors.

The attention twins (``flash_attention_lse_plain``,
``flash_attention_bwd_plain``) write out the flash kernels' formulas on
explicit (queries, keys) score blocks, in float32 (float64 for float64
inputs), and are held to the kernels within a tolerance.

Every function runs on whatever device its input lies on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_U32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# 128-bit tensor fingerprint (4 x uint32 lanes).
#
# Commutative position-salted multilinear mix: for lane l,
#   h_l = finalize( sum_i mix( w_i * A_l + (pos_i + 1) * B_l ) + n * C_l )
# The sum is associative/commutative => tile-parallel with any grid order.
# mix = xorshift-multiply avalanche (murmur3-style finalizer).
# ---------------------------------------------------------------------------

LANES = 4
# Odd multipliers per lane (distinct golden-ratio-ish constants).
A = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F], dtype=np.uint32)
B = np.array([0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09], dtype=np.uint32)
C = np.array([0x94D049BB, 0xBF58476D, 0x2545F491, 0x9E3779B9], dtype=np.uint32)


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x, c in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 avalanche on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _as_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or any integer) values -> int64 in [0, 2^32)."""
    if x.dtype == torch.uint32:  # through int32: casts of uint32 are sparse
        x = x.view(torch.int32)
    return x.to(torch.int64) & _U32


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as torch.uint32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.uint32)


def fingerprint_chunks(words: torch.Tensor) -> torch.Tensor:
    """words: (n_chunks, chunk_words) uint32 -> (n_chunks, 4) uint32.

    Each row is fingerprinted independently; every word of the row counts
    (the caller zero-pads rows and salts the true length in, as ops.py does).
    """
    assert words.ndim == 2, words.shape
    w = _as_i64(words)
    n_chunks, n_words = w.shape
    dev = w.device
    pos = torch.arange(1, n_words + 1, dtype=torch.int64, device=dev)[None, :, None]
    a = torch.from_numpy(A.astype(np.int64)).to(dev)[None, None, :]
    b = torch.from_numpy(B.astype(np.int64)).to(dev)[None, None, :]
    mixed = _mix32((_mul32(w[:, :, None], a) + _mul32(pos, b)) & _U32)  # (c, w, 4)
    acc = mixed.sum(dim=1) & _U32
    c = torch.from_numpy(C.astype(np.int64)).to(dev)[None, :]
    acc = (acc + _mul32(torch.full_like(c, n_words), c)) & _U32
    return _to_u32(_mix32(acc))


# ---------------------------------------------------------------------------
# Windowed gear-hash CDC boundaries.
#
#   h_i = sum_{k=0}^{W-1} table[byte_{i-k}] << k      (uint32 wrap)
#   boundary_i = (h_i & mask) == 0
#
# Matches repro_torch.core.chunking.window_hash_at (the host path).
# ---------------------------------------------------------------------------

WINDOW = 32


def cdc_hashes(tvals: torch.Tensor) -> torch.Tensor:
    """tvals: (n,) uint32 gear-table values per byte -> (n,) window hashes.

    Positions i < WINDOW-1 use the short prefix window (same as host path).
    """
    t = _as_i64(tvals)
    n = t.shape[0]
    h = torch.zeros_like(t)
    for k in range(min(WINDOW, n)):
        h[k:] = (h[k:] + (t[: n - k] << k)) & _U32
    return _to_u32(h)


def cdc_boundaries(tvals: torch.Tensor, mask: int) -> torch.Tensor:
    return (_as_i64(cdc_hashes(tvals)) & mask) == 0


# ---------------------------------------------------------------------------
# Min/max-size cut selection over the candidate mask — the oracle the CUDA
# cut kernel must match bit-exactly, which in turn matches the scalar
# chunk_cdc_scalar loop:
#
#   start = 0
#   repeat: lo = start + min_size; stop if lo >= n
#           hard = max(lo, start + max_size - 1)
#           cut  = first candidate >= lo if <= hard else hard
#           stop if cut >= n; emit cut; start = cut + 1
#
# It walks the candidate positions on the host, O(#cuts + #candidates).
# ---------------------------------------------------------------------------


def cdc_cut_mask(
    cand: torch.Tensor, n: int, min_size: int, max_size: int
) -> torch.Tensor:
    """(m,) bool candidate mask (positions >= n are ignored) -> (m,) bool
    cut mask on the same device."""
    assert cand.ndim == 1
    m = cand.shape[0]
    out = torch.zeros((m,), dtype=torch.bool, device=cand.device)
    if m == 0:
        return out
    pos = np.flatnonzero(cand[: min(m, n)].cpu().numpy())
    cuts: list[int] = []
    start = 0
    while True:
        lo = start + min_size
        if lo >= n:
            break
        hard = max(lo, start + max_size - 1)
        j = int(np.searchsorted(pos, lo))
        cut = hard
        if j < pos.size and int(pos[j]) <= hard:
            cut = int(pos[j])
        if cut >= n:
            break
        cuts.append(cut)
        start = cut + 1
    cuts = [c for c in cuts if c < m]
    if cuts:
        out[torch.tensor(cuts, dtype=torch.int64, device=cand.device)] = True
    return out


# ---------------------------------------------------------------------------
# Attention with its log-sum-exp, and its backward, on explicit score blocks.
#
# Per query head h (kv head h // (H / K)), visible pair (i, j) (causal: j <=
# i, no offset; window w > 0: j > i - w; scores scaled by ``scale``):
#   lse_i = log sum_j exp(s_ij),  P_ij = exp(s_ij - lse_i),  O_i = sum_j P_ij v_j
#   delta_i = sum_d dO_id O_id,  dS_ij = P_ij (dO_i . v_j - delta_i)
#   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_(h, i) dS_ij q_i,
#   dV_j = sum_(h, i) P_ij dO_i
# A row that sees no key has lse -inf, P 0, O 0.
# ---------------------------------------------------------------------------

_BLOCK_ELEMENTS = 1 << 27  # score elements a query block may hold (512 MB in float32)


def _attention_blocks(q, k, causal: bool, window: int):
    """(compute dtype, grouped queries (B, Sq, K, R, dqk), k, and for each
    query block (slice, its (nq, Skv) visibility mask)) of the twins."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    b, sq, h, dqk = q.shape
    skv, kh = k.shape[1], k.shape[2]
    qg = q.to(ct).reshape(b, sq, kh, h // kh, dqk)
    rows = max(1, min(sq, _BLOCK_ELEMENTS // max(1, b * h * skv)))
    kpos = torch.arange(skv, device=q.device)[None, :]
    blocks = []
    for lo in range(0, sq, rows):
        qpos = torch.arange(lo, min(sq, lo + rows), device=q.device)[:, None]
        ok = torch.ones((qpos.shape[0], skv), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        blocks.append((slice(lo, lo + qpos.shape[0]), ok))
    return ct, qg, k.to(ct), blocks


def flash_attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, dqk), k (B, Skv, K, dqk), v (B, Skv, K, dv) -> (out
    (B, Sq, H, dv) in q's dtype, lse (B, H, Sq) float32; float64 for
    float64 inputs): the forward kernel with its log-sum-exp."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    ct, qg, kf, blocks = _attention_blocks(q, k, causal, window)
    b, sq, kh, rep, _ = qg.shape
    vf = v.to(ct)
    out = torch.empty((b, sq, kh, rep, v.shape[-1]), dtype=ct, device=q.device)
    lse = torch.empty((b, kh, rep, sq), dtype=ct, device=q.device)
    for sl, ok in blocks:
        s = torch.einsum("bqkrd,bskd->bkrqs", qg[:, sl], kf) * scale
        s = torch.where(ok, s, -math.inf)
        m = torch.logsumexp(s, dim=-1)                                    # (B, K, R, nq); -inf where all masked
        p = torch.where(ok, torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        out[:, sl] = torch.einsum("bkrqs,bskd->bqkrd", p, vf)
        lse[..., sl] = m
    return out.reshape(b, sq, kh * rep, -1).to(q.dtype), lse.reshape(b, kh * rep, sq)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formulas, written out (no autograd): the
    gradients (dq, dk, dv) of attention at q, k, v from its output ``o``,
    its log-sum-exp ``lse`` (B, H, Sq) and the output's gradient ``dout``
    (B, Sq, H, dv), each in its input's shape and q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    ct, qg, kf, blocks = _attention_blocks(q, k, causal, window)
    b, sq, kh, rep, dqk = qg.shape
    dv_ = v.shape[-1]
    vf = v.to(ct)
    dog = dout.to(ct).reshape(b, sq, kh, rep, dv_)
    delta = (dog * o.to(ct).reshape(b, sq, kh, rep, dv_)).sum(-1)          # (B, Sq, K, R)
    lse_g = lse.to(ct).reshape(b, kh, rep, sq)
    dq = torch.empty((b, sq, kh, rep, dqk), dtype=ct, device=q.device)
    dk = torch.zeros(kf.shape, dtype=ct, device=q.device)
    dv = torch.zeros(vf.shape, dtype=ct, device=q.device)
    for sl, ok in blocks:
        s = torch.einsum("bqkrd,bskd->bkrqs", qg[:, sl], kf) * scale
        lse_b = lse_g[..., sl, None]
        p = torch.where(ok, torch.exp(s - torch.where(torch.isfinite(lse_b), lse_b, 0.0)), 0.0)
        dv += torch.einsum("bkrqs,bqkrd->bskd", p, dog[:, sl])
        dp = torch.einsum("bqkrd,bskd->bkrqs", dog[:, sl], vf)
        ds = p * (dp - delta[:, sl].permute(0, 2, 3, 1)[..., None])
        dq[:, sl] = torch.einsum("bkrqs,bskd->bqkrd", ds, kf) * scale
        dk += torch.einsum("bkrqs,bqkrd->bskd", ds, qg[:, sl]) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)

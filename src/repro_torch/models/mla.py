"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

A port of the JAX package's ``models/mla.py``. Prefill: the query's
low-rank path (``q_lora_rank``), the compressed KV latent ``c_kv``
(``kv_lora_rank``) and one rope key shared by the heads
(``qk_rope_head_dim``); keys and values are expanded per head for standard
attention. With ``impl="chunked"`` a CUDA tensor runs the hand-written
flash kernel on the concatenated (nope, rope) queries and keys, qk head dim
``qk_nope + qk_rope`` against v head dim ``v_head_dim`` (96 / 64 at
MiniCPM3-4B's width): one launch a layer. A CPU tensor takes the plain
``chunked_attention``; ``impl="dense"`` (training) the fp32-softmax einsums.

Decode: the *absorbed* form, as in the reference. The per-head expansions
``w_uk`` / ``w_uv`` are folded into the query and the output, so attention
runs over the ``(B, S, kv_lora_rank + qk_rope_head_dim)`` latent cache in
plain torch; the new token's latent and rope key are written into the
caches in place (the JAX version returns updated copies).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.distributed.sharding import (
    flatten, local_region, match_heads, place_as, reduce_partial, replicated_like, shard, unflatten, write_slice,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    Dense,
    RMSNorm,
    apply_rope,
    chunked_attention,
    dense,
    init_dense,
    init_rms_norm,
    raw_weight,
    rms_norm,
)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    impl: str = "dense"
    q_chunk: int = 2048
    kv_chunk: int = 1024

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# The leaves of the JAX tree, in its init order; the two norms are RMSNorms,
# the rest Dense.
LEAVES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo")
NORMS = ("q_norm", "kv_norm")


class MLA(nn.Module):
    """MLA's parameters, named as the JAX ``init_mla`` tree."""

    def __init__(self, w_dq: Dense, q_norm: RMSNorm, w_uq: Dense, w_dkv: Dense, kv_norm: RMSNorm,
                 w_kr: Dense, w_uk: Dense, w_uv: Dense, wo: Dense):
        super().__init__()
        self.w_dq, self.q_norm, self.w_uq = w_dq, q_norm, w_uq
        self.w_dkv, self.kv_norm, self.w_kr = w_dkv, kv_norm, w_kr
        self.w_uk, self.w_uv, self.wo = w_uk, w_uv, wo


def init_mla(gen, s: MLASpec, dtype, device=None) -> MLA:
    h, r = s.n_heads, s.kv_lora_rank
    w_dq = init_dense(gen, s.d_model, s.q_lora_rank, dtype, device=device)
    w_uq = init_dense(gen, s.q_lora_rank, h * s.qk_head_dim, dtype, device=device)
    w_dkv = init_dense(gen, s.d_model, r, dtype, device=device)
    w_kr = init_dense(gen, s.d_model, s.qk_rope_head_dim, dtype, device=device)
    w_uk = init_dense(gen, r, h * s.qk_nope_head_dim, dtype, device=device)
    w_uv = init_dense(gen, r, h * s.v_head_dim, dtype, device=device)
    wo = init_dense(gen, h * s.v_head_dim, s.d_model, dtype, device=device)
    return MLA(w_dq, init_rms_norm(s.q_lora_rank, dtype, device), w_uq, w_dkv, init_rms_norm(r, dtype, device),
               w_kr, w_uk, w_uv, wo)


def _latents(p: MLA, s: MLASpec, x: torch.Tensor, positions: torch.Tensor):
    """Compressed KV latent (B, S, r) and rope key (B, S, 1, rope) for a
    full sequence."""
    b, sl, _ = x.shape
    c_kv = rms_norm(p.kv_norm, dense(p.w_dkv, x), s.norm_eps)
    k_rope = dense(p.w_kr, x).reshape(b, sl, 1, s.qk_rope_head_dim)
    return c_kv, apply_rope(k_rope, positions, s.rope_theta)


def _queries(p: MLA, s: MLASpec, x: torch.Tensor, positions: torch.Tensor):
    """Per-head (nope, rope) queries: (B, S, H, qk_nope), (B, S, H, qk_rope)."""
    b, sl, _ = x.shape
    ql = rms_norm(p.q_norm, dense(p.w_dq, x), s.norm_eps)
    q = unflatten(dense(p.w_uq, ql), -1, (s.n_heads, s.qk_head_dim))
    q_nope = q[..., : s.qk_nope_head_dim]
    q_rope = apply_rope(q[..., s.qk_nope_head_dim :], positions, s.rope_theta)
    return q_nope, q_rope


def mla_prefill(p: MLA, s: MLASpec, x: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor | None = None,
                return_cache: bool = False):
    """x: (B, S, D). Standard (expanded) attention. ``impl="dense"`` adds
    ``mask``, the (S, S) additive fp32 causal mask; ``"chunked"`` needs
    none. With ``return_cache`` also returns (c_kv (B, S, r), k_rope (B,
    S, rope)), the decode caches' prefix."""
    b, sl, _ = x.shape
    h = s.n_heads
    c_kv, k_rope = _latents(p, s, x, positions)
    q_nope, q_rope = _queries(p, s, x, positions)
    k_nope = unflatten(dense(p.w_uk, c_kv), -1, (h, s.qk_nope_head_dim))
    v = unflatten(dense(p.w_uv, c_kv), -1, (h, s.v_head_dim))
    q_nope = shard(q_nope, "batch", "seq", "act_heads", None)
    k_nope = shard(k_nope, "batch", "kv_seq", "act_heads", None)
    v = shard(v, "batch", "kv_seq", "act_heads", None)

    scale = 1.0 / math.sqrt(s.qk_head_dim)

    def core(q_nope, q_rope, k_nope, k_rope, v):
        if s.impl != "chunked":
            scores = (
                torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
                + torch.einsum("bqhd,bsxd->bhqs", q_rope, k_rope)
            ).float() * scale
            scores = scores + mask
            w = torch.softmax(scores, dim=-1).to(x.dtype)
            return torch.einsum("bhqs,bshd->bqhd", w, v).flatten(2)
        q_full = torch.cat([q_nope, q_rope], dim=-1)                          # (B, S, H, qk)
        k_full = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], s.qk_rope_head_dim)], dim=-1)
        if x.device.type == "cuda":  # the flash kernel at (qk, v) head dims; its scale is 1/sqrt(qk)
            o = ops.flash_attention(q_full, k_full, v, causal=True)
        else:
            o = chunked_attention(
                q_full[:, :, :, None, :], k_full, v,
                causal=True, window=0, mask_offset=0,
                q_chunk=s.q_chunk, kv_chunk=s.kv_chunk, scale=scale,
            )
        return o.to(x.dtype).flatten(2)

    # per batch row and head: each rank's shards are a whole problem
    q_nope, k_nope, v = match_heads(q_nope, k_nope, v)
    o = local_region(core, q_nope, place_as(q_rope, q_nope), k_nope, place_as(k_rope, q_nope), v)
    y = dense(p.wo, o)
    y = shard(y, "batch", "residual_seq", None)
    if return_cache:
        return y, (c_kv, k_rope.reshape(b, sl, s.qk_rope_head_dim))
    return y


def mla_decode(p: MLA, s: MLASpec, x: torch.Tensor, cache_ckv: torch.Tensor, cache_kr: torch.Tensor, pos: int):
    """Absorbed decode of the token(s) x (B, 1, D) at ``pos``. cache_ckv:
    (B, S, r); cache_kr: (B, S, rope), both written in place at ``pos``.
    Returns (y, cache_ckv, cache_kr): the caches are the same tensors."""
    b, one, _ = x.shape
    h, r = s.n_heads, s.kv_lora_rank
    pvec = torch.full((b, one), pos, dtype=torch.int32, device=x.device)
    c_kv, k_rope = _latents(p, s, x, pvec)
    write_slice(cache_ckv, 1, pos, c_kv.to(cache_ckv.dtype))
    write_slice(cache_kr, 1, pos, k_rope.reshape(b, one, s.qk_rope_head_dim).to(cache_kr.dtype))
    cache_ckv = shard(cache_ckv, "batch", "kv_seq", None)

    q_nope, q_rope = _queries(p, s, x, pvec)
    # absorb w_uk into q: q_lat (B, 1, H, r) = q_nope @ w_uk^T, per head
    w_uk = unflatten(raw_weight(p.w_uk, x.dtype), -1, (h, s.qk_nope_head_dim))
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    scale = 1.0 / math.sqrt(s.qk_head_dim)
    scores = (
        torch.einsum("bqhr,bsr->bhqs", q_lat, cache_ckv)
        + torch.einsum("bqhd,bsd->bhqs", q_rope, cache_kr)
    ).float() * scale
    smax = cache_ckv.shape[1]
    ok = torch.arange(smax, device=x.device) <= pos
    scores = torch.where(replicated_like(scores, ok), scores, -math.inf)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    # summed over the cache's sequence shards here: left partial, DTensor
    # would reduce-scatter it over 40 heads on a 16-way axis, unevenly
    o_lat = reduce_partial(torch.einsum("bhqs,bsr->bqhr", w, cache_ckv))   # (B, 1, H, r)
    # absorb w_uv into the output projection
    w_uv = unflatten(raw_weight(p.w_uv, x.dtype), -1, (h, s.v_head_dim))
    o = flatten(torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv), 2)
    return dense(p.wo, o), cache_ckv, cache_kr

"""Shared model building blocks: parameter modules and the functions over them.

A port of the JAX package's ``models/layers.py``. Parameters live in
``nn.Module``s whose attribute names follow the JAX parameter tree
(``Dense.w``/``.b``/``.w_scale``, ``RMSNorm.scale``, ``Attention.wq``...,
``FFN.gate``/``.up``/``.down``, ``Embedding.table``); the functions take
those modules where the JAX code takes dicts. Dense weights are
``(d_in, d_out)`` with ``y = x @ w``, as in JAX, so a parameter tree moves
between the packages without a transpose.

Conventions, as in the reference: activations in the config dtype; norms,
softmax and rope math in fp32. There are no sharding annotations: the port
runs on one card (the mesh layer is ROADMAP A5).

``mha`` with ``impl="chunked"`` runs the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attn``) on a CUDA tensor and the plain
``chunked_attention`` on a CPU tensor: both compute the same function.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def _param(t: torch.Tensor) -> nn.Parameter:
    # Integer (w8) weights cannot require grad; float ones keep the default
    # so a later training slice can differentiate through the same modules.
    return nn.Parameter(t, requires_grad=t.is_floating_point())


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``(d_in, d_out)``. A w8a16 weight is
    int8 with a float32 ``w_scale`` (see ``quantize_dense_weights``)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None,
                 w_scale: torch.Tensor | None = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)
        self.register_buffer("w_scale", w_scale)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)


class FFN(nn.Module):
    def __init__(self, gate: Dense, up: Dense, down: Dense):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down


class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def _normal(gen: torch.Generator, shape: tuple[int, ...], std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn straight in ``dtype`` on ``device`` from ``gen``
    (no float32 staging copy: a full-width embedding is 1.6 GB in bf16)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)


def init_dense(gen, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: float | None = None, device=None) -> Dense:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = _normal(gen, (d_in, d_out), scale, dtype, device)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w, b)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    w = p.w
    if p.w_scale is not None:  # w8a16 serving weights: int8 + per-tensor scale
        w = w.to(x.dtype) * p.w_scale.to(x.dtype)
    y = x @ w
    if p.b is not None:
        y = y + p.b
    return y


def raw_weight(p: Dense, dtype) -> torch.Tensor:
    """Materialize a dense weight in compute dtype (dequantizing w8)."""
    if p.w_scale is not None:
        return p.w.to(dtype) * p.w_scale.to(dtype)
    return p.w.to(dtype)


@torch.no_grad()
def quantize_dense_weights(model: nn.Module) -> nn.Module:
    """Post-init transform, in place: every 2-D float dense ``w`` becomes
    int8 + a per-tensor float32 ``w_scale`` (w8a16 serving mode). Each
    block's ``Dense`` is one layer, so its scale is per layer, as the JAX
    package's per-layer scale of a stacked ``(G, d_in, d_out)`` weight.
    Norm scales, biases and embeddings keep their dtype."""
    for mod in model.modules():
        if isinstance(mod, Dense) and mod.w_scale is None and mod.w.ndim == 2:
            w = mod.w.float()
            scale = torch.clamp(w.abs().max(), min=1e-8) / 127.0
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            mod.w = _param(q)
            mod.w_scale = scale.to(torch.float32)
    return model


def init_rms_norm(d: int, dtype, device=None) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(dt)


# ----------------------------------------------------------------- rotary --
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- ffn ---
def init_ffn(gen, d_model: int, d_ff: int, dtype, act: str = "silu", device=None) -> FFN:
    _ = act  # activation is a config property, not a parameter
    return FFN(
        init_dense(gen, d_model, d_ff, dtype, device=device),
        init_dense(gen, d_model, d_ff, dtype, device=device),
        init_dense(gen, d_ff, d_model, dtype, device=device),
    )


def _act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def ffn(p: FFN, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = dense(p.gate, x)
    u = dense(p.up, x)
    return dense(p.down, _act_fn(act)(g) * u)


# ------------------------------------------------------------- attention ---
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int = 0            # 0 = global causal; >0 = sliding window
    causal: bool = True
    rope_theta: float = 1e4
    impl: str = "dense"        # "dense" | "chunked" (flash-style, O(S*C) mem)
    q_chunk: int = 2048
    kv_chunk: int = 1024


def init_attention(gen, s: AttnSpec, dtype, device=None) -> Attention:
    return Attention(
        init_dense(gen, s.d_model, s.n_heads * s.head_dim, dtype, bias=s.qkv_bias, device=device),
        init_dense(gen, s.d_model, s.n_kv_heads * s.head_dim, dtype, bias=s.qkv_bias, device=device),
        init_dense(gen, s.d_model, s.n_kv_heads * s.head_dim, dtype, bias=s.qkv_bias, device=device),
        init_dense(gen, s.n_heads * s.head_dim, s.d_model, dtype, device=device),
    )


def chunked_attention(
    qg: torch.Tensor,           # (B, Sq, K, R, hd) grouped queries
    k: torch.Tensor,            # (B, Skv, K, hd)
    v: torch.Tensor,            # (B, Skv, K, vd)
    *,
    causal: bool,
    window: int,
    mask_offset: int,
    q_chunk: int,
    kv_chunk: int,
    scale: float,
) -> torch.Tensor:
    """Flash-style double-chunked attention: O(Sq * kv_chunk) live memory.

    Query chunks and KV chunks are Python loops (the JAX version's
    ``lax.scan`` and its ``unroll_inner`` switch have no use in eager
    torch); the static banded/causal KV range of each query chunk
    (``j_lo``/``j_hi``) skips chunks that are wholly masked, and the
    running max/denominator are fp32. Where the JAX version asserts that
    the chunks divide the lengths, this one also takes ragged lengths: the
    last chunk of each loop is shorter. Returns (B, Sq, K, R, vd) in v's
    dtype.
    """
    b, sq, kh, rep, hd = qg.shape
    skv = k.shape[1]
    vd = v.shape[-1]            # v head dim may differ from qk (MLA)
    cq = min(q_chunk, sq)
    ck = min(kv_chunk, skv)
    n_kv_chunks = -(-skv // ck)
    dev = qg.device

    outs = []
    for q_lo in range(0, sq, cq):
        nq = min(cq, sq - q_lo)
        q_abs = q_lo + mask_offset                        # kv-pos of chunk start
        j_hi = n_kv_chunks if not causal else min(n_kv_chunks, (q_abs + nq - 1) // ck + 1)
        j_lo = 0 if window <= 0 else max(0, (q_abs - window + 1) // ck)
        j_lo = min(j_lo, max(j_hi - 1, 0))
        qc = qg[:, q_lo : q_lo + nq].float()              # (B,Cq,K,R,hd)
        qpos = torch.arange(nq, device=dev)[:, None] + q_abs  # (Cq, 1)

        m = torch.full((b, kh, rep, nq), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kh, rep, nq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, rep, nq, vd), dtype=torch.float32, device=dev)
        for j in range(j_lo, j_hi):
            kc = k[:, j * ck : (j + 1) * ck].float()
            vc = v[:, j * ck : (j + 1) * ck].float()
            kpos = torch.arange(j * ck, j * ck + kc.shape[1], device=dev)[None, :]  # (1, Ck)
            s = torch.einsum("bqkrh,bskh->bkrqs", qc, kc) * scale
            ok = torch.ones((nq, kc.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (kpos <= qpos)
            if window > 0:
                ok = ok & (kpos > qpos - window)
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard: fully-masked rows keep m = -inf; exp(-inf - -inf) -> nan
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkrqs,bskh->bkrqh", p, vc)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)    # (B,K,R,Cq,vd)
        # downcast at the chunk boundary: everything downstream runs in the
        # compute dtype, not fp32
        outs.append(torch.movedim(o, 3, 1).to(v.dtype))  # (B,Cq,K,R,vd)
    return torch.cat(outs, dim=1)


def _attn_mask(sq: int, skv: int, offset: int, window: int, causal: bool, device=None) -> torch.Tensor:
    """(sq, skv) additive mask in fp32. offset = kv index of query 0."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (ki <= qi)
    if window > 0:
        ok = ok & (ki > qi - window)
    return torch.where(ok, 0.0, -math.inf).float()


def mha(
    p: Attention,
    s: AttnSpec,
    x: torch.Tensor,                  # (B, S, D)
    positions: torch.Tensor,          # (B, S)
    kv_x: torch.Tensor | None = None,  # cross-attention source
    kv_positions: torch.Tensor | None = None,
    mask_offset: int = 0,
    use_rope: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill / encoder / cross).

    ``impl="chunked"`` self-attention runs the flash-attention kernel on a
    CUDA tensor (``ops.flash_attention``) and the plain ``chunked_attention``
    on a CPU tensor. The kernel takes ``mask_offset == 0`` only: any other
    offset on a CUDA tensor raises rather than taking the plain route. The
    kernel is forward only, so on a CUDA tensor this raises under grad when
    the inputs require grad (train through ``impl="dense"``); the CPU route
    is differentiable."""
    b, sq, _ = x.shape
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    q = dense(p.wq, x).reshape(b, sq, s.n_heads, s.head_dim)
    k = dense(p.wk, src).reshape(b, skv, s.n_kv_heads, s.head_dim)
    v = dense(p.wv, src).reshape(b, skv, s.n_kv_heads, s.head_dim)
    if use_rope:
        q = apply_rope(q, positions, s.rope_theta)
        kpos = positions if kv_positions is None else kv_positions
        k = apply_rope(k, kpos, s.rope_theta)

    rep = s.n_heads // s.n_kv_heads
    if s.impl == "chunked" and kv_x is None and x.device.type == "cuda":
        if mask_offset != 0:
            raise ValueError(f"the flash kernel takes mask_offset 0 only, got {mask_offset}")
        o = ops.flash_attention(q, k, v, causal=s.causal, window=s.window)
        o = o.to(x.dtype).reshape(b, sq, s.n_heads * s.head_dim)
    elif s.impl == "chunked" and kv_x is None:
        qg = q.reshape(b, sq, s.n_kv_heads, rep, s.head_dim)
        o = chunked_attention(
            qg, k, v,
            causal=s.causal, window=s.window, mask_offset=mask_offset,
            q_chunk=s.q_chunk, kv_chunk=s.kv_chunk,
            scale=1.0 / math.sqrt(s.head_dim),
        ).to(x.dtype).reshape(b, sq, s.n_heads * s.head_dim)
    else:
        qg = q.reshape(b, sq, s.n_kv_heads, rep, s.head_dim)
        scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float()
        scores = scores / math.sqrt(s.head_dim)
        if kv_x is None:  # self-attention mask
            scores = scores + _attn_mask(sq, skv, mask_offset, s.window, s.causal, x.device)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bkrqs,bskh->bqkrh", w, v).reshape(b, sq, s.n_heads * s.head_dim)
    y = dense(p.wo, o)
    if return_kv:
        return y, (k, v)
    return y


# symmetric fixed-point scale for int8 KV quantization (kv8 serving mode);
# post-rope keys and values are O(1), so +-8.0 full-scale keeps headroom.
KV_SCALE = 8.0 / 127.0


def _kv_quant(x: torch.Tensor, cache_dtype) -> torch.Tensor:
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_SCALE), -127, 127).to(torch.int8)
    return x.to(cache_dtype)


def _kv_dequant(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.float() * KV_SCALE
    return x


def mha_decode(
    p: Attention,
    s: AttnSpec,
    x: torch.Tensor,            # (B, 1, D) new token(s)
    cache_k: torch.Tensor,      # (B, S_max, K, hd)
    cache_v: torch.Tensor,
    pos: int,                   # index of the new token
    use_rope: bool = True,
):
    """Single-token decode against a KV cache. Returns (y, cache_k, cache_v).

    The new token's k/v are written into the caches in place (the JAX
    version returns updated copies); the returned caches are the same
    tensors."""
    b, one, _ = x.shape
    smax = cache_k.shape[1]
    q = dense(p.wq, x).reshape(b, one, s.n_heads, s.head_dim)
    k = dense(p.wk, x).reshape(b, one, s.n_kv_heads, s.head_dim)
    v = dense(p.wv, x).reshape(b, one, s.n_kv_heads, s.head_dim)
    if use_rope:
        pvec = torch.full((b, one), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pvec, s.rope_theta)
        k = apply_rope(k, pvec, s.rope_theta)
    cache_k[:, pos : pos + one] = _kv_quant(k, cache_k.dtype)
    cache_v[:, pos : pos + one] = _kv_quant(v, cache_v.dtype)

    rep = s.n_heads // s.n_kv_heads
    qg = q.reshape(b, one, s.n_kv_heads, rep, s.head_dim)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg.float(), _kv_dequant(cache_k).float())
    scores = scores / math.sqrt(s.head_dim)
    ki = torch.arange(smax, device=x.device)
    ok = ki <= pos
    if s.window > 0:
        ok = ok & (ki > pos - s.window)
    scores = torch.where(ok, scores, -math.inf)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum(
        "bkrqs,bskh->bqkrh", w.float(), _kv_dequant(cache_v).float()
    ).to(x.dtype).reshape(b, one, s.n_heads * s.head_dim)
    y = dense(p.wo, o)
    return y, cache_k, cache_v


# ------------------------------------------------------------- embedding ---
def init_embedding(gen, vocab: int, d_model: int, dtype, device=None) -> Embedding:
    return Embedding(_normal(gen, (vocab, d_model), 0.02, dtype, device))


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    return x @ p.table.T

"""Whisper-style encoder-decoder backbone (conv/audio frontend stubbed).

A port of the JAX package's ``models/encdec.py``. Encoder: bidirectional
self-attention blocks over precomputed frame embeddings (the stub input).
Decoder: causal self-attention + cross-attention blocks. Attention runs
``impl="dense"``, as the reference's ``_spec`` leaves it, so no kernel of
ours is on this model's path.

Parameters live in an ``EncDecLM`` module named as the JAX ``init_encdec``
tree: ``embed``, ``enc_blocks`` (``norm1``, ``attn``, ``norm2``, ``ffn``),
``dec_blocks`` (``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``,
``norm2``, ``ffn``), ``enc_norm``, ``final_norm``; the JAX package stacks
each stack's layers on a leading axis, here they are ``nn.ModuleList``s.
The caches keep the JAX layout, ``{"self": {"k", "v"}, "cross": {"k",
"v"}}`` with the layer axis first.

``encode`` and ``decode_train`` run each layer under activation
checkpointing when grad is enabled, as the reference's ``jax.checkpoint``.
``encdec_decode`` writes the self caches in place; the prefill's self
caches hold exactly the prompt's positions, and a decode position past
them raises (the reference's ``dynamic_update_slice`` clamps it silently):
a caller that decodes further pads the caches itself.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import empty_stacked, flatten, unflatten, write_slice
from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, TensorSpec


def _spec(cfg: ModelConfig, causal: bool) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        causal=causal,
        rope_theta=cfg.rope_theta,
    )


class DecBlock(nn.Module):
    def __init__(self, norm1: L.RMSNorm, self_attn: L.Attention, norm_x: L.RMSNorm, cross_attn: L.Attention,
                 norm2: L.RMSNorm, ffn: L.FFN):
        super().__init__()
        self.norm1, self.self_attn, self.norm_x, self.cross_attn = norm1, self_attn, norm_x, cross_attn
        self.norm2, self.ffn = norm2, ffn


class EncDecLM(nn.Module):
    def __init__(self, embed: L.Embedding, enc_blocks: list[Block], dec_blocks: list[DecBlock],
                 enc_norm: L.RMSNorm, final_norm: L.RMSNorm):
        super().__init__()
        self.embed = embed
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.enc_norm, self.final_norm = enc_norm, final_norm


def _init_enc_layer(gen, cfg: ModelConfig, device) -> Block:
    dt = cfg.param_dtype
    return Block(L.init_rms_norm(cfg.d_model, dt, device), L.init_attention(gen, _spec(cfg, False), dt, device),
                 L.init_rms_norm(cfg.d_model, dt, device),
                 L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, cfg.act, device))


def _init_dec_layer(gen, cfg: ModelConfig, device) -> DecBlock:
    dt = cfg.param_dtype
    return DecBlock(
        L.init_rms_norm(cfg.d_model, dt, device), L.init_attention(gen, _spec(cfg, True), dt, device),
        L.init_rms_norm(cfg.d_model, dt, device), L.init_attention(gen, _spec(cfg, False), dt, device),
        L.init_rms_norm(cfg.d_model, dt, device), L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, cfg.act, device),
    )


def init_encdec(gen, cfg: ModelConfig, device=None) -> EncDecLM:
    enc = [_init_enc_layer(gen, cfg, device) for _ in range(cfg.n_enc_layers)]
    dec = [_init_dec_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    return EncDecLM(L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device), enc, dec,
                    L.init_rms_norm(cfg.d_model, cfg.param_dtype, device),
                    L.init_rms_norm(cfg.d_model, cfg.param_dtype, device))


def _remat(body, x, *args):
    """``body(x, *args)``, under activation checkpointing when grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(body, x, *args, use_reentrant=False)
    return body(x, *args)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def encode(params: EncDecLM, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings (frontend stub)."""
    b, s_enc, _ = frames.shape
    positions = _positions(b, s_enc, frames.device)

    def body(x, lp):
        h = L.rms_norm(lp.norm1, x, cfg.norm_eps)
        x = x + L.mha(lp.attn, _spec(cfg, False), h, positions)
        return x + L.ffn(lp.ffn, L.rms_norm(lp.norm2, x, cfg.norm_eps), cfg.act)

    x = frames
    for lp in params.enc_blocks:
        x = _remat(body, x, lp)
    return L.rms_norm(params.enc_norm, x, cfg.norm_eps)


def _dec_block(lp: DecBlock, cfg: ModelConfig, x, positions, enc_out, enc_positions, want_cache: bool):
    h = L.rms_norm(lp.norm1, x, cfg.norm_eps)
    cache = None
    if want_cache:
        y, (k, v) = L.mha(lp.self_attn, _spec(cfg, True), h, positions, return_kv=True)
        cache = {"k": k, "v": v}
    else:
        y = L.mha(lp.self_attn, _spec(cfg, True), h, positions)
    x = x + y
    hx = L.rms_norm(lp.norm_x, x, cfg.norm_eps)
    x = x + L.mha(lp.cross_attn, _spec(cfg, False), hx, positions,
                  kv_x=enc_out, kv_positions=enc_positions, use_rope=False)
    x = x + L.ffn(lp.ffn, L.rms_norm(lp.norm2, x, cfg.norm_eps), cfg.act)
    return x, cache


def decode_train(params: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    b, s_dec = tokens.shape
    positions = _positions(b, s_dec, tokens.device)
    enc_pos = _positions(b, enc_out.shape[1], tokens.device)
    x = L.embed(params.embed, tokens)

    def body(x, lp):
        return _dec_block(lp, cfg, x, positions, enc_out, enc_pos, False)[0]

    for lp in params.dec_blocks:
        x = _remat(body, x, lp)
    x = L.rms_norm(params.final_norm, x, cfg.norm_eps)
    return L.unembed(params.embed, x)


def encdec_prefill(params: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor):
    """Returns (logits, caches) with caches = {"self": {k, v}, "cross":
    {k, v}}, each (L, B, S, K, hd): the self caches hold the S_dec prompt
    positions, the cross caches the encoder's K/V of each layer."""
    enc_out = encode(params, cfg, frames)
    b, s_dec = tokens.shape
    s_enc = enc_out.shape[1]
    positions = _positions(b, s_dec, tokens.device)
    enc_pos = _positions(b, s_enc, tokens.device)
    spec = _spec(cfg, False)
    x = L.embed(params.embed, tokens)
    caches: dict[str, dict[str, torch.Tensor]] = {"self": {}, "cross": {}}
    for i, lp in enumerate(params.dec_blocks):
        x, self_kv = _dec_block(lp, cfg, x, positions, enc_out, enc_pos, True)
        cross_kv = {
            "k": unflatten(L.dense(lp.cross_attn.wk, enc_out), -1, (spec.n_kv_heads, spec.head_dim)),
            "v": unflatten(L.dense(lp.cross_attn.wv, enc_out), -1, (spec.n_kv_heads, spec.head_dim)),
        }
        for part, kv in (("self", self_kv), ("cross", cross_kv)):
            for name, t in kv.items():
                if name not in caches[part]:
                    caches[part][name] = empty_stacked(cfg.n_layers, t)
                write_slice(caches[part][name], 0, i, t.unsqueeze(0))
    x = L.rms_norm(params.final_norm, x, cfg.norm_eps)
    return L.unembed(params.embed, x), caches


def encdec_decode(params: EncDecLM, cfg: ModelConfig, caches, token: torch.Tensor, pos: int):
    """One-token decode. caches: {"self": {k, v}, "cross": {k, v}} as
    ``encdec_prefill`` returns them; the self caches are written in place
    and the same structure is returned. Raises ``IndexError`` when ``pos``
    is past the self caches' slots."""
    s_self = caches["self"]["k"].shape[2]
    if not 0 <= pos < s_self:
        raise IndexError(f"decode position {pos} is outside the self caches' {s_self} slots")
    b = token.shape[0]
    x = L.embed(params.embed, token)
    spec_self, spec_cross = _spec(cfg, True), _spec(cfg, False)
    rep = spec_cross.n_heads // spec_cross.n_kv_heads
    hd = spec_cross.head_dim
    for i, lp in enumerate(params.dec_blocks):
        h = L.rms_norm(lp.norm1, x, cfg.norm_eps)
        y, _, _ = L.mha_decode(lp.self_attn, spec_self, h, caches["self"]["k"][i], caches["self"]["v"][i], pos)
        x = x + y
        hx = L.rms_norm(lp.norm_x, x, cfg.norm_eps)
        # cross attention against the precomputed encoder K/V (no mask, no
        # rope), in the model dtype up to the fp32 softmax, as the reference
        kx, vx = caches["cross"]["k"][i], caches["cross"]["v"][i]
        q = unflatten(L.dense(lp.cross_attn.wq, hx), -1, (spec_cross.n_heads, hd))
        qg = unflatten(q, 2, (spec_cross.n_kv_heads, rep))
        sc = torch.einsum("bqkrh,bskh->bkrqs", qg, kx).float() / math.sqrt(hd)
        w = torch.softmax(sc, dim=-1).to(x.dtype)
        o = flatten(torch.einsum("bkrqs,bskh->bqkrh", w, vx), 2)
        x = x + L.dense(lp.cross_attn.wo, o)
        x = x + L.ffn(lp.ffn, L.rms_norm(lp.norm2, x, cfg.norm_eps), cfg.act)
    x = L.rms_norm(params.final_norm, x, cfg.norm_eps)
    return L.unembed(params.embed, x), caches


def encdec_cache_specs(cfg: ModelConfig, batch: int, s_dec: int, s_enc: int):
    dt = cfg.param_dtype
    hd = cfg.resolved_head_dim

    def kv(s):
        shp = (cfg.n_layers, batch, s, cfg.n_kv_heads, hd)
        return {"k": TensorSpec(shp, dt), "v": TensorSpec(shp, dt)}

    return {"self": kv(s_dec), "cross": kv(s_enc)}

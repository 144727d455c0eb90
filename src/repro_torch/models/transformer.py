"""Decoder-LM assembly for dense decoders: pattern-grouped blocks.

A port of the JAX package's ``models/transformer.py`` for the block kind
this slice carries, ``attn_global`` (global causal attention plus an FFN).
The other kinds raise ``NotImplementedError`` naming their ROADMAP item.

The JAX package stacks the parameters of all groups of the repeating
``block_pattern`` on a leading axis and scans over them; here the blocks are
an ``nn.ModuleList`` in layer order (layer ``g * pattern_len + i`` is
pattern position ``i`` of group ``g``) and the scan is a Python loop. The
decode caches keep the JAX layout, ``(scanned, tail)``, where
``scanned[i]["k"]`` is ``(G, B, S_max, K, hd)``: the server slices
it and stores those bytes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# Block kinds of the JAX package that later slices port (ROADMAP queue A).
_NOT_PORTED = {
    "attn_local": "sliding-window attention with its ring cache, ROADMAP A4a",
    "mla": "multi-head latent attention, ROADMAP A4b",
    "moe": "mixture of experts, ROADMAP A4c",
    "mamba2": "the Mamba-2 SSM, ROADMAP A4c",
    "rglru": "the RG-LRU recurrence, ROADMAP A4c",
}


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor (the port's ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def zeros_from_specs(specs, device):
    """Materialize a (nested tuple/dict) tree of ``TensorSpec`` as zeros."""
    if isinstance(specs, TensorSpec):
        return torch.zeros(specs.shape, dtype=specs.dtype, device=device)
    if isinstance(specs, dict):
        return {k: zeros_from_specs(v, device) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(zeros_from_specs(v, device) for v in specs)
    return specs


def check_kind(kind: str) -> None:
    if kind == "attn_global":
        return
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    raise ValueError(kind)


# ------------------------------------------------------------ block specs --
def _attn_spec(cfg: ModelConfig, local: bool) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        window=cfg.window if local else 0,
        rope_theta=cfg.rope_theta,
        impl=cfg.attn_impl,
        q_chunk=cfg.attn_q_chunk,
        kv_chunk=cfg.attn_kv_chunk,
    )


class Block(nn.Module):
    """One ``attn_global`` block: ``norm1``, ``attn``, and with ``d_ff`` an
    FFN behind ``norm2``."""

    def __init__(self, norm1: L.RMSNorm, attn: L.Attention,
                 norm2: L.RMSNorm | None = None, ffn: L.FFN | None = None):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn, norm2, ffn


class DecoderLM(nn.Module):
    """The decoder's parameters, named as the JAX ``init_decoder`` tree:
    ``embed``, ``final_norm``, ``lm_head`` (absent when embeddings are
    tied), ``blocks`` (layer order) and ``tail``."""

    def __init__(self, embed: L.Embedding, final_norm: L.RMSNorm, lm_head: L.Dense | None,
                 blocks: list[Block], tail: list[Block]):
        super().__init__()
        self.embed, self.final_norm, self.lm_head = embed, final_norm, lm_head
        self.blocks = nn.ModuleList(blocks)
        self.tail = nn.ModuleList(tail)


# ------------------------------------------------------------- block init --
def init_block(gen, cfg: ModelConfig, kind: str, device=None) -> Block:
    check_kind(kind)
    dt = cfg.param_dtype
    norm1 = L.init_rms_norm(cfg.d_model, dt, device)
    attn = L.init_attention(gen, _attn_spec(cfg, False), dt, device)
    if not cfg.d_ff:
        return Block(norm1, attn)
    return Block(norm1, attn, L.init_rms_norm(cfg.d_model, dt, device),
                 L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, cfg.act, device))


# ------------------------------------------------------ full-seq block fwd --
def _pad_seq(t: torch.Tensor, smax: int) -> torch.Tensor:
    """Pad a (B, S, ...) cache tensor out to smax slots."""
    s = t.shape[1]
    if smax <= s:
        return t
    pad = [0, 0] * (t.ndim - 2) + [0, smax - s]
    return F.pad(t, pad)


def block_fwd(p: Block, cfg: ModelConfig, kind: str, x, positions, want_cache: bool, smax: int = 0):
    """Train (want_cache=False) / prefill (True) forward of one block.
    Returns (x, cache_or_None, aux_loss). smax sizes the decode cache
    (>= S so decode can continue past the prefill length)."""
    check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(p.norm1, x, cfg.norm_eps)
    spec = _attn_spec(cfg, False)
    cache = None
    if want_cache:
        y, (k, v) = L.mha(p.attn, spec, h, positions, return_kv=True)
        cache = {"k": _pad_seq(k, smax), "v": _pad_seq(v, smax)}
    else:
        y = L.mha(p.attn, spec, h, positions)
    x = x + y
    if p.ffn is not None:
        x = x + L.ffn(p.ffn, L.rms_norm(p.norm2, x, cfg.norm_eps), cfg.act)
    return x, cache, aux


# -------------------------------------------------------------- decode fwd --
def block_decode(p: Block, cfg: ModelConfig, kind: str, x, cache, pos: int):
    """One-token decode. Returns (x, cache); the cache tensors are updated
    in place."""
    check_kind(kind)
    h = L.rms_norm(p.norm1, x, cfg.norm_eps)
    y, ck, cv = L.mha_decode(p.attn, _attn_spec(cfg, False), h, cache["k"], cache["v"], pos)
    x = x + y
    if p.ffn is not None:
        x = x + L.ffn(p.ffn, L.rms_norm(p.norm2, x, cfg.norm_eps), cfg.act)
    return x, {"k": ck, "v": cv}


# ----------------------------------------------------------- cache specs ---
def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, smax: int, dtype):
    """``TensorSpec`` tree of one block's decode cache."""
    check_kind(kind)
    kv_dt = torch.int8 if cfg.kv_cache_quant else dtype
    shp = (batch, smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shp, kv_dt), "v": TensorSpec(shp, kv_dt)}


# ------------------------------------------------------------ full model ---
def init_decoder(gen, cfg: ModelConfig, device=None) -> DecoderLM:
    cfg.validate()
    for kind in cfg.block_pattern:
        check_kind(kind)
    dt = cfg.param_dtype
    embed = L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    final_norm = L.init_rms_norm(cfg.d_model, dt, device)
    lm_head = None if cfg.tie_embeddings else L.init_dense(gen, cfg.d_model, cfg.padded_vocab, dt, device=device)
    blocks = [
        init_block(gen, cfg, kind, device)
        for _ in range(cfg.n_groups)
        for kind in cfg.block_pattern
    ]
    tail = [init_block(gen, cfg, kind, device) for kind in cfg.tail_blocks]
    return DecoderLM(embed, final_norm, lm_head, blocks, tail)


# The products remat="dots" keeps: matmuls without batch dims, the
# counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the activation checkpointing ``cfg.remat`` names:
    "none" keeps every activation, "dots" recomputes all but the saved
    products in the backward pass, "full" recomputes the whole group."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_dots),
        )
    return functools.partial(checkpoint, fn, use_reentrant=False)


def decoder_hidden(params: DecoderLM, cfg: ModelConfig, x, positions):
    """Training forward through all blocks. Returns (hidden, aux_loss).
    Each group of ``block_pattern`` runs under ``_remat``; the tail blocks
    run as they are, as in the reference."""
    pl = cfg.pattern_len

    def group_body(x, aux, *blocks):
        for blk, kind in zip(blocks, cfg.block_pattern):
            x, _, a = block_fwd(blk, cfg, kind, x, positions, want_cache=False)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(cfg, group_body)
    for g in range(cfg.n_groups):
        x, aux = body(x, aux, *params.blocks[g * pl : (g + 1) * pl])
    for i, kind in enumerate(cfg.tail_blocks):
        x, _, a = block_fwd(params.tail[i], cfg, kind, x, positions, want_cache=False)
        aux = aux + a
    return L.rms_norm(params.final_norm, x, cfg.norm_eps), aux


def decoder_prefill(params: DecoderLM, cfg: ModelConfig, x, positions, smax: int = 0):
    """Prefill forward; returns (hidden, caches) where caches =
    (scanned: tuple-per-pattern-pos with leading G, tail: tuple).
    smax >= S sizes the KV caches for continued decoding. Each layer's
    cache is written straight into its slot of the stacked tensors."""
    smax = max(smax, x.shape[1])
    pl = cfg.pattern_len
    scanned: list[dict[str, torch.Tensor]] | None = [{} for _ in cfg.block_pattern] if cfg.n_groups else None
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            x, c, _ = block_fwd(params.blocks[g * pl + i], cfg, kind, x, positions, want_cache=True, smax=smax)
            for name, t in c.items():
                if name not in scanned[i]:
                    scanned[i][name] = torch.empty((cfg.n_groups, *t.shape), dtype=t.dtype, device=t.device)
                scanned[i][name][g] = t
    tail = []
    for i, kind in enumerate(cfg.tail_blocks):
        x, c, _ = block_fwd(params.tail[i], cfg, kind, x, positions, want_cache=True, smax=smax)
        tail.append(c)
    scanned_t = tuple(scanned) if scanned is not None else None
    return L.rms_norm(params.final_norm, x, cfg.norm_eps), (scanned_t, tuple(tail))


def decoder_decode(params: DecoderLM, cfg: ModelConfig, caches, x, pos: int):
    """One-token decode; returns (hidden, caches). The cache tensors are
    updated in place and returned as the same structure."""
    scanned, tail = caches
    pl = cfg.pattern_len
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            gc = {name: t[g] for name, t in scanned[i].items()}
            x, _ = block_decode(params.blocks[g * pl + i], cfg, kind, x, gc, pos)
    for i, kind in enumerate(cfg.tail_blocks):
        x, _ = block_decode(params.tail[i], cfg, kind, x, tail[i], pos)
    return L.rms_norm(params.final_norm, x, cfg.norm_eps), caches


def logits_from_hidden(params: DecoderLM, cfg: ModelConfig, hidden):
    if cfg.tie_embeddings:
        return L.unembed(params.embed, hidden)
    return L.dense(params.lm_head, hidden)


def decoder_cache_specs(cfg: ModelConfig, batch: int, smax: int):
    dt = cfg.param_dtype
    scanned = None
    if cfg.n_groups:
        scanned = tuple(
            {name: TensorSpec((cfg.n_groups, *s.shape), s.dtype) for name, s in
             block_cache_spec(cfg, kind, batch, smax, dt).items()}
            for kind in cfg.block_pattern
        )
    tail = tuple(block_cache_spec(cfg, kind, batch, smax, dt) for kind in cfg.tail_blocks)
    return (scanned, tail)

"""Decoder-LM assembly: pattern-grouped blocks.

A port of the JAX package's ``models/transformer.py`` for the block kinds
``attn_global`` (global causal attention), ``attn_local`` (sliding-window
attention with a ring-buffer KV cache of exactly ``window`` slots: Gemma3,
RecurrentGemma) and ``rglru`` (the RG-LRU recurrence, ``models/ssm.py``:
RecurrentGemma) and ``mla`` (multi-head latent attention, ``models/mla.py``:
MiniCPM3), each with an FFN when ``d_ff``; ``moe`` (global attention,
then the routed FFN of ``models/moe.py`` behind ``norm2``: Qwen1.5-MoE,
Llama-4-Scout) and ``mamba2`` (the SSD mixer alone: Mamba2). The port adds
``mamba2_moe`` (the SSD mixer, then the routed FFN behind ``norm2``:
Granite-4.0-H, whose attention layers are ``moe`` blocks without rotary
embedding), and the config's muP residual multiplier, which scales each
branch's output before its residual add (skipped at 1).

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
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    empty_stacked, flatten, local_region, replicated_like, shard, unflatten, whole_on, write_slice,
)
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

_PORTED = ("attn_global", "attn_local", "mla", "moe", "mamba2", "mamba2_moe", "rglru")


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
    if kind not in _PORTED:
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
        rope=cfg.position_embedding == "rope",
        scale=cfg.attn_scale,
    )


def _mla_spec(cfg: ModelConfig) -> MLA.MLASpec:
    return MLA.MLASpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps,
        impl=cfg.attn_impl,
        q_chunk=cfg.attn_q_chunk,
        kv_chunk=cfg.attn_kv_chunk,
    )


def _moe_spec(cfg: ModelConfig) -> MOE.MoESpec:
    return MOE.MoESpec(
        d_model=cfg.d_model,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        expert_d_ff=cfg.expert_d_ff,
        n_shared_experts=cfg.n_shared_experts,
        shared_d_ff=cfg.shared_d_ff,
        capacity_factor=cfg.capacity_factor,
        moe_group=cfg.moe_group,
        act=cfg.act,
        route=cfg.moe_route,
        first_expert=cfg.first_held_expert,
        n_held=cfg.n_held_experts,
    )


def _mamba_spec(cfg: ModelConfig) -> SSM.MambaSpec:
    return SSM.MambaSpec(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand,
        d_conv=cfg.ssm_conv,
        chunk=cfg.ssm_chunk,
        norm_eps=cfg.ssm_norm_eps,
    )


def _rglru_spec(cfg: ModelConfig) -> SSM.RGLRUSpec:
    return SSM.RGLRUSpec(
        d_model=cfg.d_model,
        width=cfg.rglru_width,
        n_blocks=cfg.rglru_blocks,
        d_conv=cfg.ssm_conv,
    )


class Block(nn.Module):
    """One block: ``norm1``, then ``attn`` (the attention kinds and
    ``moe``; an ``MLA`` for ``mla``) or ``mixer`` (``rglru``, ``mamba2``,
    ``mamba2_moe``); behind ``norm2`` the routed ``moe`` FFN (``moe``,
    ``mamba2_moe``), or with ``d_ff`` an FFN (not for ``mamba2``)."""

    def __init__(self, norm1: L.RMSNorm, attn: L.Attention | MLA.MLA | None,
                 norm2: L.RMSNorm | None = None, ffn: L.FFN | None = None,
                 mixer: SSM.RGLRU | SSM.Mamba2 | None = None, moe: MOE.MoE | None = None):
        super().__init__()
        self.norm1, self.attn, self.mixer, self.norm2, self.ffn = norm1, attn, mixer, norm2, ffn
        self.moe = moe


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
    attn = mixer = None
    if kind == "mamba2":  # the mamba2 stack has no separate FFN (d_ff == 0)
        return Block(norm1, None, mixer=SSM.init_mamba(gen, _mamba_spec(cfg), dt, device))
    if kind == "mamba2_moe":
        return Block(norm1, None, L.init_rms_norm(cfg.d_model, dt, device),
                     mixer=SSM.init_mamba(gen, _mamba_spec(cfg), dt, device),
                     moe=MOE.init_moe(gen, _moe_spec(cfg), dt, device))
    if kind == "rglru":
        mixer = SSM.init_rglru(gen, _rglru_spec(cfg), dt, device)
    elif kind == "mla":
        attn = MLA.init_mla(gen, _mla_spec(cfg), dt, device)
    else:
        attn = L.init_attention(gen, _attn_spec(cfg, kind == "attn_local"), dt, device)
    if kind == "moe":
        return Block(norm1, attn, L.init_rms_norm(cfg.d_model, dt, device),
                     moe=MOE.init_moe(gen, _moe_spec(cfg), dt, device))
    if not cfg.d_ff:
        return Block(norm1, attn, mixer=mixer)
    return Block(norm1, attn, L.init_rms_norm(cfg.d_model, dt, device),
                 L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, cfg.act, device), mixer=mixer)


# ------------------------------------------------------ full-seq block fwd --
def _pad_seq(t: torch.Tensor, smax: int) -> torch.Tensor:
    """Pad a (B, S, ...) cache tensor out to smax slots (on each rank's
    shard: a prefill's sequence is whole on every rank)."""
    s = t.shape[1]
    if smax <= s:
        return t
    pad = [0, 0] * (t.ndim - 2) + [0, smax - s]
    return local_region(lambda x: F.pad(x, pad), whole_on(t, 1))


def block_fwd(p: Block, cfg: ModelConfig, kind: str, x, positions, want_cache: bool, smax: int = 0):
    """Train (want_cache=False) / prefill (True) forward of one block.
    Returns (x, cache_or_None, aux_loss). smax sizes the decode cache
    (>= S so decode can continue past the prefill length)."""
    check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(p.norm1, x, cfg.norm_eps)
    cache = None
    if kind in ("rglru", "mamba2", "mamba2_moe"):
        prefill, spec = (SSM.rglru_prefill, _rglru_spec(cfg)) if kind == "rglru" \
            else (SSM.mamba_prefill, _mamba_spec(cfg))
        if want_cache:
            y, (state, conv) = prefill(p.mixer, spec, h, True)
            cache = {"state": state, "conv": conv}
        else:
            y = prefill(p.mixer, spec, h)
    elif kind == "mla":
        spec = _mla_spec(cfg)
        sl = x.shape[1]
        mask = L._attn_mask(sl, sl, 0, 0, True, x.device) if spec.impl != "chunked" else None
        if want_cache:
            y, (ckv, kr) = MLA.mla_prefill(p.attn, spec, h, positions, mask, True)
            cache = {"ckv": _pad_seq(ckv, smax), "kr": _pad_seq(kr, smax)}
        else:
            y = MLA.mla_prefill(p.attn, spec, h, positions, mask)
    else:
        spec = _attn_spec(cfg, kind == "attn_local")
        if want_cache:
            y, (k, v) = L.mha(p.attn, spec, h, positions, return_kv=True)
            cache = _ring_cache_from_prefill(cfg, k, v) if kind == "attn_local" \
                else {"k": _pad_seq(k, smax), "v": _pad_seq(v, smax)}
        else:
            y = L.mha(p.attn, spec, h, positions)
    x = x + _branch(cfg, y)
    if p.moe is not None:
        y2, aux = MOE.moe_ffn(p.moe, _moe_spec(cfg), L.rms_norm(p.norm2, x, cfg.norm_eps))
        return x + _branch(cfg, y2), cache, aux
    if p.ffn is not None:
        x = x + _branch(cfg, L.ffn(p.ffn, L.rms_norm(p.norm2, x, cfg.norm_eps), cfg.act))
    return x, cache, aux


def _branch(cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """A branch's output as its residual add takes it: times the muP
    ``residual_multiplier``, which is skipped where it is 1."""
    return y if cfg.residual_multiplier == 1.0 else y * cfg.residual_multiplier


def _ring_cache_from_prefill(cfg: ModelConfig, k, v) -> dict[str, torch.Tensor]:
    """Convert full prefill K/V into a window-sized ring buffer: position t
    sits in slot t % window, ``pos_idx`` holds each slot's position (-1:
    empty). The ring keeps the prefill's k/v dtype, as in the reference,
    also under ``kv_cache_quant``."""
    w = cfg.window
    b, sl, kh, hd = k.shape
    if sl >= w:
        absi = torch.arange(sl - w, sl, device=k.device)
        slots = absi % w

        def ring(t):  # per batch row and head: a rank's shard is a whole ring
            r = torch.zeros((t.shape[0], w, *t.shape[2:]), dtype=t.dtype, device=t.device)
            r[:, slots] = t[:, sl - w :]
            return r

        rk, rv = local_region(ring, k), local_region(ring, v)
        pos_idx = torch.zeros((w,), dtype=torch.int32, device=k.device)
        pos_idx[slots] = absi.to(torch.int32)
    else:
        rk, rv = _pad_seq(k, w), _pad_seq(v, w)
        pos_idx = torch.cat([torch.arange(sl, dtype=torch.int32, device=k.device),
                             torch.full((w - sl,), -1, dtype=torch.int32, device=k.device)])
    return {"k": rk, "v": rv, "pos_idx": replicated_like(k, pos_idx)}


# -------------------------------------------------------------- decode fwd --
def block_decode(p: Block, cfg: ModelConfig, kind: str, x, cache, pos: int):
    """One-token decode. Returns (x, cache); the cache tensors are updated
    in place."""
    check_kind(kind)
    h = L.rms_norm(p.norm1, x, cfg.norm_eps)
    if kind in ("attn_global", "moe"):
        y, ck, cv = L.mha_decode(p.attn, _attn_spec(cfg, False), h, cache["k"], cache["v"], pos)
        cache = {"k": ck, "v": cv}
    elif kind == "attn_local":
        y, cache = _local_decode(p.attn, cfg, h, cache, pos)
    elif kind == "mla":
        y, ckv, kr = MLA.mla_decode(p.attn, _mla_spec(cfg), h, cache["ckv"], cache["kr"], pos)
        cache = {"ckv": ckv, "kr": kr}
    elif kind in ("mamba2", "mamba2_moe"):
        y, st, cv = SSM.mamba_decode(p.mixer, _mamba_spec(cfg), h, cache["state"], cache["conv"])
        cache = {"state": st, "conv": cv}
    else:
        y, st, cv = SSM.rglru_decode(p.mixer, _rglru_spec(cfg), h, cache["state"], cache["conv"])
        cache = {"state": st, "conv": cv}
    x = x + _branch(cfg, y)
    if p.moe is not None:
        y2, _ = MOE.moe_ffn(p.moe, _moe_spec(cfg), L.rms_norm(p.norm2, x, cfg.norm_eps))
        return x + _branch(cfg, y2), cache
    if p.ffn is not None:
        x = x + _branch(cfg, L.ffn(p.ffn, L.rms_norm(p.norm2, x, cfg.norm_eps), cfg.act))
    return x, cache


def _local_decode(p: L.Attention, cfg: ModelConfig, h, cache, pos: int):
    """Ring-buffer sliding-window decode: the new token's k/v and position
    go into slot ``pos % window`` in place (k and v quantized by the
    cache's dtype); scores in fp32, slots outside the window masked to
    -inf, as in the reference."""
    spec = _attn_spec(cfg, True)
    b, one, _ = h.shape
    w = cfg.window
    q = unflatten(L.dense(p.wq, h), -1, (spec.n_heads, spec.head_dim))
    k = unflatten(L.dense(p.wk, h), -1, (spec.n_kv_heads, spec.head_dim))
    v = unflatten(L.dense(p.wv, h), -1, (spec.n_kv_heads, spec.head_dim))
    pvec = torch.full((b, one), pos, dtype=torch.int32, device=h.device)
    q = L.apply_rope(q, pvec, spec.rope_theta)
    k = L.apply_rope(k, pvec, spec.rope_theta)
    slot = pos % w
    ck, cv, pidx = cache["k"], cache["v"], cache["pos_idx"]
    write_slice(ck, 1, slot, L._kv_quant(k, ck.dtype))
    write_slice(cv, 1, slot, L._kv_quant(v, cv.dtype))
    write_slice(pidx, 0, slot, torch.full((1,), pos, dtype=pidx.dtype, device=h.device))
    ok = (pidx <= pos) & (pidx > pos - w) & (pidx >= 0)              # (w,)
    rep = spec.n_heads // spec.n_kv_heads
    qg = unflatten(q, 2, (spec.n_kv_heads, rep))
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg.float(), L._kv_dequant(ck).float())
    scores = scores / (spec.head_dim ** 0.5)
    scores = torch.where(replicated_like(scores, ok), scores, -math.inf)
    attn = torch.softmax(scores, dim=-1)
    o = flatten(torch.einsum("bkrqs,bskh->bqkrh", attn, L._kv_dequant(cv).float()).to(h.dtype), 2)
    y = L.dense(p.wo, o)
    return y, {"k": ck, "v": cv, "pos_idx": pidx}


# ----------------------------------------------------------- cache specs ---
def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, smax: int, dtype):
    """``TensorSpec`` tree of one block's decode cache."""
    check_kind(kind)
    kv_dt = torch.int8 if cfg.kv_cache_quant else dtype
    if kind in ("attn_global", "moe"):
        shp = (batch, smax, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": TensorSpec(shp, kv_dt), "v": TensorSpec(shp, kv_dt)}
    if kind == "attn_local":
        w = cfg.window
        shp = (batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": TensorSpec(shp, kv_dt), "v": TensorSpec(shp, kv_dt), "pos_idx": TensorSpec((w,), torch.int32)}
    if kind == "mla":  # the latent caches keep the model dtype under kv_cache_quant, as in the reference
        return {"ckv": TensorSpec((batch, smax, cfg.kv_lora_rank), dtype),
                "kr": TensorSpec((batch, smax, cfg.qk_rope_head_dim), dtype)}
    if kind in ("mamba2", "mamba2_moe"):
        s = _mamba_spec(cfg)
        return {
            "state": TensorSpec((batch, s.n_heads, s.d_state, s.head_dim), torch.float32),
            "conv": TensorSpec((batch, s.d_conv - 1, s.conv_channels), cfg.param_dtype),
        }
    s = _rglru_spec(cfg)
    return {
        "state": TensorSpec((batch, s.width), torch.float32),
        "conv": TensorSpec((batch, s.d_conv - 1, s.width), cfg.param_dtype),
    }


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
    products in the backward pass, "full" recomputes the whole block."""
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
    Each block of the repeating groups runs under its own ``_remat`` (a
    long pattern's group under one checkpoint would hold all its layers'
    activations at once in the backward pass); the tail blocks run as they
    are, as in the reference."""
    pl = cfg.pattern_len

    def layer_body(x, aux, blk, kind):
        x = shard(x, "batch", "residual_seq", None)
        x, _, a = block_fwd(blk, cfg, kind, x, positions, want_cache=False)
        return shard(x, "batch", "residual_seq", None), aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(cfg, layer_body)
    for i in range(cfg.n_groups * pl):
        x, aux = body(x, aux, params.blocks[i], cfg.block_pattern[i % pl])
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
                    scanned[i][name] = empty_stacked(cfg.n_groups, t)
                write_slice(scanned[i][name], 0, g, t.unsqueeze(0))
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
    """The head's logits, divided by the muP ``logits_scaling`` (skipped at 1)."""
    if cfg.tie_embeddings:
        logits = L.unembed(params.embed, hidden)
    else:
        logits = shard(L.dense(params.lm_head, hidden), "batch", "seq", "act_vocab")
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


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

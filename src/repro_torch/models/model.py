"""Public model API: ``build_model(cfg, device=None) -> Model``.

A port of the JAX package's ``models/model.py`` for decoder LMs. ``Model``
exposes the functions the train loop and the server call:

    init(generator)                         -> params (a DecoderLM)
    loss_fn(params, batch)                  -> (loss, metrics)
    prefill(params, batch, cache_len)       -> (logits, caches)
    decode_step(params, caches, token, pos) -> (logits, caches)
    input_specs(shape)                      -> dict of TensorSpec
    cache_specs(shape)                      -> TensorSpec tree

``loss_fn`` runs with autograd; ``prefill`` and ``decode_step`` run
without it. The decoder's block kinds ``attn_global``, ``attn_local``
(Gemma3, RecurrentGemma's attention: ring-buffer caches) and ``rglru``
(RecurrentGemma's recurrence) are ported; ``mla`` (ROADMAP A4b), ``moe``,
``mamba2`` and encoder-decoder models (A4c) raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import TensorSpec


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked CE in fp32. labels < 0 are ignored. When the logits dim
    is padded past `vocab` (sharding-friendly padded_vocab), padded ids are
    masked to -1e30 so they carry no probability mass."""
    lf = logits.float()
    if vocab and lf.shape[-1] > vocab:
        pad_mask = torch.arange(lf.shape[-1], device=lf.device) >= vocab
        lf = torch.where(pad_mask, -1e30, lf)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    tot = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / tot, tot


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    input_specs: Callable
    cache_specs: Callable


def _frontend_tokens(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """#positions supplied by the modality frontend stub."""
    if cfg.frontend == "vision_stub":
        return min(cfg.n_frontend_tokens, shape.seq_len // 2)
    return 0


def build_model(cfg: ModelConfig, device: "str | torch.device | None" = None) -> Model:
    """The model on ``device``: CUDA unless the caller names another (and
    raises when there is no CUDA device)."""
    cfg.validate()
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder models are not ported yet: ROADMAP A4c")
    for kind in cfg.block_pattern:
        T.check_kind(kind)
    return _build_decoder(cfg, resolve_device(device))


def _build_decoder(cfg: ModelConfig, dev: torch.device) -> Model:
    aux_coeff = 0.01 if cfg.n_experts else 0.0

    def init(generator: "torch.Generator | int"):
        gen = generator
        if isinstance(generator, int):
            gen = torch.Generator(device=dev).manual_seed(generator)
        params = T.init_decoder(gen, cfg, device=dev)
        if cfg.weight_quant:
            params = L.quantize_dense_weights(params)
        return params

    def _embed_inputs(params, batch):
        """Token (+ frontend) embeddings and positions."""
        tokens = batch["tokens"]
        x = L.embed(params.embed, tokens)
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        return x, positions

    def loss_fn(params, batch):
        x, positions = _embed_inputs(params, batch)
        hidden, aux = T.decoder_hidden(params, cfg, x, positions)
        n_front = x.shape[1] - batch["tokens"].shape[1]
        if n_front:
            hidden = hidden[:, n_front:]
        logits = T.logits_from_hidden(params, cfg, hidden)
        loss, n_tok = lm_loss(logits, batch["labels"], cfg.vocab)
        total = loss + aux_coeff * aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}

    @torch.no_grad()
    def prefill(params, batch, cache_len: int = 0):
        x, positions = _embed_inputs(params, batch)
        hidden, caches = T.decoder_prefill(params, cfg, x, positions, smax=cache_len)
        logits = T.logits_from_hidden(params, cfg, hidden[:, -1:])
        return logits, caches

    @torch.no_grad()
    def decode_step(params, caches, token, pos):
        x = L.embed(params.embed, token)
        hidden, caches = T.decoder_decode(params, cfg, caches, x, int(pos))
        logits = T.logits_from_hidden(params, cfg, hidden)
        return logits, caches

    def input_specs(shape: ShapeSpec) -> dict[str, Any]:
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        n_front = _frontend_tokens(cfg, shape)
        if shape.kind == "train":
            specs = {
                "tokens": TensorSpec((b, s - n_front), i32),
                "labels": TensorSpec((b, s - n_front), i32),
            }
        elif shape.kind == "prefill":
            specs = {"tokens": TensorSpec((b, s - n_front), i32)}
        else:  # decode
            return {"token": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32)}
        if n_front:
            specs["patch_embeds"] = TensorSpec((b, n_front, cfg.d_model), cfg.param_dtype)
        return specs

    def cache_specs(shape: ShapeSpec):
        return T.decoder_cache_specs(cfg, shape.global_batch, shape.seq_len)

    return Model(cfg, dev, init, loss_fn, prefill, decode_step, input_specs, cache_specs)

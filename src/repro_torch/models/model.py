"""Public model API: ``build_model(cfg, device=None) -> Model``.

A port of the JAX package's ``models/model.py``. ``Model`` exposes the
functions the train loop and the server call:

    init(generator)                         -> params (a DecoderLM or EncDecLM)
    loss_fn(params, batch)                  -> (loss, metrics)
    prefill(params, batch[, cache_len])     -> (logits, caches)
    decode_step(params, caches, token, pos) -> (logits, caches)
    input_specs(shape)                      -> dict of TensorSpec
    cache_specs(shape)                      -> TensorSpec tree
    param_specs(seed)                       -> TensorSpec tree (JAX layout)

``loss_fn`` runs with autograd; ``prefill`` and ``decode_step`` run
without it. Every block kind of the JAX package is ported, so every
config of its registry builds; encoder-decoder models (Whisper) take
frame embeddings beside their tokens, and their ``prefill`` takes no
``cache_len``, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import replicate_dim, replicated_like
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import TensorSpec


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked CE in fp32. labels < 0 are ignored. When the logits dim
    is padded past `vocab` (sharding-friendly padded_vocab), padded ids are
    masked to -1e30 so they carry no probability mass. Vocab-sharded
    DTensor logits are gathered on the vocab dim first (DTensor places no
    gather along a split dim); the pad mask is a constant, replicated."""
    lf = replicate_dim(logits, -1).float()
    if vocab and lf.shape[-1] > vocab:
        pad_mask = torch.arange(lf.shape[-1], device=lf.device) >= vocab
        lf = torch.where(replicated_like(lf, pad_mask), -1e30, lf)
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

    def param_specs(self, seed: int = 0):
        """The JAX package's parameter tree (``init``'s, blocks stacked as
        ``models.convert`` lays them out) as ``TensorSpec``s. The shapes come
        from an ``init`` under ``FakeTensorMode``: nothing is allocated, and
        no number is drawn, so ``seed`` changes nothing."""
        from repro_torch.models.convert import spec_tree  # convert imports this package

        with FakeTensorMode():
            gen = torch.Generator(device="cpu").manual_seed(seed)
            if self.cfg.enc_dec:
                params = ED.init_encdec(gen, self.cfg, device="cpu")
            else:
                params = T.init_decoder(gen, self.cfg, device="cpu")
                if self.cfg.weight_quant:
                    params = L.quantize_dense_weights(params)
            return spec_tree(params, self.cfg)


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
        return _build_encdec(cfg, resolve_device(device))
    for kind in cfg.block_pattern:
        T.check_kind(kind)
    return _build_decoder(cfg, resolve_device(device))


def _generator(generator: "torch.Generator | int", dev: torch.device) -> torch.Generator:
    if isinstance(generator, int):
        return torch.Generator(device=dev).manual_seed(generator)
    return generator


def _build_decoder(cfg: ModelConfig, dev: torch.device) -> Model:
    aux_coeff = 0.01 if cfg.n_experts else 0.0

    def init(generator: "torch.Generator | int"):
        params = T.init_decoder(_generator(generator, dev), cfg, device=dev)
        if cfg.weight_quant:
            params = L.quantize_dense_weights(params)
        return params

    def _embed(params, tokens):
        """Token embeddings, times the muP ``embedding_multiplier`` (skipped at 1)."""
        x = L.embed(params.embed, tokens)
        return x if cfg.embedding_multiplier == 1.0 else x * cfg.embedding_multiplier

    def _embed_inputs(params, batch):
        """Token (+ frontend) embeddings and positions."""
        tokens = batch["tokens"]
        x = _embed(params, tokens)
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
        total = loss + aux_coeff * replicated_like(loss, aux)
        return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}

    @torch.no_grad()
    def prefill(params, batch, cache_len: int = 0):
        x, positions = _embed_inputs(params, batch)
        hidden, caches = T.decoder_prefill(params, cfg, x, positions, smax=cache_len)
        logits = T.logits_from_hidden(params, cfg, hidden[:, -1:])
        return logits, caches

    @torch.no_grad()
    def decode_step(params, caches, token, pos):
        x = _embed(params, token)
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


# ----------------------------------------------------------- enc-dec (ASR) --
def _build_encdec(cfg: ModelConfig, dev: torch.device) -> Model:
    def init(generator: "torch.Generator | int"):
        return ED.init_encdec(_generator(generator, dev), cfg, device=dev)

    def _split(shape: ShapeSpec) -> tuple[int, int]:
        """seq_len budget split: half encoder frames, half decoder tokens."""
        return shape.seq_len // 2, shape.seq_len // 2

    def loss_fn(params, batch):
        enc_out = ED.encode(params, cfg, batch["frame_embeds"])
        logits = ED.decode_train(params, cfg, batch["tokens"], enc_out)
        loss, n_tok = lm_loss(logits, batch["labels"], cfg.vocab)
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        return loss, {"loss": loss, "aux_loss": zero, "tokens": n_tok}

    @torch.no_grad()
    def prefill(params, batch):
        logits, caches = ED.encdec_prefill(params, cfg, batch["tokens"], batch["frame_embeds"])
        return logits[:, -1:], caches

    @torch.no_grad()
    def decode_step(params, caches, token, pos):
        return ED.encdec_decode(params, cfg, caches, token, int(pos))

    def input_specs(shape: ShapeSpec) -> dict[str, Any]:
        b = shape.global_batch
        s_enc, s_dec = _split(shape)
        i32 = torch.int32
        if shape.kind == "decode":
            return {"token": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32)}
        specs = {"frame_embeds": TensorSpec((b, s_enc, cfg.d_model), cfg.param_dtype),
                 "tokens": TensorSpec((b, s_dec), i32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s_dec), i32)
        return specs

    def cache_specs(shape: ShapeSpec):
        s_enc, s_dec = _split(shape)
        return ED.encdec_cache_specs(cfg, shape.global_batch, s_dec, s_enc)

    return Model(cfg, dev, init, loss_fn, prefill, decode_step, input_specs, cache_specs)

"""A Mistral decoder (LLaVA-NeXT's language backbone): RMSNorm, rotary
position embedding, grouped-query causal attention, SwiGLU feed-forward,
an untied output head, with the vision stub's patch embeddings in front of
the text."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.metrics._arith import attention_pairs
from bench.reference import models
from bench.reference.models import _layer, causal_attention, cross_entropy, rms_norm, rotary
from bench.weights import padded_vocab

WIDTHS = {"d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab"}
# GQA with a vision stub, tiny widths.
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=300, n_frontend_tokens=4,
            seq_len=32)


def layout(m: dict) -> list[tuple[tuple, tuple, str, float]]:
    d, g, v = m["d_model"], m["n_layers"], padded_vocab(m)
    h, kv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    b = ("blocks", 0)
    return [
        (("embed", "table"), (v, d), "normal", 0.02),
        (("final_norm", "scale"), (d,), "ones", 0.0),
        (("lm_head", "w"), (d, v), "normal", d ** -0.5),
        ((*b, "norm1", "scale"), (g, d), "ones", 0.0),
        ((*b, "attn", "wq", "w"), (g, d, h * hd), "normal", d ** -0.5),
        ((*b, "attn", "wk", "w"), (g, d, kv * hd), "normal", d ** -0.5),
        ((*b, "attn", "wv", "w"), (g, d, kv * hd), "normal", d ** -0.5),
        ((*b, "attn", "wo", "w"), (g, h * hd, d), "normal", (h * hd) ** -0.5),
        ((*b, "norm2", "scale"), (g, d), "ones", 0.0),
        ((*b, "ffn", "gate", "w"), (g, d, f), "normal", d ** -0.5),
        ((*b, "ffn", "up", "w"), (g, d, f), "normal", d ** -0.5),
        ((*b, "ffn", "down", "w"), (g, f, d), "normal", f ** -0.5),
    ]


def decoder_layer(p: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    a = rms_norm(x, p["norm1"]["scale"], m["norm_eps"])
    q = rotary(models.matmul(a, p["attn"]["wq"]["w"]).view(b, s, h, hd), m["rope_theta"])
    k = rotary(models.matmul(a, p["attn"]["wk"]["w"]).view(b, s, kv, hd), m["rope_theta"])
    v = models.matmul(a, p["attn"]["wv"]["w"]).view(b, s, kv, hd)
    x = x + models.matmul(causal_attention(q, k, v).reshape(b, s, h * hd), p["attn"]["wo"]["w"])
    a = rms_norm(x, p["norm2"]["scale"], m["norm_eps"])
    f = p["ffn"]
    ffn = models.matmul(F.silu(models.matmul(a, f["gate"]["w"])) * models.matmul(a, f["up"]["w"]), f["down"]["w"])
    return x + ffn


def loss(params: dict, m: dict, batch: dict) -> torch.Tensor:
    """``batch`` holds ``tokens`` and ``labels`` (B, S_text) and, for the
    vision stub, ``patch_embeds`` (B, n_front, D) placed before the text."""
    x = params["embed"]["table"][batch["tokens"].long()]
    n_front = 0
    if "patch_embeds" in batch:
        n_front = batch["patch_embeds"].shape[1]
        x = torch.cat([batch["patch_embeds"], x], dim=1)
    blocks = params["blocks"][0]
    for g in range(m["n_layers"]):
        x = checkpoint(decoder_layer, _layer(blocks, g), m, x, use_reentrant=False)
    x = rms_norm(x[:, n_front:], params["final_norm"]["scale"], m["norm_eps"])
    return cross_entropy(models.matmul(x, params["lm_head"]["w"]), batch["labels"], m["vocab"])


def model_flop_per_step(m: dict) -> float:
    """6 per weight of every product and position it applies to, and 3 x the
    forward FLOPs of attention's visible pairs; the head over text
    positions only."""
    b, s = m["global_batch"], m["seq_len"]
    d, layers, vocab = m["d_model"], m["n_layers"], m["vocab"]
    text = s - m.get("n_frontend_tokens", 0)
    h, kv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f
    products = 6 * (per_layer * layers * b * s + d * vocab * b * text)
    attn = 3 * 2 * (2 * hd) * h * attention_pairs(s, s, True, 0) * b * layers
    return float(products + attn)

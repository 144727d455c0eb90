"""Granite-4.0-H (HF ``granitemoehybrid``): Mamba-2 and NoPE grouped-query
attention layers as ``layer_types`` orders them, each followed by a
mixture-of-experts FFN with a shared expert, under muP scalars; tied
embeddings.

The equations of the HF model, per layer:
    h = x + r * mixer(rms_norm(x))          mixer: Mamba-2, or attention
    x = h + r * (moe(a) + shared(a)),  a = rms_norm(h)
with the input embedding times ``embedding_multiplier``, ``r`` the
``residual_multiplier`` and the logits divided by ``logits_scaling``.
Mamba-2 is ``models.mamba_mixer`` (its gated norm at ``norm_eps``, as the
HF layer's ``rms_norm_eps``). Attention has no position embedding and
scores q.k times ``attention_multiplier``: q is scaled in float32 by
``attn_scale * sqrt(head_dim)`` before ``models.causal_attention`` divides
by sqrt(head_dim), the same mathematics. The router: float32 logits over
all ``n_experts``, the ``top_k`` largest, and softmax over those (HF's
``TopKGating``: the same weights as the top of the full softmax,
renormalized). The experts are SwiGLU, a loop over the held experts, each
over the tokens that chose it.

Departures from the published model, each as the benchmark's cut or the
program's training setup states it:
- the layer holds experts ``first_held_expert`` .. + ``n_held_experts``
  - 1 of the router's ``n_experts`` (one rank of expert parallelism) and
  computes their part of the result; the absent experts' part is left out,
  as in the program, and the shared expert is counted once;
- the loss adds the Switch load-balancing loss of every layer, 0.01 x
  n_experts x sum_e (share of the layer's choices on e) x (mean router
  probability of e), over all n_experts: the program's auxiliary loss and
  coefficient; the HF model averages its own form over the layers and
  weights it by ``router_aux_loss_coef``, which the source does not set;
- the convolution's bias is drawn (0.1), where a fresh HF layer starts at
  0, so that the bias's path is exercised.

On a card the loss switches the caching allocator to expandable segments:
beside the reference's float32 weights, moments and gradients (and the
first step's gradients, which ``reference.train.follow`` keeps), about 70
GiB at 18 experts a layer, a card's last free GiB would otherwise lie in
pieces too small for the gradient norm's float64 copy of the embedding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.metrics._arith import attention_pairs
from bench.reference import models
from bench.reference.models import _layer, causal_attention, cross_entropy, mamba_mixer, rms_norm
from bench.weights import padded_vocab

WIDTHS = {"d_model", "n_heads", "n_kv_heads", "head_dim", "expert_d_ff", "shared_d_ff", "top_k", "n_experts",
          "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk", "vocab"}
# One whole period (5 Mamba-2, 1 attention, 4 Mamba-2), tiny widths; 2 of 8
# experts held (a quarter, as the published 18 of 72).
TINY = dict(n_layers=10, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, ssm_state=8, ssm_head_dim=8,
            ssm_chunk=8, n_experts=8, top_k=3, n_held_experts=2, expert_d_ff=16, shared_d_ff=24, vocab=300,
            seq_len=32)
# The program's auxiliary-loss coefficient.
AUX_COEFF = 0.01
# Positions of the head's logits at a time (recomputed in the backward pass).
HEAD_CHUNK = 1024


def held(m: dict) -> range:
    lo = m.get("first_held_expert", 0)
    return range(lo, lo + (m.get("n_held_experts") or m["n_experts"]))


def _kinds(m: dict) -> list[str]:
    return list(m["layer_types"][: m["n_layers"]])


def layout(m: dict) -> list[tuple[tuple, tuple, str, float]]:
    """Per layer of the first period (stacked over the periods): the norms,
    the mixer (Mamba-2's convolution weight and bias drawn at 0.1, ``a_log``
    log(1..16) over the heads, ``dt_bias`` 0, ``d_skip`` 1; or attention's
    four products), then the router, the held experts' gate, up and down,
    and the shared expert's."""
    d, v, period = m["d_model"], padded_vocab(m), 10
    kinds = _kinds(m)
    g = m["n_layers"] // period
    d_in = m["ssm_expand"] * d
    n, heads, k = m["ssm_state"], d_in // m["ssm_head_dim"], m["ssm_conv"]
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, f, fs = len(held(m)), m["expert_d_ff"], m["shared_d_ff"]
    out = [(("embed", "table"), (v, d), "normal", 0.02), (("final_norm", "scale"), (d,), "ones", 0.0)]
    for i, kind in enumerate(kinds[:period]):
        b = ("blocks", i)
        out.append(((*b, "norm1", "scale"), (g, d), "ones", 0.0))
        if kind == "mamba":
            mx = (*b, "mixer")
            out += [
                ((*mx, "in_proj", "w"), (g, d, 2 * d_in + 2 * n + heads), "normal", d ** -0.5),
                ((*mx, "conv_w"), (g, k, d_in + 2 * n), "normal", 0.1),
                ((*mx, "conv_b"), (g, d_in + 2 * n), "normal", 0.1),
                ((*mx, "a_log"), (g, heads), "a_log", 0.0),
                ((*mx, "dt_bias"), (g, heads), "f32:0", 0.0),
                ((*mx, "d_skip"), (g, heads), "f32:1", 0.0),
                ((*mx, "norm_scale"), (g, d_in), "ones", 0.0),
                ((*mx, "out_proj", "w"), (g, d_in, d), "normal", d_in ** -0.5),
            ]
        else:
            at = (*b, "attn")
            out += [
                ((*at, "wq", "w"), (g, d, h * hd), "normal", d ** -0.5),
                ((*at, "wk", "w"), (g, d, kv * hd), "normal", d ** -0.5),
                ((*at, "wv", "w"), (g, d, kv * hd), "normal", d ** -0.5),
                ((*at, "wo", "w"), (g, h * hd, d), "normal", (h * hd) ** -0.5),
            ]
        mo = (*b, "moe")
        out += [
            ((*b, "norm2", "scale"), (g, d), "ones", 0.0),
            ((*mo, "router", "w"), (g, d, m["n_experts"]), "normal", d ** -0.5),
            ((*mo, "experts", "gate"), (g, e, d, f), "normal", d ** -0.5),
            ((*mo, "experts", "up"), (g, e, d, f), "normal", d ** -0.5),
            ((*mo, "experts", "down"), (g, e, f, d), "normal", f ** -0.5),
            ((*mo, "shared", "gate", "w"), (g, d, fs), "normal", d ** -0.5),
            ((*mo, "shared", "up", "w"), (g, d, fs), "normal", d ** -0.5),
            ((*mo, "shared", "down", "w"), (g, fs, d), "normal", fs ** -0.5),
        ]
    return out


def swiglu(a: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return models.matmul(F.silu(models.matmul(a, gate)) * models.matmul(a, up), down)


def moe(p: dict, m: dict, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the routed FFN plus the shared expert, and
    the layer's Switch loss. a (B, S, D)."""
    b, s, d = a.shape
    a2 = a.reshape(b * s, d)
    logits = models.matmul(a2, p["router"]["w"])                              # (T, E)
    top, ids = logits.topk(m["top_k"], dim=-1)
    weights = torch.softmax(top, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    chosen = torch.zeros_like(probs).scatter_(1, ids, 1.0)                    # (T, E)
    switch = m["n_experts"] * torch.sum(probs.mean(0) * chosen.mean(0))
    y = torch.zeros_like(a2)
    ex = p["experts"]
    for j, e in enumerate(held(m)):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            out = swiglu(a2[tok], ex["gate"][j], ex["up"][j], ex["down"][j])
            y = y.index_add(0, tok, out * weights[tok, slot, None])
    sh = p["shared"]
    y = y.view(b, s, d) + swiglu(a, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"])
    return y, switch


def attention(p: dict, m: dict, a: torch.Tensor) -> torch.Tensor:
    b, s, _ = a.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = models.matmul(a, p["wq"]["w"]).view(b, s, h, hd) * (m["attn_scale"] * math.sqrt(hd))
    k = models.matmul(a, p["wk"]["w"]).view(b, s, kv, hd)
    v = models.matmul(a, p["wv"]["w"]).view(b, s, kv, hd)
    return models.matmul(causal_attention(q, k, v).reshape(b, s, h * hd), p["wo"]["w"])


def granite_layer(p: dict, m: dict, kind: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r, eps = m["residual_multiplier"], m["norm_eps"]
    a = rms_norm(x, p["norm1"]["scale"], eps)
    y = mamba_mixer(p["mixer"], a, m) if kind == "mamba" else attention(p["attn"], m, a)
    x = x + r * y
    y, switch = moe(p["moe"], m, rms_norm(x, p["norm2"]["scale"], eps))
    return x + r * y, switch


def loss(params: dict, m: dict, batch: dict) -> torch.Tensor:
    if torch.cuda.is_available():
        # the float32 state beside this model leaves ~9 GiB of the card; the
        # backward pass's 1.5 GiB blocks would otherwise split it past use
        settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
        (settings or torch.cuda.memory._set_allocator_settings)("expandable_segments:True")
    table = params["embed"]["table"]
    x = table[batch["tokens"].long()] * m["embedding_multiplier"]
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(_kinds(m)):
        p = _layer(params["blocks"][i % 10], i // 10)
        x, switch = checkpoint(granite_layer, p, m, kind, x, use_reentrant=False)
        aux = aux + switch
    s = x.shape[1]
    ce = sum(checkpoint(head, x[:, lo : lo + HEAD_CHUNK], params["final_norm"]["scale"], table,
                        batch["labels"][:, lo : lo + HEAD_CHUNK], m, use_reentrant=False) * min(HEAD_CHUNK, s - lo)
             for lo in range(0, s, HEAD_CHUNK)) / s
    return ce + AUX_COEFF * aux


def head(x: torch.Tensor, scale: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, m: dict) -> torch.Tensor:
    """The mean cross entropy of a run of positions: the final norm, the
    tied head, the logits over ``logits_scaling``. The loss takes it a run
    of ``HEAD_CHUNK`` positions at a time, so that the float32 logits of one
    run are held at once."""
    logits = models.matmul(rms_norm(x, scale, m["norm_eps"]), table.t()) / m["logits_scaling"]
    return cross_entropy(logits, labels, m["vocab"])


def model_flop_per_step(m: dict) -> float:
    """6 per weight of every product and position it applies to, and 3 x
    the forward FLOPs of attention's visible pairs and of the state-space
    products. The routed experts count at the share of a token's top_k
    choices that land on the experts held here, top_k x held / n_experts in
    expectation; the router, the shared expert and the head in full."""
    b, s = m["global_batch"], m["seq_len"]
    d, vocab = m["d_model"], m["vocab"]
    kinds = _kinds(m)
    n_attn = kinds.count("attention")
    n_mamba = len(kinds) - n_attn
    d_in = m["ssm_expand"] * d
    n, p, q = m["ssm_state"], m["ssm_head_dim"], m["ssm_chunk"]
    heads = d_in // p
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    mixer = d * (2 * d_in + 2 * n + heads) + d_in * d
    attn = d * h * hd * 2 + d * kv * hd * 2
    routed = m["top_k"] * len(held(m)) / m["n_experts"] * 3 * d * m["expert_d_ff"]
    ffn = d * m["n_experts"] + routed + 3 * d * m["shared_d_ff"]
    per_token = n_mamba * mixer + n_attn * attn + len(kinds) * ffn + d * vocab
    products = 6 * per_token * b * s
    chunks = s // q
    ssd = 2 * (q * q * n + q * q * heads * p + 2 * q * n * heads * p) * chunks * b * n_mamba
    pairs = 2 * (2 * hd) * h * attention_pairs(s, s, True, 0) * b * n_attn
    return float(products + 3 * (ssd + pairs))

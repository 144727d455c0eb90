"""A Mamba-2 stack (arXiv 2405.21060): each layer an RMSNorm and the SSD
mixer (``models.mamba_mixer``) on a residual, tied embeddings."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import models
from bench.reference.models import _layer, cross_entropy, mamba_mixer, rms_norm
from bench.weights import padded_vocab

WIDTHS = {"d_model", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk", "vocab"}
# An SSD stack with tied embeddings, tiny widths.
TINY = dict(n_layers=2, d_model=32, ssm_state=8, ssm_head_dim=8, ssm_chunk=8, vocab=300, seq_len=32)


def layout(m: dict) -> list[tuple[tuple, tuple, str, float]]:
    """Mamba-2's convolution drawn at 0.1; ``a_log`` log(1..16) over the
    heads, ``dt_bias`` 0 and ``d_skip`` 1, in float32."""
    d, g, v = m["d_model"], m["n_layers"], padded_vocab(m)
    d_in = m["ssm_expand"] * d
    n, heads, k = m["ssm_state"], d_in // m["ssm_head_dim"], m["ssm_conv"]
    b = ("blocks", 0)
    mx = (*b, "mixer")
    return [
        (("embed", "table"), (v, d), "normal", 0.02),
        (("final_norm", "scale"), (d,), "ones", 0.0),
        ((*b, "norm1", "scale"), (g, d), "ones", 0.0),
        ((*mx, "in_proj", "w"), (g, d, 2 * d_in + 2 * n + heads), "normal", d ** -0.5),
        ((*mx, "conv_w"), (g, k, d_in + 2 * n), "normal", 0.1),
        ((*mx, "conv_b"), (g, d_in + 2 * n), "zeros", 0.0),
        ((*mx, "a_log"), (g, heads), "a_log", 0.0),
        ((*mx, "dt_bias"), (g, heads), "f32:0", 0.0),
        ((*mx, "d_skip"), (g, heads), "f32:1", 0.0),
        ((*mx, "norm_scale"), (g, d_in), "ones", 0.0),
        ((*mx, "out_proj", "w"), (g, d_in, d), "normal", d_in ** -0.5),
    ]


def mamba_layer(p: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    return x + mamba_mixer(p["mixer"], rms_norm(x, p["norm1"]["scale"], m["norm_eps"]), m)


def loss(params: dict, m: dict, batch: dict) -> torch.Tensor:
    table = params["embed"]["table"]
    x = table[batch["tokens"].long()]
    blocks = params["blocks"][0]
    for g in range(m["n_layers"]):
        x = checkpoint(mamba_layer, _layer(blocks, g), m, x, use_reentrant=False)
    x = rms_norm(x, params["final_norm"]["scale"], m["norm_eps"])
    return cross_entropy(models.matmul(x, table.t()), batch["labels"], m["vocab"])


def model_flop_per_step(m: dict) -> float:
    """6 per weight of every product and position it applies to, and 3 x the
    forward FLOPs of the state-space products."""
    b, s = m["global_batch"], m["seq_len"]
    d, layers, vocab = m["d_model"], m["n_layers"], m["vocab"]
    d_in = m["ssm_expand"] * d
    n, p, q = m["ssm_state"], m["ssm_head_dim"], m["ssm_chunk"]
    heads = d_in // p
    per_layer = d * (2 * d_in + 2 * n + heads) + d_in * d
    products = 6 * (per_layer * layers * b * s + d * vocab * b * s)
    chunks = s // q
    # per chunk: C.B^T (Q x Q x N), the weighted sum over x (Q x Q x H x P),
    # the chunk's state (Q x N x H x P) and its read-out (Q x N x H x P)
    ssd = 2 * (q * q * n + q * q * heads * p + 2 * q * n * heads * p) * chunks * b * layers
    return float(products + 3 * ssd)

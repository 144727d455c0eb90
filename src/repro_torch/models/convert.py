"""Carry a decoder's parameters between the JAX package's tree and the port.

``params_from_numpy`` takes the tree ``repro.models.transformer.init_decoder``
builds, as numpy arrays (bfloat16 as its ``uint16`` bits; w8a16 weights as
int8 with their float32 ``w_scale``), and returns the port's ``DecoderLM``,
unstacking the leading ``G`` axis of ``tree["blocks"]`` into the module
list. ``params_to_numpy`` is its inverse. Dense weights are ``(d_in,
d_out)`` in both packages, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, DecoderLM, check_kind


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint16:  # bfloat16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dense(d: dict, device) -> L.Dense:
    opt = {k: _tensor(d[k], device) for k in ("b", "w_scale") if k in d}
    return L.Dense(_tensor(d["w"], device), opt.get("b"), opt.get("w_scale"))


def _block(d: dict, device) -> Block:
    a = d["attn"]
    attn = L.Attention(*(_dense(a[n], device) for n in ("wq", "wk", "wv", "wo")))
    norm1 = L.RMSNorm(_tensor(d["norm1"]["scale"], device))
    if "ffn" not in d:
        return Block(norm1, attn)
    f = d["ffn"]
    return Block(norm1, attn, L.RMSNorm(_tensor(d["norm2"]["scale"], device)),
                 L.FFN(*(_dense(f[n], device) for n in ("gate", "up", "down"))))


def _index(tree, g: int):
    """The ``g``-th slice of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> DecoderLM:
    """The port's ``DecoderLM`` holding the JAX parameter tree's values, on
    the card unless ``device`` names another (``resolve_device``)."""
    device = resolve_device(device)
    for kind in cfg.block_pattern:
        check_kind(kind)
    blocks = []
    for g in range(cfg.n_groups):
        for i in range(cfg.pattern_len):
            blocks.append(_block(_index(tree["blocks"][i], g), device))
    tail = [_block(t, device) for t in tree["tail"]]
    lm_head = _dense(tree["lm_head"], device) if "lm_head" in tree else None
    return DecoderLM(
        L.Embedding(_tensor(tree["embed"]["table"], device)),
        L.RMSNorm(_tensor(tree["final_norm"]["scale"], device)),
        lm_head, blocks, tail,
    )


def _dense_tree(d: L.Dense) -> dict:
    out = {"w": _array(d.w)}
    if d.b is not None:
        out["b"] = _array(d.b)
    if d.w_scale is not None:
        out["w_scale"] = _array(d.w_scale)
    return out


def _block_tree(b: Block) -> dict:
    a = b.attn
    out = {
        "norm1": {"scale": _array(b.norm1.scale)},
        "attn": {n: _dense_tree(getattr(a, n)) for n in ("wq", "wk", "wv", "wo")},
    }
    if b.ffn is not None:
        out["norm2"] = {"scale": _array(b.norm2.scale)}
        out["ffn"] = {n: _dense_tree(getattr(b.ffn, n)) for n in ("gate", "up", "down")}
    return out


def _stack(trees: list[dict]) -> dict:
    """Stack leaves on a new leading axis; a per-layer ``w_scale`` becomes
    ``(G, 1, 1)``, the JAX package's per-layer scale of a stacked weight."""
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = _stack([t[k] for t in trees])
        elif k == "w_scale":
            out[k] = np.stack([t[k].reshape(1, 1) for t in trees])
        else:
            out[k] = np.stack([t[k] for t in trees])
    return out


def params_to_numpy(params: DecoderLM, cfg: ModelConfig) -> dict:
    """The JAX ``init_decoder`` tree (numpy leaves) of a port ``DecoderLM``."""
    pl = cfg.pattern_len
    tree = {
        "embed": {"table": _array(params.embed.table)},
        "final_norm": {"scale": _array(params.final_norm.scale)},
    }
    if params.lm_head is not None:
        tree["lm_head"] = _dense_tree(params.lm_head)
    if cfg.n_groups:
        tree["blocks"] = tuple(
            _stack([_block_tree(params.blocks[g * pl + i]) for g in range(cfg.n_groups)])
            for i in range(pl)
        )
    tree["tail"] = tuple(_block_tree(b) for b in params.tail)
    return tree

"""Carry a decoder's parameters and train state between the JAX package's
tree and the port.

``params_from_numpy`` takes the tree ``repro.models.transformer.init_decoder``
builds, as numpy arrays (bfloat16 as its ``uint16`` bits; w8a16 weights as
int8 with their float32 ``w_scale``) or as tensors, and returns the port's
``DecoderLM``, unstacking the leading ``G`` axis of ``tree["blocks"]`` into
the module list. ``params_to_numpy`` is its inverse. Dense weights are
``(d_in, d_out)`` in both packages, so nothing is transposed.

``train_state_to_tree`` spells a train state (``repro_torch.train``) as the
JAX package's ``{"params": ..., "opt": {"master", "mu", "nu", "step"[,
"err"]}}`` with tensor leaves on the state's device, which is the tree the
train loop's checkpoint hook saves: its leaf keys, object names and stored
bytes are the JAX package's for the same state. Stacking the block leaves
on the group axis copies them. ``train_state_from_tree`` is its inverse;
its block parameters and moments are views of the tree's stacked leaves
(tensor leaves on ``device`` are not copied).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, DecoderLM, check_kind


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
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
    """The port's ``DecoderLM`` holding the JAX parameter tree's values
    (numpy or tensor leaves), on the card unless ``device`` names another
    (``resolve_device``)."""
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


# --------------------------------------------------------- train state ---
def _tree_of_named(named: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """The ``init_decoder`` tree of tensors keyed by parameter name (the
    names ``DecoderLM.named_parameters()`` gives), blocks stacked on the
    group axis."""
    nested: dict = {}
    for name, t in named.items():
        d = nested
        *head, last = name.split(".")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = t
    blocks, tail = nested.pop("blocks", {}), nested.pop("tail", {})
    pl = cfg.pattern_len
    if cfg.n_groups:
        nested["blocks"] = tuple(
            _stack_tensors([blocks[str(g * pl + i)] for g in range(cfg.n_groups)]) for i in range(pl)
        )
    nested["tail"] = tuple(tail[str(i)] for i in range(len(cfg.tail_blocks)))
    return nested


def _stack_tensors(trees: list[dict]) -> dict:
    return {k: _stack_tensors([t[k] for t in trees]) if isinstance(v, dict) else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


_MOMENTS = ("master", "mu", "nu", "err")


def params_tree(params: DecoderLM, cfg: ModelConfig) -> dict:
    """The JAX ``init_decoder`` tree of a ``DecoderLM``'s parameters, as
    detached tensors on their device (block leaves stacked: copies)."""
    return _tree_of_named({n: p.detach() for n, p in params.named_parameters()}, cfg)


def train_state_to_tree(state: dict, cfg: ModelConfig) -> dict:
    """The JAX package's train-state tree of a port train state."""
    opt = state["opt"]
    tree_opt = {k: _tree_of_named(opt[k], cfg) for k in _MOMENTS if k in opt}
    tree_opt["step"] = opt["step"]
    return {"params": params_tree(state["params"], cfg), "opt": tree_opt}


def train_state_from_tree(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's train state holding a JAX-layout train-state tree (numpy
    leaves, bfloat16 as ``uint16`` bits, or tensors), on the card unless
    ``device`` names another."""
    device = resolve_device(device)
    opt = {"step": _tensor(tree["opt"]["step"], device)}
    for k in _MOMENTS:
        if k in tree["opt"]:  # a moment tree has the parameters' layout
            moments = params_from_numpy(tree["opt"][k], cfg, device)
            opt[k] = {n: p.detach() for n, p in moments.named_parameters()}
    return {"params": params_from_numpy(tree["params"], cfg, device), "opt": opt}

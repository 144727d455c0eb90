"""Carry a model's parameters and train state between the JAX package's
tree and the port.

``params_from_numpy`` takes the tree ``repro.models.transformer.init_decoder``
builds, as numpy arrays (bfloat16 as its ``uint16`` bits; w8a16 weights as
int8 with their float32 ``w_scale``) or as tensors, and returns the port's
``DecoderLM``, unstacking the leading ``G`` axis of ``tree["blocks"]`` into
the module list; for an encoder-decoder config it takes
``repro.models.encdec.init_encdec``'s tree and returns an ``EncDecLM``,
unstacking ``enc_blocks`` and ``dec_blocks`` on their layer axis.
``params_to_numpy`` is its inverse. Blocks carry every kind's leaves:
attention (MLA's nine leaves for ``mla`` blocks), the RG-LRU and Mamba-2
``mixer``s, the ``moe`` FFN (``router``,
the ``(E, D, F)`` / ``(E, F, D)`` expert arrays, ``shared``) and the FFN.
Dense weights are ``(d_in, d_out)`` in both packages, so nothing is
transposed.

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
from repro_torch.distributed.sharding import map_with_path
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.encdec import DecBlock, EncDecLM
from repro_torch.models.transformer import Block, DecoderLM, TensorSpec, check_kind

# The mixers' array leaves, between their two dense projections, in their
# modules' argument order.
_RGLRU_ARRAYS = ("conv_w", "conv_b", "w_r", "b_r", "w_i", "b_i", "lam")
_MAMBA_ARRAYS = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_scale")
_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("gate", "up", "down")


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


def _attn(d: dict, device) -> "L.Attention | MLA.MLA":
    if "w_dq" in d:  # an mla block's attention
        return MLA.MLA(*(_norm(d[n], device) if n in MLA.NORMS else _dense(d[n], device) for n in MLA.LEAVES))
    return L.Attention(*(_dense(d[n], device) for n in _ATTN))


def _ffn(d: dict, device) -> L.FFN:
    return L.FFN(*(_dense(d[n], device) for n in _FFN))


def _norm(d: dict, device) -> L.RMSNorm:
    return L.RMSNorm(_tensor(d["scale"], device))


def _mixer(m: dict, device) -> "SSM.RGLRU | SSM.Mamba2":
    cls, arrays = (SSM.Mamba2, _MAMBA_ARRAYS) if "a_log" in m else (SSM.RGLRU, _RGLRU_ARRAYS)
    return cls(_dense(m["in_proj"], device), *(_tensor(m[n], device) for n in arrays), _dense(m["out_proj"], device))


def _moe(m: dict, device) -> MOE.MoE:
    experts = MOE.Experts(*(_tensor(m["experts"][n], device) for n in _FFN))
    return MOE.MoE(_dense(m["router"], device), experts, _ffn(m["shared"], device) if "shared" in m else None)


def _block(d: dict, device) -> Block:
    return Block(
        _norm(d["norm1"], device),
        _attn(d["attn"], device) if "attn" in d else None,
        _norm(d["norm2"], device) if "norm2" in d else None,
        _ffn(d["ffn"], device) if "ffn" in d else None,
        mixer=_mixer(d["mixer"], device) if "mixer" in d else None,
        moe=_moe(d["moe"], device) if "moe" in d else None,
    )


def _dec_block(d: dict, device) -> DecBlock:
    return DecBlock(_norm(d["norm1"], device), _attn(d["self_attn"], device), _norm(d["norm_x"], device),
                    _attn(d["cross_attn"], device), _norm(d["norm2"], device), _ffn(d["ffn"], device))


def _index(tree, g: int):
    """The ``g``-th slice of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _layers(stacked: dict, n: int) -> list[dict]:
    return [_index(stacked, i) for i in range(n)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> "DecoderLM | EncDecLM":
    """The port's ``DecoderLM`` (``EncDecLM`` for an encoder-decoder
    config) holding the JAX parameter tree's values (numpy or tensor
    leaves), on the card unless ``device`` names another
    (``resolve_device``)."""
    device = resolve_device(device)
    if cfg.enc_dec:
        return EncDecLM(
            L.Embedding(_tensor(tree["embed"]["table"], device)),
            [_block(d, device) for d in _layers(tree["enc_blocks"], cfg.n_enc_layers)],
            [_dec_block(d, device) for d in _layers(tree["dec_blocks"], cfg.n_layers)],
            _norm(tree["enc_norm"], device), _norm(tree["final_norm"], device),
        )
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


def _module_tree(m, names) -> dict:
    return {n: _dense_tree(getattr(m, n)) for n in names}


def _block_tree(b: "Block | DecBlock") -> dict:
    """The JAX tree of one block: every submodule the block holds."""
    out = {}
    for name, mod in b.named_children():
        if isinstance(mod, L.RMSNorm):
            out[name] = {"scale": _array(mod.scale)}
        elif isinstance(mod, L.Attention):
            out[name] = _module_tree(mod, _ATTN)
        elif isinstance(mod, MLA.MLA):
            out[name] = {n: {"scale": _array(getattr(mod, n).scale)} if n in MLA.NORMS
                         else _dense_tree(getattr(mod, n)) for n in MLA.LEAVES}
        elif isinstance(mod, L.FFN):
            out[name] = _module_tree(mod, _FFN)
        elif isinstance(mod, MOE.MoE):
            out[name] = {"router": _dense_tree(mod.router),
                         "experts": {n: _array(getattr(mod.experts, n)) for n in _FFN}}
            if mod.shared is not None:
                out[name]["shared"] = _module_tree(mod.shared, _FFN)
        else:
            arrays = _MAMBA_ARRAYS if isinstance(mod, SSM.Mamba2) else _RGLRU_ARRAYS
            out[name] = {"in_proj": _dense_tree(mod.in_proj), "out_proj": _dense_tree(mod.out_proj),
                         **{n: _array(getattr(mod, n)) for n in arrays}}
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


def params_to_numpy(params: "DecoderLM | EncDecLM", cfg: ModelConfig) -> dict:
    """The JAX ``init_decoder`` tree (numpy leaves) of a port ``DecoderLM``,
    or the ``init_encdec`` tree of an ``EncDecLM``."""
    if cfg.enc_dec:
        return {
            "embed": {"table": _array(params.embed.table)},
            "enc_blocks": _stack([_block_tree(b) for b in params.enc_blocks]),
            "dec_blocks": _stack([_block_tree(b) for b in params.dec_blocks]),
            "enc_norm": {"scale": _array(params.enc_norm.scale)},
            "final_norm": {"scale": _array(params.final_norm.scale)},
        }
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
    group axis; for an encoder-decoder config the ``init_encdec`` tree,
    each stack's blocks stacked on its layer axis."""
    nested: dict = {}
    for name, t in named.items():
        d = nested
        *head, last = name.split(".")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = t
    if cfg.enc_dec:
        for stack in ("enc_blocks", "dec_blocks"):
            layers = nested[stack]
            nested[stack] = _stack_tensors([layers[str(i)] for i in range(len(layers))])
        return nested
    blocks, tail = nested.pop("blocks", {}), nested.pop("tail", {})
    pl = cfg.pattern_len
    if cfg.n_groups:
        nested["blocks"] = tuple(
            _stack_tensors([blocks[str(g * pl + i)] for g in range(cfg.n_groups)]) for i in range(pl)
        )
    nested["tail"] = tuple(tail[str(i)] for i in range(len(cfg.tail_blocks)))
    return nested


def _stack_tensors(trees: list[dict]) -> dict:
    """Stack leaves on a new leading axis; a per-layer ``w_scale`` becomes
    ``(G, 1, 1)``, as in ``_stack``."""
    return {k: _stack_tensors([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k].reshape(1, 1) if k == "w_scale" else t[k] for t in trees])
            for k, v in trees[0].items()}


_MOMENTS = ("master", "mu", "nu", "err")


def params_tree(params: "DecoderLM | EncDecLM", cfg: ModelConfig) -> dict:
    """The JAX tree of a model's parameters (``init_decoder``'s or
    ``init_encdec``'s), as detached tensors on their device (block leaves
    stacked: copies)."""
    return _tree_of_named({n: p.detach() for n, p in params.named_parameters()}, cfg)


def spec_tree(params: "DecoderLM | EncDecLM", cfg: ModelConfig) -> dict:
    """The JAX tree of a model's parameters and ``w_scale`` buffers as
    ``TensorSpec``s (``Model.param_specs``; run under ``FakeTensorMode``,
    the stacking allocates nothing)."""
    named = {n: p.detach() for n, p in params.named_parameters()}
    named.update((n, b) for n, b in params.named_buffers() if n.endswith("w_scale"))
    return map_with_path(lambda _, t: TensorSpec(tuple(t.shape), t.dtype), _tree_of_named(named, cfg))


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

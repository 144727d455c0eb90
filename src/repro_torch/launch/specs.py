"""Dry-run sharding assembly: rules per (shape kind, mesh), parameter,
input and cache shardings, the collectives a step issues, and the roofline
bookkeeping helpers.

A port of the JAX package's ``launch/specs.py``. The specs are the
reference's; each ``NamedSharding`` also carries the DTensor placements
the spec gives on its mesh. The reference reads collective bytes out of
XLA's HLO text; here ``CollectiveCounter`` reads the ``_c10d_functional``
ops that DTensor issues while the step runs. The roofline constants are an
NVIDIA H100 SXM's (see below), not the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    PartitionSpec as P,
    ShardingRules,
    make_rules,
    map_with_path,
    param_specs_for_tree,
    placements,
)
from repro_torch.launch.mesh import data_axes, mesh_axis_sizes


# ------------------------------------------------------------------- rules --
def rules_for(mesh, shape: ShapeSpec) -> ShardingRules:
    dp = data_axes(mesh)
    kw: dict[str, Any] = dict(data_axes=dp, model_axis="model", fsdp_axis="data")
    if shape.kind == "decode":
        # Serving: FSDP weight-sharding would re-gather weights every step;
        # keep weights TP-only (model axis), replicated across data.
        kw["fsdp_axis"] = None
        if shape.global_batch == 1:
            # long-context decode: nothing to DP over; spread the KV/state
            # sequence across the whole mesh.
            kw["data_axes"] = None
            kw["kv_seq_axis"] = tuple([*dp, "model"])
        else:
            kw["kv_seq_axis"] = "model"   # flash-decoding style seq split
    rules = make_rules(**kw)
    if shape.kind == "decode":
        # the model axis is spent on the KV sequence; heads stay replicated
        rules = rules.with_overrides(act_heads=None)
    return ShardingRules(rules.rules, mesh_axis_sizes(mesh))


# --------------------------------------------------------------- shardings --
@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(mesh, rules: ShardingRules, tree):
    return map_with_path(lambda _, s: NamedSharding(mesh, s), param_specs_for_tree(tree, rules))


def batch_shardings(mesh, rules: ShardingRules, specs: dict):
    """Input batch: leading dim = global batch -> DP axes."""
    out = {}
    for k, s in specs.items():
        if tuple(s.shape) == ():
            out[k] = NamedSharding(mesh, P())
            continue
        dims: list[Any] = [rules.axis("batch")] + [None] * (len(s.shape) - 1)
        out[k] = NamedSharding(mesh, rules.guard_spec(P(*dims), tuple(s.shape)))
    return out


def cache_spec(keys: tuple[str, ...], shape: tuple[int, ...], rules: ShardingRules) -> P:
    """Decode caches. Leaf-name based placement:
    k/v/ckv/kr: (..., B, S, [K], hd) -> (batch, kv_seq); mamba state
    (..., B, H, N, P) -> heads on model; conv/state widths on model."""
    name = keys[-1]
    nd = len(shape)
    batch_ax = rules.axis("batch")
    seq_ax = rules.axis("kv_seq")
    dims: list[Any] = [None] * nd
    if name == "pos_idx":
        return P(*dims)
    if name in ("k", "v"):          # (G?, B, S, K, hd)
        dims[-4], dims[-3] = batch_ax, seq_ax
    elif name in ("ckv", "kr"):     # (G?, B, S, r)
        dims[-3], dims[-2] = batch_ax, seq_ax
    elif name == "state":
        if nd >= 4:   # mamba: (G?, B, H, N, P): batch, then heads on model
            dims[-4], dims[-3] = batch_ax, "model"
        else:         # rglru: (G?, B, W): batch, width on model
            dims[-2], dims[-1] = batch_ax, "model"
    elif name == "conv":            # (G?, B, K-1, C)
        dims[-3], dims[-1] = batch_ax, "model"
    else:
        return P(*dims)
    return rules.guard_spec(P(*dims), shape)


def cache_shardings(mesh, rules: ShardingRules, cache_tree):
    return map_with_path(
        lambda keys, leaf: NamedSharding(mesh, cache_spec(keys, tuple(leaf.shape), rules)), cache_tree
    )


# ------------------------------------------------------------- collectives --
_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _collective_kind(func) -> str | None:
    """The reference's name for a ``_c10d_functional`` collective op."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._schema.name.split("::")[-1]
    if name.startswith("all_reduce"):
        return "all-reduce"
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if name.startswith("all_to_all"):
        return "all-to-all"
    if name.startswith(("broadcast", "permute")):
        return "collective-permute"
    return None


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Per-device bytes of each collective kind the code under it issues:
    the bytes of each ``_c10d_functional`` op's result, as the reference
    counts an HLO collective by its result shape. ``bytes`` and ``counts``
    are keyed by the reference's names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``).

    An op on DTensors is left to DTensor first (``NotImplemented``), so the
    counter sees what DTensor runs on the local shards; the ops DTensor runs
    under its own fake mode to propagate shardings are not counted (the
    test ``MemTracker`` makes)."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def __enter__(self):
        self._entry_fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _collective_kind(func)
        if kind is not None and active_fake_mode() is self._entry_fake_mode:
            self.bytes[kind] = self.bytes.get(kind, 0) + _out_bytes(out)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return out


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if active_fake_mode() is not self.counter.entry_fake_mode:  # sharding propagation
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over each rank's local shards (see
    ``CollectiveCounter``), so the count is one device's, as XLA's
    per-device ``cost_analysis`` is."""

    def __init__(self):
        super().__init__(display=False)

    def __enter__(self):
        self.entry_fake_mode = active_fake_mode()
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


# ---------------------------------------------------------------- roofline --
# One NVIDIA H100 SXM (80GB HBM3, 700 W), data-sheet peaks: dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4 bytes/s per direction.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def model_flops(cfg: ModelConfig, shape: ShapeSpec, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6ND train / 2ND per generated token (decode)."""
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def count_params(tree) -> int:
    n = [0]

    def add(_, leaf):
        k = 1
        for d in leaf.shape:
            k *= int(d)
        n[0] += k

    map_with_path(add, tree)
    return n[0]


def active_params(cfg: ModelConfig, n_params: int) -> int:
    """MoE: only top_k of n_experts routed experts are active per token."""
    if not cfg.n_experts:
        return n_params
    per_expert = 3 * cfg.d_model * cfg.expert_d_ff
    routed_total = cfg.n_layers * cfg.n_experts * per_expert
    routed_active = cfg.n_layers * cfg.top_k * per_expert
    return n_params - routed_total + routed_active

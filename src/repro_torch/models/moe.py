"""Mixture-of-Experts FFN with shared + routed experts (Qwen-MoE / Llama-4).

A port of the JAX package's ``models/moe.py``: GShard capacity-based
dispatch over token groups (tokens past an expert's capacity are dropped),
top-k routing with the Switch load-balancing aux loss, and an optional
shared FFN beside the routed experts.

Parameters live in an ``MoE`` module named as the JAX tree: ``router`` (a
``Dense``), ``experts.{gate,up,down}`` as ``(E, D, F)`` / ``(E, F, D)``
parameters, and ``shared`` (an ``FFN``) when the spec has shared experts.

Two rules keep the routing the reference's:

- ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order among ties, so the top k
  come from a stable descending sort.
- The dispatch and combine tensors ``(G, g, E, C)`` are the reference's
  one-hot einsums. Each (token, choice) kept names one (expert, slot), and
  a token's k choices are distinct experts, so no two terms meet in a sum:
  scattering the 1s (dispatch) and the routing weights (combine) into
  their slots gives the same values without the ``(G, g, k, E, C)``
  one-hot (1.1 GB at Qwen1.5-MoE's prefill with capacity factor 16).

The products (dispatch, the experts' gate/up/down, combine) are
``torch.einsum`` over 3-D operands, plain products the reference computes
outside any Pallas kernel; under ``remat="dots"`` they are recomputed, as
batched products are under the reference's
``dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import local_region, place_as, replicated_like, shard
from repro_torch.models.layers import FFN, Dense, _act_fn, _normal, _param, dense, ffn, init_dense, init_ffn


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0          # d_ff of the shared expert block (total)
    capacity_factor: float = 1.25
    act: str = "silu"
    moe_group: int = 1024         # tokens per dispatch group; capacity and
                                  # dispatch-einsum FLOPs scale with it


class Experts(nn.Module):
    def __init__(self, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
        super().__init__()
        self.gate, self.up, self.down = _param(gate), _param(up), _param(down)


class MoE(nn.Module):
    def __init__(self, router: Dense, experts: Experts, shared: FFN | None = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def init_moe(gen, s: MoESpec, dtype, device=None) -> MoE:
    e, d, f = s.n_experts, s.d_model, s.expert_d_ff
    scale = 1.0 / math.sqrt(d)
    router = init_dense(gen, d, e, dtype, device=device)
    experts = Experts(
        _normal(gen, (e, d, f), scale, dtype, device),
        _normal(gen, (e, d, f), scale, dtype, device),
        _normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype, device),
    )
    shared = None
    if s.n_shared_experts:
        shared = init_ffn(gen, d, s.shared_d_ff or s.expert_d_ff * s.n_shared_experts, dtype, s.act, device)
    return MoE(router, experts, shared)


def _routing(p: MoE, s: MoESpec, x2d: torch.Tensor):
    """x2d: (T, D) -> top-k expert ids (T, k) int64, their renormalized
    weights in x's dtype, and the Switch aux load-balance loss."""
    logits = dense(p.router, x2d).float()                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lower index first among equal probabilities, as jax.lax.top_k
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, : s.top_k], ids[:, : s.top_k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # Switch-style aux loss: E * sum_e fraction_tokens_e * mean_prob_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(ids, s.n_experts).float(), dim=1), dim=0)
    aux = s.n_experts * torch.sum(me * ce)
    return ids, weights.to(x2d.dtype), aux


def group_size(s: MoESpec, t: int) -> int:
    """Tokens per dispatch group: ``moe_group``, halved until it divides t."""
    g = min(s.moe_group, t)
    while t % g:
        g //= 2
    return g


def capacity(s: MoESpec, g: int) -> int:
    """Slots per expert and group: ceil(k * g * capacity_factor / E)."""
    return max(1, int(math.ceil(s.top_k * g * s.capacity_factor / s.n_experts)))


def dispatch_slots(s: MoESpec, ids: torch.Tensor, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ids (T, k) -> (slot (G, g, k) int64: expert * C + position within
    the expert, keep (G, g, k) bool). Positions count each expert's
    (token, choice) pairs of a group in token-major order; a pair at
    position C or later is dropped."""
    t, k = ids.shape
    ng = t // g
    cap = capacity(s, g)
    ids_g = ids.reshape(ng, g * k)
    onehot = F.one_hot(ids_g, s.n_experts)                          # (G, g*k, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos_in_e, 2, ids_g[..., None])[..., 0]       # (G, g*k)
    keep = pos < cap
    slot = ids_g * cap + torch.clamp(pos, max=cap - 1)
    return slot.reshape(ng, g, k), keep.reshape(ng, g, k)


def _experts_of(w: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """An expert weight (E, ...) split over its experts as the dispatched
    tokens ``xe`` (G, E, C, D) are, and whole on every other mesh axis
    (its FSDP shards gathered); a plain tensor as it is."""
    if not isinstance(xe, DTensor):
        return w
    want = tuple(Shard(0) if p == Shard(1) else Replicate() for p in xe.placements)
    return w if tuple(w.placements) == want else w.redistribute(xe.device_mesh, want)


def moe_ffn(p: MoE, s: MoESpec, x: torch.Tensor):
    """x: (B, S, D) -> (y, aux_loss).

    GShard capacity-based dispatch over token groups of ``group_size``:
    capacity C = ceil(k * g * cf / E) scales with the group size, which
    keeps the dispatch FLOPs (T*E*C*D ~ T*g*k*cf*D) a small fraction of
    the experts' FLOPs."""
    b, sl, d = x.shape
    t = b * sl
    g = group_size(s, t)
    ng = t // g
    x2d = x.reshape(t, d)
    ids, weights, aux = _routing(p, s, x2d)
    cap = capacity(s, g)
    e = s.n_experts

    slot, keep = dispatch_slots(s, ids, g)
    kd = keep.to(x.dtype)
    disp = place_as(replicated_like(slot, torch.zeros((ng, g, e * cap), dtype=x.dtype, device=x.device)), slot)
    disp.scatter_add_(2, slot, kd)
    comb = place_as(replicated_like(slot, torch.zeros((ng, g, e * cap), dtype=x.dtype, device=x.device)), slot)
    comb.scatter_add_(2, slot, weights.reshape(ng, g, s.top_k) * kd)
    disp = disp.reshape(ng, g, e, cap)
    comb = comb.reshape(ng, g, e, cap)

    xg = x2d.reshape(ng, g, d)
    xe = torch.einsum("gsec,gsd->gecd", disp, xg)                   # (G, E, C, D)
    xe = shard(xe, "batch", "act_experts", None, None)              # all-to-all: g->E

    def experts(xe, gate, up, down):
        gh = torch.einsum("gecd,edf->gecf", xe, gate)
        uh = torch.einsum("gecd,edf->gecf", xe, up)
        h = _act_fn(s.act)(gh) * uh
        return torch.einsum("gecf,efd->gecd", h, down)              # (G, E, C, D)

    # each rank's token groups against its experts
    ye = local_region(experts, xe, *(_experts_of(w, xe) for w in (p.experts.gate, p.experts.up, p.experts.down)))
    ye = shard(ye, "batch", "act_experts", None, None)
    y = torch.einsum("gsec,gecd->gsd", comb, ye).reshape(b, sl, d)  # (G, g, D)
    y = shard(y, "batch", "seq", None)

    if p.shared is not None:
        y = y + ffn(p.shared, x, s.act)
    return y, aux

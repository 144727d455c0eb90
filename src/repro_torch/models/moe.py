"""Mixture-of-Experts FFN with shared + routed experts (Qwen-MoE / Llama-4,
Granite-4.0-H).

A port of the JAX package's ``models/moe.py``: GShard capacity-based
dispatch over token groups (tokens past an expert's capacity are dropped),
top-k routing with the Switch load-balancing aux loss, and an optional
shared FFN beside the routed experts. The port adds a dropless route
(``MoESpec.route == "dropless"``, ``dropless_ffn``), which the JAX package
has not: every (token, choice) is computed, and the layer holds a share of
the router's experts, as one rank of expert parallelism does.

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

from repro_torch import obs
from repro_torch.distributed.sharding import local_region, place_as, replicated_like, shard
from repro_torch.models.layers import (
    FFN, Dense, _act_fn, _normal, _param, dense, ffn, init_dense, init_ffn, raw_weight,
)


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
    route: str = "gshard"         # "gshard" | "dropless"
    first_expert: int = 0         # the experts held (dropless): first_expert ..
    n_held: int = 0               # + n_held - 1 of the router's; 0: all

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts


class Experts(nn.Module):
    def __init__(self, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
        super().__init__()
        self.gate, self.up, self.down = _param(gate), _param(up), _param(down)


class MoE(nn.Module):
    def __init__(self, router: Dense, experts: Experts, shared: FFN | None = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def init_moe(gen, s: MoESpec, dtype, device=None) -> MoE:
    """The router is ``n_experts`` wide; the expert arrays hold ``held``."""
    d, f = s.d_model, s.expert_d_ff
    e = s.held if s.route == "dropless" else s.n_experts
    scale = 1.0 / math.sqrt(d)
    router = init_dense(gen, d, s.n_experts, dtype, device=device)
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
    weights in x's dtype, and the Switch aux load-balance loss. The dropless
    route takes its logits from a float32 product: bf16 logits tie often
    (8 bits of mantissa over 72 experts), and the tie rule below would then
    favour the lowest expert ids, the first rank's under expert
    parallelism."""
    if s.route == "dropless":
        logits = x2d.float() @ raw_weight(p.router, torch.float32)  # (T, E)
    else:
        logits = dense(p.router, x2d).float()                       # (T, E)
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

    ``route == "dropless"`` runs ``dropless_ffn``. Otherwise GShard
    capacity-based dispatch over token groups of ``group_size``: capacity
    C = ceil(k * g * cf / E) scales with the group size, which keeps the
    dispatch FLOPs (T*E*C*D ~ T*g*k*cf*D) a small fraction of the experts'
    FLOPs."""
    if s.route == "dropless":
        return dropless_ffn(p, s, x)
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


# ------------------------------------------------------------- dropless ----
class GroupedSwiGLU(torch.autograd.Function):
    """The held experts' SwiGLU over rows sorted by expert: ``y = (silu(x
    Wg_e) * (x Wu_e)) Wd_e`` for the rows of group ``e``, rows ``offs[e-1]
    .. offs[e] - 1`` (``offs`` int32, inclusive ends, from 0). Three grouped
    products forward and six backward (the rows' and the weights' gradient
    of each), each one ``torch._grouped_mm`` launch: CUTLASS's grouped GEMM
    on a Hopper card, torch's own loop on the CPU. ``torch._grouped_mm``
    leaves the rows past ``offs[-1]`` of a (rows, N) result unwritten; here
    they come out 0 and take no gradient."""

    @staticmethod
    def forward(ctx, x, gate, up, down, offs):
        g = torch._grouped_mm(x, gate, offs=offs)
        u = torch._grouped_mm(x, up, offs=offs)
        y = torch._grouped_mm(F.silu(g) * u, down, offs=offs)
        valid = (torch.arange(x.shape[0], device=x.device) < offs[-1])[:, None]
        ctx.save_for_backward(x, g, u, gate, up, down, offs, valid)
        return torch.where(valid, y, 0)

    @staticmethod
    def backward(ctx, dy):
        x, g, u, gate, up, down, offs, valid = ctx.saved_tensors
        dy = dy.contiguous()
        gf = g.float()
        sig = torch.sigmoid(gf)
        h = F.silu(g) * u
        dh = torch._grouped_mm(dy, down.transpose(1, 2), offs=offs).float()
        d_down = torch._grouped_mm(h.t(), dy, offs=offs)
        dg = (dh * u.float() * sig * (1 + gf * (1 - sig))).to(x.dtype)
        du = (dh * gf * sig).to(x.dtype)
        d_gate = torch._grouped_mm(x.t(), dg, offs=offs)
        d_up = torch._grouped_mm(x.t(), du, offs=offs)
        dx = torch._grouped_mm(dg, gate.transpose(1, 2), offs=offs)
        dx = dx + torch._grouped_mm(du, up.transpose(1, 2), offs=offs)
        return torch.where(valid, dx, 0), d_gate, d_up, d_down, None


def _grad_task() -> bool:
    """Whether autograd's backward pass is running this code (an activation
    checkpoint's recomputation)."""
    return torch._C._current_graph_task_id() != -1


def dropless_ffn(p: MoE, s: MoESpec, x: torch.Tensor):
    """x: (B, S, D) -> (y, aux_loss), no token dropped.

    The router and its Switch aux loss are over all ``n_experts``; the
    layer computes the part of the result that its held experts
    (``first_expert`` .. + ``held`` - 1) give, and the shared expert once.
    The T * k (token, choice) pairs are sorted by held expert (stable, so a
    token's choices keep token order within an expert), the pairs routed
    elsewhere last; the rows of the sorted pairs run through
    ``GroupedSwiGLU``, where the pairs routed elsewhere lie past
    ``offs[-1]`` and come out 0; each token's k rows are summed weighted
    by its routing weights. Every size is T * k, whatever the routing, so
    nothing waits for the device. Each call outside the backward pass
    tallies the rows routed to the held experts and the largest expert's
    (``obs.tally("moe.rows", [rows, largest])``)."""
    b, sl, d = x.shape
    t, k, e = b * sl, s.top_k, s.held
    x2d = x.reshape(t, d)
    with obs.range("moe.route"):
        ids, weights, aux = _routing(p, s, x2d)
    with obs.range("moe.permute"):
        local = ids - s.first_expert
        key = torch.where((local >= 0) & (local < e), local, e).reshape(t * k)
        order = torch.sort(key, stable=True).indices
        counts = torch.zeros((e + 1,), dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, key, torch.ones_like(key))
        offs = torch.cumsum(counts[:e], 0).to(torch.int32)
        pos = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=x.device))
        xs = x2d[order // k]                                          # (T*k, D), sorted rows
    if not _grad_task():
        obs.tally("moe.rows", torch.stack([counts[:e].sum(), counts[:e].max()]))
    with obs.range("moe.experts"):
        ys = GroupedSwiGLU.apply(xs, p.experts.gate, p.experts.up, p.experts.down, offs)
    with obs.range("moe.combine"):
        y = torch.bmm(weights[:, None, :], ys[pos].view(t, k, d))[:, 0].reshape(b, sl, d)
    if p.shared is not None:
        with obs.range("moe.shared"):
            y = y + ffn(p.shared, x, s.act)
    return y, aux

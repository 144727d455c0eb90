"""AdamW with fp32 master weights, global-norm clipping, cosine schedule and
optional int8 gradient compression with error feedback.

A port of the JAX package's ``optim/adamw.py``. Parameters, grads and the
state's trees are dicts of tensors keyed by parameter name (a module's
``named_parameters()``); the state is ``{"step", "mu", "nu", "master"[,
"err"]}`` as in the reference, with ``step`` a 0-d int32 tensor. Where the
reference returns new arrays, ``adamw_update`` updates the state's
``mu``/``nu``/``master``/``err`` tensors and the parameters in place, so a
step holds no second copy of the optimizer state.

Compression (``compress_grads``) quantizes each grad (plus the carried
residual) to int8 with a per-tensor scale and keeps what the int8 value
misses in ``err`` for the next step; the update sees the dequantized grad.

On CUDA tensors the norm and the per-leaf update are hand-written kernels
(``csrc/adamw.cu``, ``kernels/adamw.py``): one pass a leaf where the eager
code below makes about twenty.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.distributed.sharding import replicated_like
from repro_torch.kernels import adamw as kadamw


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False   # int8 + error feedback


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Zero moments and an fp32 master copy of every parameter, on the
    parameters' devices (placed as the parameters are, for DTensors; the
    step replicated)."""
    first = next(iter(params.values()))
    state = {
        "step": replicated_like(first, torch.zeros((), dtype=torch.int32, device=first.device)),
        "mu": {n: _zeros_f32(p) for n, p in params.items()},
        "nu": {n: _zeros_f32(p) for n, p in params.items()},
        "master": {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()},
    }
    if cfg.compress_grads:
        state["err"] = {n: _zeros_f32(p) for n, p in params.items()}
    return state


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int tensor): linear warmup, then cosine
    decay to a tenth, in fp32."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 quantize with error feedback. Returns (dequantized, new_err)."""
    g = g + err
    q, scale = _quantize_int8(g)
    deq = q.to(torch.float32) * scale
    return deq, g - deq


def _clip(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)


def _step_scalars(cfg: AdamWConfig, step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lr, b1c, b2c)`` at ``step``: the learning rate and the two bias
    corrections, 0-d fp32 tensors on the step's device."""
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    return _schedule(cfg, step), b1c, b2c


def _apply_plain(param: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, master: torch.Tensor,
                 clip: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
                 cfg: AdamWConfig) -> None:
    """One leaf's update in eager fp32 passes (``g`` fp32): the plain
    version of ``csrc/adamw.cu``'s ``adamw_apply``, and the route of leaves
    off the card."""
    g = g * clip
    m = mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v = nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    master.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master))
    param.copy_(master.to(param.dtype))


def _on_kernels(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor]) -> bool:
    """Which route the update takes: True (the kernels) when every parameter
    and gradient is a plain CUDA tensor, False (the eager passes) when none
    is on the card (CPU leaves, and the dry run's meta DTensors). Raises for
    DTensor leaves on the card, whose norm needs a sum across ranks that the
    kernels do not take yet, and for leaves split between the card and
    elsewhere: neither is sent to the eager passes."""
    tensors = (*params.values(), *grads.values())
    if not any(t.is_cuda for t in tensors):
        return False
    odd = sorted({f"{type(t).__name__} on {t.device}" for t in tensors if isinstance(t, DTensor) or not t.is_cuda})
    if odd:
        raise ValueError(f"the AdamW kernels take plain CUDA tensors only; this step also has {odd}")
    return True


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: dict, cfg: AdamWConfig) -> tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step. Returns ``(params, state, metrics)``: the same
    parameter tensors, now holding ``master`` in their own dtype, the state
    dict with its tensors advanced, and ``{"grad_norm", "lr"}`` as 0-d
    fp32 tensors. Weight decay applies to every leaf, as in the reference.

    CUDA leaves take the kernels of ``csrc/adamw.cu`` (the norm, then one
    pass a leaf over gradient, moments, master and parameter, reading the
    gradient in its own dtype); leaves off the card the eager passes of
    ``_apply_plain``. Given the same clip factor the two agree bitwise.
    DTensor leaves on the card raise (``_on_kernels``)."""
    with obs.range("optim.adamw_update"):
        fused = _on_kernels(params, grads)
        if cfg.compress_grads or not fused:
            grads = {n: g.to(torch.float32) for n, g in grads.items()}
        if cfg.compress_grads:
            for n in grads:
                grads[n], state["err"][n] = _compress(grads[n], state["err"][n])

        if fused:
            gnorm, clip = kadamw.adamw_norm_cuda(list(grads.values()), cfg.grad_clip)
        else:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-16)
            clip = _clip(gnorm, cfg)

        step = state["step"] + 1
        lr, b1c, b2c = _step_scalars(cfg, step)
        leaves = [(params[n], g, state["mu"][n], state["nu"][n], state["master"][n]) for n, g in grads.items()]
        if fused:
            kadamw.adamw_apply_cuda(leaves, clip, lr, b1c, b2c, cfg)
        else:
            for leaf in leaves:
                _apply_plain(*leaf, clip, lr, b1c, b2c, cfg)
        state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

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
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch


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
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Zero moments and an fp32 master copy of every parameter, on the
    parameters' devices."""
    first = next(iter(params.values()))
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
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


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: dict, cfg: AdamWConfig) -> tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step. Returns ``(params, state, metrics)``: the same
    parameter tensors, now holding ``master`` in their own dtype, the state
    dict with its tensors advanced, and ``{"grad_norm", "lr"}`` as 0-d
    fp32 tensors. Weight decay applies to every leaf, as in the reference."""
    grads = {n: g.to(torch.float32) for n, g in grads.items()}
    if cfg.compress_grads:
        for n in grads:
            grads[n], state["err"][n] = _compress(grads[n], state["err"][n])

    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-16)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state["step"] + 1
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    for n, g in grads.items():
        g = g * clip
        m = state["mu"][n].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state["nu"][n].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        master = state["master"][n]
        master.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master))
        params[n].copy_(master.to(params[n].dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

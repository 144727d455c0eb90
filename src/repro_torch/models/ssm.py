"""State-space sequence mixers: the RG-LRU of RecurrentGemma.

A port of the RG-LRU half of the JAX package's ``models/ssm.py``: a gated
linear recurrence ``h_t = a_t * h_{t-1} + b_t`` behind a depthwise causal
convolution, with an O(1)-state single-token decode. The reference runs the
prefill's recurrence with ``jax.lax.associative_scan``; here it is
``_linear_scan``, a log-depth doubling scan over the sequence in plain
torch (13 steps at 8,192 positions, each a few fp32 elementwise ops on
``(B, S, W)``), not a loop over positions. No Pallas kernel is involved.

Parameters live in an ``RGLRU`` module named as the JAX tree (``in_proj``,
``conv_w``, ``conv_b``, ``w_r``, ``b_r``, ``w_i``, ``b_i``, ``lam``,
``out_proj``); ``b_r``, ``b_i`` and ``lam`` stay float32, as in the
reference. The Mamba-2 half waits for ROADMAP A4c.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, _normal, _param, dense, init_dense


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    width: int                 # recurrence width (lru_width)
    n_blocks: int = 10         # block-diagonal gate heads
    d_conv: int = 4
    c: float = 8.0


class RGLRU(nn.Module):
    def __init__(self, in_proj: Dense, conv_w, conv_b, w_r, b_r, w_i, b_i, lam, out_proj: Dense):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.w_r, self.b_r = _param(w_r), _param(b_r)
        self.w_i, self.b_i = _param(w_i), _param(b_i)
        self.lam = _param(lam)
        self.out_proj = out_proj


def init_rglru(gen, s: RGLRUSpec, dtype, device=None) -> RGLRU:
    w, nb = s.width, s.n_blocks
    bd = w // nb
    f32 = torch.float32
    return RGLRU(
        init_dense(gen, s.d_model, 2 * w, dtype, device=device),  # x branch + gate branch
        _normal(gen, (s.d_conv, w), 0.1, f32, device).to(dtype),
        torch.zeros((w,), dtype=dtype, device=device),
        _normal(gen, (nb, bd, bd), 1.0 / math.sqrt(bd), f32, device).to(dtype),
        torch.zeros((w,), dtype=f32, device=device),
        _normal(gen, (nb, bd, bd), 1.0 / math.sqrt(bd), f32, device).to(dtype),
        torch.zeros((w,), dtype=f32, device=device),
        torch.linspace(0.9, 0.999, w, dtype=f32, device=device),  # Λ init
        init_dense(gen, w, s.d_model, dtype, device=device),
    )


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B,S,C); w: (K,C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    y = sum(pad[:, i : i + xbc.shape[1], :] * w[i][None, None, :] for i in range(k))
    return F.silu(y + b[None, None, :])


def _block_diag(wp: torch.Tensor, x: torch.Tensor, nb: int) -> torch.Tensor:
    b, sl, w = x.shape
    xb = x.reshape(b, sl, nb, w // nb)
    return torch.einsum("bsnk,nkl->bsnl", xb, wp).reshape(b, sl, w)


def _gates(p: RGLRU, s: RGLRUSpec, xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Recurrence/input gates + log decay. xc: (B,S,W) post-conv."""
    r = torch.sigmoid(_block_diag(p.w_r, xc, s.n_blocks).float() + p.b_r)
    i = torch.sigmoid(_block_diag(p.w_i, xc, s.n_blocks).float() + p.b_i)
    log_a = -s.c * F.softplus(p.lam) * r                            # (B,S,W)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-8)) * (i * xc.float())
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 with h_{-1} = 0, as the
    reference's ``associative_scan`` with ``combine((al, bl), (ar, br)) =
    (al * ar, bl * ar + br)``: at step d each position t >= d combines the
    running pair of t - d into its own (Hillis-Steele), ceil(log2 S) steps."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_prefill(p: RGLRU, s: RGLRUSpec, u: torch.Tensor, return_cache: bool = False):
    """u: (B,S,D) -> (B,S,D). With ``return_cache`` also (the last state
    (B,W) fp32, the conv window (B,K-1,W))."""
    xz = dense(p.in_proj, u)
    xb, gate = xz[..., : s.width], xz[..., s.width :]
    xc = _causal_conv(xb, p.conv_w, p.conv_b)
    a, bvec = _gates(p, s, xc)
    h = _linear_scan(a, bvec)                                       # h_t with h_0 = 0
    y = h.to(u.dtype) * F.gelu(gate, approximate="tanh")
    out = dense(p.out_proj, y)
    if return_cache:
        conv_state = xb[:, -(s.d_conv - 1):, :]
        return out, (h[:, -1, :], conv_state)
    return out


def rglru_decode(p: RGLRU, s: RGLRUSpec, u: torch.Tensor, hstate: torch.Tensor, conv_state: torch.Tensor):
    """u: (B,1,D); hstate: (B,W) fp32; conv_state: (B,K-1,W). Returns (y,
    hstate, conv_state); the two caches are updated in place (the JAX
    version returns new ones) and returned."""
    xz = dense(p.in_proj, u)
    xb, gate = xz[..., : s.width], xz[..., s.width :]
    window = torch.cat([conv_state, xb], dim=1)                     # (B,K,W)
    xc = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b)[:, None, :]
    a, bvec = _gates(p, s, xc)
    hstate.copy_(a[:, 0] * hstate + bvec[:, 0])
    conv_state.copy_(window[:, 1:, :])
    y = hstate[:, None, :].to(u.dtype) * F.gelu(gate, approximate="tanh")
    return dense(p.out_proj, y), hstate, conv_state

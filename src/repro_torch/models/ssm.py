"""State-space sequence mixers: Mamba-2 (SSD) and the RG-LRU of RecurrentGemma.

A port of the JAX package's ``models/ssm.py``. No Pallas kernel is involved
in either mixer: both are plain products, scans and elementwise work.

Mamba-2 uses the chunked state-space-duality algorithm: quadratic
attention-like math within chunks of ``chunk`` positions and a linear
recurrence across chunks (a Python loop over the chunks, where the
reference runs ``lax.scan``). The within-chunk weights
``C_i.B_j * exp(cum_i - cum_j) * dt_j`` are formed once as a
``(B, NC, Q, Q, H)`` tensor and batch-multiplied with x, so the
reference's four-operand einsum never forms its ``(B, NC, Q, Q, H, P)``
product (17 GB in fp32 at Mamba2-1.3B's 8,192-position prefill). Above the
diagonal ``cum_i - cum_j`` is positive and large at chunk 128, where its
exponential overflows; the exponent is masked to -inf before ``exp``, so
those weights are 0 (the reference masks the exponential's ``inf`` with
``where``: the same values, and no ``inf * 0`` in the backward pass).

The RG-LRU is a gated linear recurrence ``h_t = a_t * h_{t-1} + b_t``
behind a depthwise causal convolution, with an O(1)-state single-token
decode. The reference runs the prefill's recurrence with
``jax.lax.associative_scan``; here it is ``_linear_scan``, a log-depth
doubling scan over the sequence in plain torch (13 steps at 8,192
positions, each a few fp32 elementwise ops on ``(B, S, W)``), not a loop
over positions.

Parameters live in ``Mamba2`` and ``RGLRU`` modules named as the JAX tree
(``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``,
``norm_scale``, ``out_proj``; ``in_proj``, ``conv_w``, ``conv_b``, ``w_r``,
``b_r``, ``w_i``, ``b_i``, ``lam``, ``out_proj``). ``a_log``, ``dt_bias``,
``d_skip``, ``b_r``, ``b_i`` and ``lam`` stay float32, as in the reference.
Both decodes update their state and conv window in place (the JAX versions
return new ones) and return them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.distributed.sharding import flatten, place_as, replicated_like, shard, unflatten
from repro_torch.models.layers import Dense, _normal, _param, dense, init_dense


# =========================================================== Mamba-2 (SSD) ==
@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 128         # N
    head_dim: int = 64         # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128           # Q (SSD chunk length)
    n_groups: int = 1          # G (B/C groups)
    norm_eps: float = 1e-6     # the gated RMSNorm's

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class Mamba2(nn.Module):
    def __init__(self, in_proj: Dense, conv_w, conv_b, a_log, dt_bias, d_skip, norm_scale, out_proj: Dense):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.a_log, self.dt_bias, self.d_skip = _param(a_log), _param(dt_bias), _param(d_skip)
        self.norm_scale = _param(norm_scale)
        self.out_proj = out_proj


def init_mamba(gen, s: MambaSpec, dtype, device=None) -> Mamba2:
    d_in = s.d_inner
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + s.n_heads
    f32 = torch.float32
    return Mamba2(
        init_dense(gen, s.d_model, proj_out, dtype, device=device),
        _normal(gen, (s.d_conv, s.conv_channels), 0.1, f32, device).to(dtype),
        torch.zeros((s.conv_channels,), dtype=dtype, device=device),
        torch.log(torch.linspace(1.0, 16.0, s.n_heads, dtype=f32, device=device)),
        torch.zeros((s.n_heads,), dtype=f32, device=device),
        torch.ones((s.n_heads,), dtype=f32, device=device),
        torch.ones((d_in,), dtype=dtype, device=device),
        init_dense(gen, d_in, s.d_model, dtype, device=device),
    )


def _split_proj(s: MambaSpec, zxbcdt: torch.Tensor):
    d_in, gn = s.d_inner, s.n_groups * s.d_state
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in : 2 * d_in]
    bb = zxbcdt[..., 2 * d_in : 2 * d_in + gn]
    cc = zxbcdt[..., 2 * d_in + gn : 2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn :]
    return z, x, bb, cc, dt


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def mamba_prefill(p: Mamba2, s: MambaSpec, u: torch.Tensor, return_cache: bool = False):
    """u: (B,S,D) -> (B,S,D) via chunked SSD; S must be a multiple of
    ``chunk`` (ValueError otherwise). With ``return_cache`` also (the last
    state (B,H,N,P) fp32, the conv window (B,K-1,C): the pre-activation
    projection of the last K-1 positions). A profiler sees the call as the
    range ``ssm.mamba2``."""
    with obs.range("ssm.mamba2"):
        return _mamba_prefill(p, s, u, return_cache)


def _mamba_prefill(p: Mamba2, s: MambaSpec, u: torch.Tensor, return_cache: bool):
    bsz, sl, _ = u.shape
    q = s.chunk
    if sl % q:
        raise ValueError(f"mamba_prefill takes a multiple of the chunk ({q}) positions, got {sl}")
    nc = sl // q
    z, x, bb, cc, dt_raw = _split_proj(s, dense(p.in_proj, u))
    xbc_raw = torch.cat([x, bb, cc], dim=-1)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    gn = s.n_groups * s.d_state
    x = xbc[..., : s.d_inner]
    bb = xbc[..., s.d_inner : s.d_inner + gn]
    cc = xbc[..., s.d_inner + gn :]

    h, pdim, n = s.n_heads, s.head_dim, s.d_state
    xh = x.reshape(bsz, nc, q, h, pdim)
    xh = shard(xh, "batch", None, None, "act_heads", None)
    bg = bb.reshape(bsz, nc, q, s.n_groups, n)[:, :, :, 0]          # G=1 -> (B,NC,Q,N)
    cg = cc.reshape(bsz, nc, q, s.n_groups, n)[:, :, :, 0]
    dt = F.softplus(dt_raw.float() + p.dt_bias)                     # (B,S,H)
    dtc = dt.reshape(bsz, nc, q, h)
    a = -torch.exp(p.a_log)                                         # (H,) negative
    cum = torch.cumsum(dtc * a, dim=2)                              # (B,NC,Q,H) inclusive

    # --- intra-chunk (quadratic) -------------------------------------------
    cb = torch.einsum("bnim,bnjm->bnij", cg, bg).float()            # (B,NC,Q,Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))[:, :, None]
    expo = torch.where(replicated_like(cum, tri), cum[:, :, :, None, :] - cum[:, :, None, :, :], -math.inf)
    wts = cb[..., None] * torch.exp(expo) * dtc[:, :, None, :, :]  # (B,NC,i,j,H)
    xf = xh.float()
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", wts, xf)
    del expo, wts

    # --- chunk states + inter-chunk recurrence ------------------------------
    last = cum[:, :, -1:, :]                                        # (B,NC,1,H)
    w_state = torch.exp(last - cum) * dtc                           # (B,NC,Q,H)
    s_c = torch.einsum("bnjm,bnjhp->bnhmp", bg.float(), xf * w_state[..., None])
    chunk_decay = torch.exp(last[:, :, 0, :])                       # (B,NC,H)
    hstate = torch.zeros((bsz, h, n, pdim), dtype=torch.float32, device=u.device)
    hstate = place_as(replicated_like(s_c, hstate), s_c[:, 0])
    h_before = []
    for c in range(nc):
        h_before.append(hstate)
        hstate = chunk_decay[:, c, :, None, None] * hstate + s_c[:, c]
    h_before = torch.stack(h_before, dim=1)                         # (B,NC,H,N,P)
    y_inter = torch.einsum("bnim,bnhmp->bnihp", cg.float(), h_before) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, sl, h, pdim)
    y = y + p.d_skip[None, None, :, None] * xf.reshape(bsz, sl, h, pdim)
    y = y.reshape(bsz, sl, s.d_inner).to(u.dtype)
    y = _gated_norm(p.norm_scale, y, z, s.norm_eps)
    out = dense(p.out_proj, y)
    if return_cache:
        return out, (hstate, xbc_raw[:, -(s.d_conv - 1):, :])
    return out


def mamba_decode(p: Mamba2, s: MambaSpec, u: torch.Tensor, state: torch.Tensor, conv_state: torch.Tensor):
    """u: (B,1,D); state: (B,H,N,P) fp32; conv_state: (B,K-1,C). Returns
    (y, state, conv_state), the two caches updated in place."""
    bsz = u.shape[0]
    z, x, bb, cc, dt_raw = _split_proj(s, dense(p.in_proj, u))
    window = torch.cat([conv_state, torch.cat([x, bb, cc], dim=-1)], dim=1)  # (B,K,C)
    y_conv = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    y_conv = F.silu(y_conv)[:, None, :]

    h, pdim, n = s.n_heads, s.head_dim, s.d_state
    gn = s.n_groups * n
    x = y_conv[..., : s.d_inner].reshape(bsz, h, pdim)
    bg = y_conv[..., s.d_inner : s.d_inner + gn].reshape(bsz, n)
    cg = y_conv[..., s.d_inner + gn :].reshape(bsz, n)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)              # (B,H)
    a = -torch.exp(p.a_log)
    decay = torch.exp(dt * a[None, :])                             # (B,H)
    upd = torch.einsum("bh,bm,bhp->bhmp", dt, bg.float(), x.float())
    state.copy_(decay[:, :, None, None] * state + upd)
    conv_state.copy_(window[:, 1:, :])
    y = torch.einsum("bm,bhmp->bhp", cg.float(), state)
    y = y + p.d_skip[None, :, None] * x.float()
    y = y.reshape(bsz, 1, s.d_inner).to(u.dtype)
    y = _gated_norm(p.norm_scale, y, z, s.norm_eps)
    return dense(p.out_proj, y), state, conv_state


# ================================================================= RG-LRU ==
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
    xb = unflatten(x, -1, (nb, x.shape[-1] // nb))
    return flatten(torch.einsum("bsnk,nkl->bsnl", xb, wp), 2)


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
    xc = shard(xc, "batch", "seq", "act_d_ff")
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

"""The building blocks of the plain float32 references of the model
families the benchmark trains; each family's loss is in its own file,
``bench/families/<family>.py``.

Written from the published descriptions, not from the program: RMSNorm,
rotary position embedding, grouped-query causal attention, the
cross-entropy over the real vocabulary, and Mamba-2's mixer (arXiv
2405.21060: in-projection to z, x, B, C and dt, a depthwise causal
convolution, the state-space dual form over chunks, a gated RMSNorm,
out-projection).

Parameters come as the JAX-layout tree the benchmark hands to the program
(``bench.weights``): dense weights ``(d_in, d_out)``, block leaves stacked
on a leading layer axis. Every function here computes in float32 (call
``plain_float32()`` first on a GPU, so that no product runs in TF32), and
imports nothing of the program. ``matmul`` is the one place a product
happens, so a lower-precision control can replace it (``bench.control``).
A family's loss recomputes each layer in the backward pass
(``torch.utils.checkpoint``), so that one layer's activations are held at
a time: the reference runs on the card beside its float32 train state.
Family files call products as ``models.matmul``, read at call time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def plain_float32() -> None:
    """Full float32 products on the GPU: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# The product of every dense layer, attention score and value sum; the
# control swaps it for a lower-precision one.
matmul = _plain_matmul


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): each head's two halves rotated by position s at
    frequencies theta^(-2i / hd), i < hd / 2."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int = 8) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, S, KV, hd): query head h reads key head
    h // (H / KV); softmax of q.k / sqrt(hd) over keys up to its own
    position. Heads in blocks of ``block`` so the scores fit."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    outs = []
    for lo in range(0, h, block):
        heads = range(lo, min(h, lo + block))
        qh = q[:, :, lo : lo + len(heads)].transpose(1, 2)                      # (B, h, S, hd)
        kh = torch.stack([k[:, :, i // rep] for i in heads], dim=1)             # (B, h, S, hd)
        vh = torch.stack([v[:, :, i // rep] for i in heads], dim=1)
        scores = matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        outs.append(matmul(p, vh).transpose(1, 2))                               # (B, S, h, hd)
    return torch.cat(outs, dim=2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy over the first ``vocab`` logits (the
    rest are the table's padding rows, which carry no probability)."""
    lf = logits[..., :vocab]
    return (torch.logsumexp(lf, dim=-1) - lf.gather(-1, labels.long()[..., None])[..., 0]).mean()


def _layer(tree: dict, g: int) -> dict:
    return {k: _layer(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


# ------------------------------------------------------------ Mamba-2 ----
def segment_sums(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): entry (i, j) is a_{j+1} + ... + a_i for
    j <= i and -inf above the diagonal (so its exponential is 0)."""
    t = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    keep = torch.ones((t, t), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~keep, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """The state-space dual form of the selective scan, with no initial state:
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t, per head.
    x (B, S, H, P), dt (B, S, H), a (H,) negative, bm and cm (B, S, N) (one
    group shared by every head). Chunks of ``chunk`` positions: within a
    chunk the quadratic form, across chunks the states passed on."""
    b, s, h, p = x.shape
    c = s // chunk
    xc = (x * dt[..., None]).view(b, c, chunk, h, p)
    ac = (dt * a).view(b, c, chunk, h).permute(0, 3, 1, 2)                     # (B, H, C, L)
    bc, cc = bm.view(b, c, chunk, -1), cm.view(b, c, chunk, -1)
    acum = torch.cumsum(ac, dim=-1)
    decay = torch.exp(segment_sums(ac))                                        # (B, H, C, L, L)
    cb = matmul(cc, bc.transpose(-1, -2))                                      # (B, C, L, L)
    w = cb[:, None] * decay                                                    # (B, H, C, L, L)
    y_diag = matmul(w, xc.permute(0, 3, 1, 2, 4)).permute(0, 2, 3, 1, 4)      # (B, C, L, H, P)
    to_end = torch.exp(acum[..., -1:] - acum)                                  # (B, H, C, L)
    states = matmul(bc.transpose(-1, -2)[:, None],                            # (B, 1, C, N, L)
                    (xc.permute(0, 3, 1, 2, 4) * to_end[..., None]))           # -> (B, H, C, N, P)
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)   # (B, H, C+1, N, P)
    carry = torch.exp(segment_sums(F.pad(acum[..., -1], (1, 0))))              # (B, H, C+1, C+1)
    passed = torch.einsum("bhzc,bhcnp->bhznp", carry, states)[:, :, :-1]     # state entering chunk z
    y_off = matmul(cc[:, None], passed) * torch.exp(acum)[..., None]           # (B, H, C, L, P)
    return y_diag + y_off.permute(0, 2, 3, 1, 4)


def mamba_mixer(p: dict, u: torch.Tensor, m: dict) -> torch.Tensor:
    b, s, _ = u.shape
    d_in = m["ssm_expand"] * m["d_model"]
    n, hp = m["ssm_state"], m["ssm_head_dim"]
    h = d_in // hp
    zxbcdt = matmul(u, p["in_proj"]["w"])
    z, xbc, dt = zxbcdt.split([d_in, d_in + 2 * n, h], dim=-1)
    kw = p["conv_w"]                                                           # (K, channels)
    k = kw.shape[0]
    xbc = F.conv1d(xbc.transpose(1, 2), kw.t()[:, None, :], p["conv_b"], padding=k - 1,
                   groups=kw.shape[1])[..., :s].transpose(1, 2)
    x, bm, cm = F.silu(xbc).split([d_in, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(x.view(b, s, h, hp), dt, -torch.exp(p["a_log"]), bm, cm, m["ssm_chunk"])
    y = y.reshape(b, s, h, hp) + p["d_skip"][:, None] * x.view(b, s, h, hp)
    y = rms_norm(y.reshape(b, s, d_in) * F.silu(z), p["norm_scale"], m["norm_eps"])
    return matmul(y, p["out_proj"]["w"])

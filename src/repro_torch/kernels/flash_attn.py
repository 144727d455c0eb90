"""Flash attention on the card: the CUDA forward kernel behind
``flash_attention_cuda`` (``csrc/flash_attn.cu``), its backward behind
``flash_attention_bwd_cuda`` (``csrc/flash_attn_bwd.cu``), the autograd
``Function`` that joins them, and the plain torch version
``flash_attention_plain`` (the backward's plain twins are in ``ref.py``).

The forward kernel replaces the Pallas TPU kernel ``_flash_kernel`` of the
JAX package (``flash_attention_pallas``). The TPU kernel kept a head's
whole K/V resident in VMEM, which capped ``Skv`` at ~24k; the CUDA kernel
streams K/V tiles through shared memory and takes any length, ragged ones
included. It is built for the (qk, v) head-dim pairs in ``HEAD_DIMS``:
equal ones, and MLA's (96, 64) (MiniCPM3-4B), whose v head dim differs
from its qk one. The Pallas kernel has no backward: the JAX package trains
through ``attn_impl="chunked"`` by letting XLA differentiate the blockwise
loop. Here the chunked route on the card is the kernel, so its gradient is
a backward kernel of its own, recomputing P from the forward's
log-sum-exp. Design notes are in the sources.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build, ref

# The (qk, v) head-dim pairs the kernels are built for; any other raises.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (96, 64))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_BM_BF16 = 128  # query rows per block of the bf16 forward kernel


def _check_tma(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts on a 16-byte boundary and every
    stride but the last (1) of a dim longer than 1 is a positive multiple
    of 16 bytes (TMA's rule)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for TMA; its address is {t.data_ptr():#x}")
        dims = zip(t.shape[:-1], t.stride()[:-1])
        bad = [st for n, st in dims if n > 1 and (st <= 0 or st * t.element_size() % 16)]
        if bad:
            raise ValueError(f"{name}'s strides {t.stride()} must be positive multiples of 16 bytes for TMA")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None,
) -> torch.Tensor:
    """The port's ``chunked_attention`` on (B, Sq, H, dqk) queries, reshaped
    as the JAX package's ``ops.flash_attention`` does off the TPU: (B, Sq,
    H, dv), dv being v's head dim."""
    # imported here: repro_torch.models imports kernels.ops, which imports this module
    from repro_torch.models.layers import chunked_attention

    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    out = chunked_attention(
        qg, k, v, causal=causal, window=window, mask_offset=0,
        q_chunk=2048, kv_chunk=1024, scale=scale if scale is not None else 1.0 / math.sqrt(hd),
    )
    return out.reshape(b, sq, h, v.shape[-1])


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """Raise on what the kernels do not take; (B, Sq, H, dqk, Skv, K, dv)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q (B,Sq,H,dqk), k (B,Skv,K,dqk), v (B,Skv,K,dv); got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, hd = q.shape
    _, skv, kh, khd = k.shape
    vd = v.shape[-1]
    if k.shape[0] != b or khd != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"need float32 or bfloat16 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if (hd, vd) not in HEAD_DIMS:
        raise ValueError(f"head dims (qk {hd}, v {vd}) not in {HEAD_DIMS}")
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not fold onto {kh} kv heads")
    if sq < 1 or skv < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"need Sq, Skv >= 1 and B*H <= {_MAX_GRID_Y}; got {sq}, {skv}, {b * h}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim must be contiguous (stride 1)")
    if q.dtype == torch.bfloat16:
        _check_tma(q=q, k=k, v=v)
        if sq + skv >= 2**31 or -(-sq // _BM_BF16) > _MAX_GRID_Y:
            raise ValueError(f"need Sq + Skv < 2**31 and Sq <= {_MAX_GRID_Y * _BM_BF16}; got {sq}, {skv}")
    return b, sq, h, hd, skv, kh, vd


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def _forward(q, k, v, causal: bool, window: int, scale: float, want_lse: bool):
    """Launch the forward kernel on CUDA tensors: (out, lse or None)."""
    b, sq, h, hd, skv, kh, vd = _check_qkv(q, k, v)
    with record_function("flash_attention_cuda"):
        out = torch.empty((b, sq, h, vd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
        lib = _build.load("flash_attn")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.flash_attn_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                b, sq, skv, h, kh, hd, vd, _strides(q, k, v), scale, int(causal), int(window), _DTYPES[q.dtype],
                stream,
            )
        _build.check(err, "flash_attn_launch")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.windowed_launches += window > 0
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the backward kernel: the forward saves
    q, k, v, its output and its log-sum-exp, and the backward calls
    ``flash_attention_bwd_cuda``. On CUDA tensors both directions launch
    the kernels (or raise); on CPU tensors they take the plain twins
    ``ref.flash_attention_lse_plain`` and ``ref.flash_attention_bwd_plain``,
    so the same wiring runs without a card. Under activation checkpointing
    the forward runs again in the backward pass, like any other operation
    of the checkpointed region."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        if q.device.type == "cuda":
            out, lse = _forward(q, k, v, causal, window, scale, want_lse=True)
        else:
            out, lse = ref.flash_attention_lse_plain(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None, return_lse: bool = False,
):
    """q (B, Sq, H, dqk), k (B, Skv, K, dqk) and v (B, Skv, K, dv) -> (B, Sq,
    H, dv) in q's dtype; ``scale`` defaults to 1/sqrt(dqk). With
    ``return_lse`` also the (B, H, Sq) float32 log-sum-exp of each row's
    scaled scores (-inf for a row that sees no key).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``flash_attention_plain`` (``ref.flash_attention_lse_plain`` with
    ``return_lse``). With grad enabled and q, k or v requiring grad the
    call goes through ``FlashAttention``, whose backward is the backward
    kernel on CUDA tensors and its plain twin on CPU ones; ``return_lse``
    is refused there (the lse would carry no gradient). The kernel takes
    float32 or bfloat16 (all three of one dtype), the (dqk, dv) pairs of
    ``HEAD_DIMS`` (32, 64, 128 and 256 with dv = dqk, and (96, 64)), H a
    multiple of K, any Sq, Skv >= 1, and any strides whose last one is 1
    (no copy is made). bfloat16 is loaded by TMA, which needs q, k and v
    to start on a 16-byte boundary and every stride of a dim longer than
    1 to be a multiple of 16 bytes; anything else raises ``ValueError``.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("return_lse under grad: the lse carries no gradient; call under torch.no_grad()")
        return FlashAttention.apply(q, k, v, causal, window, scale)
    if q.device.type != "cuda":
        if return_lse:
            return ref.flash_attention_lse_plain(q, k, v, causal=causal, window=window, scale=scale)
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    out, lse = _forward(q, k, v, causal, window, scale, want_lse=return_lse)
    return (out, lse) if return_lse else out


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary (a copy if it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of attention at q, k, v (as
    ``flash_attention_cuda`` takes them), given its output ``o`` (B, Sq,
    H, dv), its log-sum-exp ``lse`` (B, H, Sq) float32 and the output's
    gradient ``dout``; each in its input's shape and q's dtype.

    A CUDA tensor launches the backward kernels (``csrc/flash_attn_bwd.cu``:
    the delta pass, dK / dV, dQ) or raises; a CPU tensor takes
    ``ref.flash_attention_bwd_plain``. The kernels take what the forward
    takes; ``o`` and ``dout`` (which autograd may hand over strided, or in
    bfloat16 off a 16-byte boundary) are made contiguous and aligned first.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type != "cuda":
        return ref.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal=causal, window=window, scale=scale)
    b, sq, h, hd, skv, kh, vd = _check_qkv(q, k, v)
    if tuple(o.shape) != (b, sq, h, vd) or tuple(dout.shape) != (b, sq, h, vd) or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"need o and dout {(b, sq, h, vd)} and lse {(b, h, sq)}; got {tuple(o.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"need o and dout of q's dtype and float32 lse; got {o.dtype}, {dout.dtype}, {lse.dtype}")
    if not (o.device == dout.device == lse.device == q.device):
        raise ValueError("q, k, v, o, lse and dout must be on one device")
    with record_function("flash_attention_bwd_cuda"):
        o, dout, lse = _dense(o), _dense(dout), lse.contiguous()
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, skv, kh, hd), dtype=q.dtype, device=q.device)
        dv = torch.empty((b, skv, kh, vd), dtype=q.dtype, device=q.device)
        lib = _build.load("flash_attn_bwd")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.flash_attn_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kh, hd, vd,
                _strides(q, k, v), scale, int(causal), int(window), _DTYPES[q.dtype], stream,
            )
        _build.check(err, "flash_attn_bwd_launch")
    flash_attention_cuda.backward_launches += 1
    return dq, dk, dv


# Launches of the forward kernel (``windowed_launches``: those with a
# window) and of the backward kernels (one a backward call, which runs the
# delta, dK / dV and dQ kernels).
flash_attention_cuda.launches = 0
flash_attention_cuda.windowed_launches = 0
flash_attention_cuda.backward_launches = 0

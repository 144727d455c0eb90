"""Forward flash attention on the card: the CUDA kernel behind
``flash_attention_cuda`` (``csrc/flash_attn.cu``) and its plain torch
version ``flash_attention_plain``.

The kernel replaces the Pallas TPU kernel ``_flash_kernel`` of the JAX
package (``flash_attention_pallas``). The TPU kernel kept a head's whole
K/V resident in VMEM, which capped ``Skv`` at ~24k; the CUDA kernel streams
K/V tiles through shared memory and takes any length, ragged ones
included. Design notes are in the source.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_BM_BF16 = 128  # query rows per block of the bf16 kernel


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
    """The port's ``chunked_attention`` on (B, Sq, H, hd) queries, reshaped
    as the JAX package's ``ops.flash_attention`` does off the TPU."""
    # imported here: repro_torch.models imports kernels.ops, which imports this module
    from repro_torch.models.layers import chunked_attention

    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    out = chunked_attention(
        qg, k, v, causal=causal, window=window, mask_offset=0,
        q_chunk=2048, kv_chunk=1024, scale=scale if scale is not None else 1.0 / math.sqrt(hd),
    )
    return out.reshape(b, sq, h, hd)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: float | None = None,
) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Skv, K, hd) -> (B, Sq, H, hd) in q's dtype.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``flash_attention_plain``. The kernel takes float32 or bfloat16 (all
    three of one dtype), head dims 32, 64, 128 and 256, H a multiple of K, any
    Sq, Skv >= 1, and any strides whose last one is 1 (no copy is made).
    bfloat16 is loaded by TMA, which needs q, k and v to start on a 16-byte
    boundary and every stride of a dim longer than 1 to be a multiple of 16
    bytes; anything else raises ``ValueError``. The kernel is forward only:
    with grad enabled and q, k or v requiring grad it raises
    ``RuntimeError`` rather than return an output autograd sees as a
    constant (train through ``attn_impl="dense"``).
    """
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B,Sq,H,hd), k = v (B,Skv,K,hd); got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, hd = q.shape
    _, skv, kh, khd = k.shape
    if k.shape[0] != b or khd != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"need float32 or bfloat16 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "the flash kernel has no backward: run it under torch.no_grad(), "
            'or train through attn_impl="dense"'
        )
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load("flash_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kh, hd,
            strides, scale, int(causal), int(window), _DTYPES[q.dtype], stream,
        )
    _build.check(err, "flash_attn_launch")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.windowed_launches += window > 0
    return out


# Launches of the kernel; ``windowed_launches`` counts those with a window.
flash_attention_cuda.launches = 0
flash_attention_cuda.windowed_launches = 0

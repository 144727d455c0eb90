"""AdamW's update on the card: the CUDA kernels of ``csrc/adamw.cu`` that
``optim.adamw_update`` launches when every leaf is a plain CUDA tensor.

``adamw_norm_cuda`` gives the global gradient norm and the clip factor
(one ``adamw_sumsq`` launch a leaf into fixed slots, one ``adamw_finish``);
``adamw_apply_cuda`` updates each leaf's moments, master and parameter in
one pass (one ``adamw_apply`` launch a leaf). Their plain version is
``optim/adamw.py``'s per-leaf eager code, which leaves off the card
take; given the same clip the kernel's update is bitwise that code's. The
kernels replace no TPU kernel (XLA fused the JAX package's optimizer); the
design notes are in the source. Each launch sits inside a profiler
operation (``obs.op``), so a trace gives its device time to the update.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import _build

# Elements one partial sum covers (kSumTile in csrc/adamw.cu).
SUM_TILE = 256 * 8 * 4
DTYPES = (torch.float32, torch.bfloat16)


def _aligned(*tensors: torch.Tensor) -> int:
    """1 if every tensor starts on a 16-byte boundary (the kernels' vector
    accesses), else 0 (the kernels' scalar loop)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _grad(g: torch.Tensor, device: torch.device) -> torch.Tensor:
    if g.device != device or g.dtype not in DTYPES:
        raise ValueError(f"need float32 or bfloat16 gradients on {device}, got {g.dtype} on {g.device}")
    return g if g.is_contiguous() else g.contiguous()


def adamw_norm_cuda(grads: list[torch.Tensor], grad_clip: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gnorm, clip)``, 0-d float32 tensors on the gradients' device:
    ``gnorm = sqrt(sum of g*g over every leaf + 1e-16)``, ``clip =
    min(grad_clip / max(gnorm, 1e-12), 1)``. Bitwise the same from run to
    run; the sum is taken in another order than the eager path's."""
    device = grads[0].device
    if device.type != "cuda":
        raise ValueError(f"need CUDA gradients, got {device}")
    grads = [_grad(g, device) for g in grads]
    slots = [-(-g.numel() // SUM_TILE) for g in grads]
    # from the caching allocator each call (a buffer the module kept would
    # outlive the model on the card); every slot is written before it is read
    partials = torch.empty(max(sum(slots), 1), dtype=torch.float32, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    lib = _build.load("adamw")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        off = 0
        for g, n in zip(grads, slots):
            if n:
                with obs.op("kernels.adamw_sumsq"):
                    err = lib.adamw_sumsq_launch(g.data_ptr(), g.numel(), int(g.dtype == torch.bfloat16),
                                                 _aligned(g), partials.data_ptr() + 4 * off, stream)
                _build.check(err, "adamw_sumsq_launch")
                adamw_norm_cuda.launches += 1
                off += n
        with obs.op("kernels.adamw_finish"):
            err = lib.adamw_finish_launch(partials.data_ptr(), off, grad_clip, out.data_ptr(), stream)
        _build.check(err, "adamw_finish_launch")
        adamw_norm_cuda.launches += 1
    return out[0], out[1]


def adamw_apply_cuda(leaves: list[tuple[torch.Tensor, ...]], clip: torch.Tensor, lr: torch.Tensor,
                     b1c: torch.Tensor, b2c: torch.Tensor, cfg) -> None:
    """One AdamW step of each ``(param, grad, mu, nu, master)`` leaf, in
    place (``grad`` is only read): the moments, then ``master -= lr *
    ((mu / b1c) / (sqrt(nu / b2c) + eps) + weight_decay * master)`` with
    the gradient scaled by ``clip``, and the parameter set to ``master`` in
    its own dtype. ``clip``, ``lr``, ``b1c``, ``b2c``: 0-d float32 tensors
    on the leaves' device; ``cfg``: an ``AdamWConfig``. Parameters and
    gradients are float32 or bfloat16; mu, nu and master float32."""
    if not leaves:
        return
    device = leaves[0][2].device
    if device.type != "cuda":
        raise ValueError(f"need CUDA tensors, got {device}")
    for s in (clip, lr, b1c, b2c):
        if s.device != device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"need one float32 on {device} for each of clip, lr, b1c, b2c, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    consts = (cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay)
    lib = _build.load("adamw")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for p, g, m, v, w in leaves:
            g = _grad(g, device)
            n = p.numel()
            if p.device != device or p.dtype not in DTYPES or not p.is_contiguous():
                raise ValueError(f"need a contiguous float32 or bfloat16 parameter on {device}, got "
                                 f"{p.dtype} on {p.device}")
            for t in (m, v, w):
                if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                    raise ValueError(f"need contiguous float32 optimizer state on {device}, got {t.dtype} "
                                     f"on {t.device}")
            if any(t.numel() != n for t in (g, m, v, w)):
                raise ValueError(f"a leaf's tensors differ in size: {[t.numel() for t in (p, g, m, v, w)]}")
            if not n:
                continue
            with obs.op("kernels.adamw_apply"):
                err = lib.adamw_apply_launch(
                    p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), w.data_ptr(), n,
                    int(p.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16), _aligned(p, g, m, v, w),
                    clip.data_ptr(), lr.data_ptr(), b1c.data_ptr(), b2c.data_ptr(), *consts, stream)
            _build.check(err, "adamw_apply_launch")
            adamw_apply_cuda.launches += 1


# Launches of each wrapper's kernels: adamw_sumsq (one a non-empty leaf) and
# adamw_finish (one a call); adamw_apply (one a non-empty leaf).
adamw_norm_cuda.launches = 0
adamw_apply_cuda.launches = 0

"""128-bit content fingerprints of on-device tensors: the CUDA kernel
(``csrc/fingerprint.cu``) behind ``fingerprint_chunks_cuda`` and its plain
torch twin.

The paper's future-work item is offloading fingerprint computation to an
accelerator ("GPU for parallel fingerprint computation"); here checkpoint
chunks are fingerprinted on the card without leaving device memory. The
kernel replaces the Pallas TPU kernel ``_fingerprint_kernel`` of the JAX
package; its design notes are in the source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Each block folds this many words of one row (kThreads * kWordsPerThread in
# csrc/fingerprint.cu); the grid's second dimension counts slabs of it.
SLAB_WORDS = 256 * 32
_MAX_WORDS = 65535 * SLAB_WORDS

fingerprint_chunks_plain = ref.fingerprint_chunks


def fingerprint_chunks_cuda(words: torch.Tensor) -> torch.Tensor:
    """(n_chunks, n_words) uint32 -> (n_chunks, 4) uint32 fingerprints.

    A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor takes
    the plain torch twin. Bit-identical to ``ref.fingerprint_chunks``.
    """
    if words.device.type != "cuda":
        return fingerprint_chunks_plain(words)
    if words.ndim != 2 or words.dtype != torch.uint32 or not words.is_contiguous():
        raise ValueError(
            f"need a contiguous 2-D uint32 tensor, got {tuple(words.shape)} {words.dtype}"
        )
    n_chunks, n_words = words.shape
    if not 0 < n_words <= _MAX_WORDS:
        raise ValueError(f"rows need 1..{_MAX_WORDS} words, got {n_words}")
    out = torch.empty((n_chunks, 4), dtype=torch.uint32, device=words.device)
    if n_chunks == 0:
        return out
    lib = _build.load("fingerprint")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fp_chunks_launch(words.data_ptr(), n_chunks, n_words, out.data_ptr(), stream)
    _build.check(err, "fp_chunks_launch")
    fingerprint_chunks_cuda.launches += 1
    return out


fingerprint_chunks_cuda.launches = 0

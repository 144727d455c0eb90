"""PyTorch/CUDA port of the cluster-wide dedup system.

``repro_torch`` imports torch, numpy and the standard library only. Its
device work (naming the chunks of tensors that live on the card, and the
attention of the decoder LM's prefill) runs through hand-written CUDA
kernels for Hopper (``repro_torch/csrc``), each with a plain torch twin
that the CPU tests use. The dense decoder (``models``) and its
prefix-cache server (``serving``) store KV blocks in the dedup cluster. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

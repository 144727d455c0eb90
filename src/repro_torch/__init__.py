"""PyTorch/CUDA port of the cluster-wide dedup system.

``repro_torch`` imports torch, numpy and the standard library only. Its
device work (naming the chunks of tensors that live on the card, and the
attention of the decoder LM's prefill) runs through hand-written CUDA
kernels for Hopper (``repro_torch/csrc``), each with a plain torch twin
that the CPU tests use. The decoder LMs (``models``: dense, sliding-window
and RG-LRU blocks) train with dedup checkpoints (``train``), and the
prefix-cache server (``serving``) stores KV blocks in the dedup cluster.
``examples`` holds the JAX package's examples. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

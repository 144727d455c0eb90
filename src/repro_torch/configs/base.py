"""Model/runtime configuration schema + the assigned input-shape sets.

A copy of the JAX package's ``configs/base.py``; only ``param_dtype`` differs
(a torch dtype, ``torch.bfloat16`` by default)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # layer pattern: repeating group of block kinds
    #   attn_global | attn_local | mla | moe | mamba2 | rglru
    block_pattern: tuple[str, ...] = ("attn_global",)
    window: int = 0                   # sliding window for attn_local
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024
    # SSM / recurrence
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    rglru_width: int = 0
    rglru_blocks: int = 10
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub
    frontend: str = "none"            # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0        # image patch tokens (vlm)
    # capabilities
    sub_quadratic: bool = False       # may run long_500k
    has_decode: bool = True
    param_dtype: Any = torch.bfloat16
    # training
    remat: str = "full"               # full | dots | none
    # dry-run costing: run the group loop as a Python loop instead of
    # lax.scan (XLA's cost analysis counts while bodies once; the roofline
    # extrapolates per-group deltas from unrolled 1- and 2-group variants)
    unroll_layers: bool = False
    # attention implementation: "dense" materializes (S, S) scores
    # (baseline); "chunked" is flash-style double-chunked blockwise
    # attention with O(S * kv_chunk) live memory and static banded ranges
    # for sliding-window layers (beyond-paper §Perf optimization)
    attn_impl: str = "dense"
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 1024
    # serving: KV cache quantization (w8-style kv8). int8 halves decode
    # cache bytes/memory vs bf16; symmetric fixed-point with KV_SCALE.
    kv_cache_quant: bool = False
    # serving: w8a16 weight quantization — dense 2-D weights stored int8
    # with per-tensor scales, dequantized at the matmul (halves the weight
    # stream and residency for decode)
    weight_quant: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the logits dim shards on any mesh
        axis; padded ids are masked to -inf in the loss (MaxText-style)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def tail_blocks(self) -> tuple[str, ...]:
        """Layers beyond the last full pattern group (executed unrolled)."""
        rem = self.n_layers % self.pattern_len
        return self.block_pattern[:rem]

    def validate(self) -> "ModelConfig":
        assert self.n_layers >= 1 and self.d_model > 0
        for k in self.block_pattern:
            assert k in {"attn_global", "attn_local", "mla", "moe", "mamba2", "rglru"}, k
        if "moe" in self.block_pattern:
            assert self.n_experts > 0 and self.top_k > 0 and self.expert_d_ff > 0
        if "mla" in self.block_pattern:
            assert self.kv_lora_rank > 0
        if "mamba2" in self.block_pattern:
            assert self.ssm_state > 0
        if "rglru" in self.block_pattern:
            assert self.rglru_width > 0
        if "attn_local" in self.block_pattern:
            assert self.window > 0
        return self

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat = self.block_pattern
        n_layers = max(len(pat), 2 if len(pat) == 1 else len(pat))
        return dataclasses.replace(
            self,
            n_layers=n_layers + (self.n_layers % self.pattern_len > 0) * len(self.tail_blocks),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            window=min(self.window, 32) if self.window else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=64 if self.expert_d_ff else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            rglru_width=64 if self.rglru_width else 0,
            rglru_blocks=4 if self.rglru_width else 10,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
        )


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not."""
    s = SHAPES[shape]
    if s.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; long_500k skipped (DESIGN.md §4)"
    return True, ""

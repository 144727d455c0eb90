"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) expert_d_ff=8192 vocab=202048.
Treated as full attention per the assigned config (iRoPE chunking not
assigned) -> long_500k skipped, noted in DESIGN.md §4.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    rope_theta=5e5,
    block_pattern=("moe",),
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    expert_d_ff=8192,
    shared_d_ff=8192,
).validate()

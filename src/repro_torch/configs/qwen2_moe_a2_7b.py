"""qwen2-moe-a2.7b — 4 shared + 60 routed experts top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) expert_d_ff=1408 vocab=151936, QKV bias.
Shared block d_ff = 4 x 1408 = 5632.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=("moe",),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    shared_d_ff=5632,
    moe_group=256,   # small groups keep dispatch FLOPs ~8% of expert FLOPs at E=60,k=4
).validate()

"""recurrentgemma-2b — RG-LRU + local attention hybrid, 2:1 [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Pattern (rglru, rglru, attn_local[2048]); 26 = 8 groups + 2 tail rglru.
Sub-quadratic: runs long_500k with O(1) recurrence state.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    act="gelu",
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn_local"),
    window=2048,
    rglru_width=2560,
    rglru_blocks=10,
    sub_quadratic=True,
).validate()

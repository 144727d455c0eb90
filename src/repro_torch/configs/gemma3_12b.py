"""gemma3-12b — 5:1 local:global attention, 128k context [hf:google/gemma-3].

48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.
Pattern group = 5 sliding-window (1024) layers + 1 global layer.
long_500k runs: decode memory is dominated by the ring-buffered local layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    act="gelu",
    tie_embeddings=True,
    rope_theta=1e6,
    block_pattern=("attn_local",) * 5 + ("attn_global",),
    window=1024,
    sub_quadratic=True,
).validate()

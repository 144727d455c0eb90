"""qwen1.5-110b — dense GQA flagship, QKV bias [hf:Qwen/Qwen1.5 family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
The framework's flagship dedup-checkpointing case (~1.5 TB optimizer+param
state per checkpoint). Pure full attention: long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=("attn_global",),
).validate()

"""minicpm3-4b — dense with Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64. Decode uses the absorbed latent cache.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    tie_embeddings=True,
    block_pattern=("mla",),
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
).validate()

"""llava-next-mistral-7b — VLM, Mistral-7B backbone, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. Vision frontend is a
STUB: input_specs() provides 576 precomputed patch embeddings prepended to
the token stream; loss is computed over text positions only.
long_500k skipped (full attention backbone).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    block_pattern=("attn_global",),
    frontend="vision_stub",
    n_frontend_tokens=576,
).validate()

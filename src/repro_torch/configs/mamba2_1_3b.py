"""mamba2-1.3b — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=2048, d_ff=0 (pure Mamba-2 stack), vocab=50280, ssm_state=128.
Sub-quadratic: runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # SSD heads = d_inner / head_dim = 4096/64
    n_kv_heads=64,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    block_pattern=("mamba2",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    sub_quadratic=True,
).validate()

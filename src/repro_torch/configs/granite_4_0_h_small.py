"""granite-4.0-h-small — hybrid Mamba-2 / NoPE GQA, 72-expert top-10 MoE after
every mixer, 32B-A9B [hf:ibm-granite/granite-4.0-h-small, config.json].

40L d_model=4096; ``layer_types`` puts attention at layers 5, 15, 25 and 35,
so each period of 10 is 5 Mamba-2, 1 attention, 4 Mamba-2. Mamba-2: 128
heads of 64, d_state 128, 1 group, expand 2, conv 4 (with a bias), chunk
256. Attention: 32 query and 8 KV heads of 128, no position embedding,
softmax scale ``attention_multiplier`` 1/128. Every layer's FFN is the MoE:
72 experts of width 768, top-10 (softmax, then the top 10 renormalized),
and an ungated shared SwiGLU of 1,536. muP: embedding x 12, each branch x
0.22 before its residual add, logits / 16. RMSNorm eps 1e-5 (the gated norm
too), tied embeddings, vocab 100,352. Dropless routing; the full 72 experts
held (a deployment's expert-parallel rank sets ``n_held_experts`` and
``first_held_expert``).
"""

from repro_torch.configs.base import ModelConfig

# layer_types of the source, one period: "mamba" x 5, "attention", "mamba" x 4
PERIOD = ("mamba2_moe",) * 5 + ("moe",) + ("mamba2_moe",) * 4

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=100352,
    tie_embeddings=True,
    rope_theta=1e4,
    norm_eps=1e-5,
    block_pattern=PERIOD,
    n_experts=72,
    top_k=10,
    n_shared_experts=1,
    expert_d_ff=768,
    shared_d_ff=1536,
    moe_route="dropless",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_norm_eps=1e-5,
    position_embedding="nope",
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    sub_quadratic=False,
).validate()

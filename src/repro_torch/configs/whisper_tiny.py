"""whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865. The conv/audio
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, seq_len/2, d_model); the decoder gets seq_len/2 tokens (DESIGN.md §4).
long_500k skipped (enc-dec, bounded decoder by design).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    tie_embeddings=True,
    enc_dec=True,
    n_enc_layers=4,
    frontend="audio_stub",
).validate()

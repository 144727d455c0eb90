"""Architecture registry: --arch <id> -> ModelConfig."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, shape_applicable
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.granite_4_0_h_small import CONFIG as _granite
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen32b
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.whisper_tiny import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    c.arch_id: c
    for c in [
        _mamba2,
        _minicpm3,
        _qwen32b,
        _gemma3,
        _qwen110b,
        _rgemma,
        _llama4,
        _qwen_moe,
        _whisper,
        _llava,
        _granite,
    ]
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config", "shape_applicable"]

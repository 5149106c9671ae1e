"""Config registry: the federated round config, the assigned architectures
and input shapes (counterpart of ``repro/configs/__init__.py``)."""
from repro_torch.configs.base import (ATTN, ATTN_MOE, MAMBA, MAMBA_MOE,
                                      MLSTM, SLSTM, DECODE_32K, INPUT_SHAPES,
                                      LONG_500K, PREFILL_32K, TRAIN_4K,
                                      FederatedConfig, InputShape,
                                      ModelConfig, MoEConfig)

from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.yi_9b import CONFIG as YI_9B
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA_52B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B

ARCHITECTURES = {
    c.name: c for c in (
        QWEN3_MOE_235B, QWEN1_5_0_5B, MINITRON_8B, YI_9B, XLSTM_350M,
        JAMBA_52B, WHISPER_TINY, INTERNVL2_26B, PHI4_MINI, ARCTIC_480B,
    )
}

# Short CLI aliases (--arch <id>)
ALIASES = {name: name for name in ARCHITECTURES}


def get_arch(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[key]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = [
    "ARCHITECTURES", "ALIASES", "INPUT_SHAPES", "ModelConfig", "MoEConfig",
    "InputShape", "FederatedConfig", "get_arch", "get_shape",
    "ATTN", "ATTN_MOE", "MAMBA", "MAMBA_MOE", "MLSTM", "SLSTM",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]

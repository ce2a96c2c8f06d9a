"""Config registry: get_config("<arch-id>") and the shape registry."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs import (
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    granite_3_2b,
    llama_3_2_vision_11b,
    mamba2_780m,
    qwen1_5_110b,
    qwen2_5_32b,
    qwen2_5_3b,
    seamless_m4t_large_v2,
    zamba2_2_7b,
)

_MODULES = [
    seamless_m4t_large_v2,
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    granite_3_2b,
    qwen1_5_110b,
    qwen2_5_3b,
    qwen2_5_32b,
    mamba2_780m,
    zamba2_2_7b,
    llama_3_2_vision_11b,
]

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells for an arch; long_500k only for sub-quadratic archs
    (skip rule recorded in DESIGN.md §Arch-applicability)."""
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(name)
    return out


__all__ = ["REGISTRY", "ARCH_IDS", "SHAPES", "ModelConfig", "ShapeSpec",
           "get_config", "applicable_shapes"]

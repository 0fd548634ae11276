"""Architecture registry of the port: --arch <id> resolves here."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (arctic_480b, falcon_mamba_7b, grok1_314b,
                                 internvl2_26b, musicgen_large, olmo_1b,
                                 qwen3_32b, smollm_135m, stablelm_12b,
                                 zamba2_27b)
from repro_torch.configs.base import (GradientFlowConfig, MeshConfig,
                                      ModelConfig, MoEConfig,
                                      OptimizerConfig, SSMConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.shapes import SHAPES, shapes_for

# The JAX package's registry order.
_MODULES = {
    "musicgen-large": musicgen_large,
    "grok-1-314b": grok1_314b,
    "arctic-480b": arctic_480b,
    "internvl2-26b": internvl2_26b,
    "qwen3-32b": qwen3_32b,
    "stablelm-12b": stablelm_12b,
    "olmo-1b": olmo_1b,
    "smollm-135m": smollm_135m,
    "falcon-mamba-7b": falcon_mamba_7b,
    "zamba2-2.7b": zamba2_27b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown architecture {arch_id!r} (known: {sorted(_MODULES)}); "
            f"see ROADMAP.md queue A") from None


def get_arch(arch_id: str) -> Tuple[ModelConfig, None]:
    """(full config, rules). The port has no tensor-parallel rule table,
    so the second entry is None."""
    return _module(arch_id).CONFIG, None


def get_smoke(arch_id: str) -> Tuple[ModelConfig, None]:
    return _module(arch_id).SMOKE, None


__all__ = ["ARCH_IDS", "GradientFlowConfig", "MeshConfig", "ModelConfig",
           "MoEConfig", "OptimizerConfig", "SHAPES", "SSMConfig",
           "ShapeConfig", "TrainConfig", "get_arch", "get_smoke",
           "shapes_for"]

"""Architecture registry of the port: --arch <id> resolves here."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def get_arch(arch_id: str) -> Tuple[ModelConfig, Dict[str, Optional[str]]]:
    """(full config, its rule table: logical axis -> 'model' or None;
    ``parallel.sharding``)."""
    mod = _module(arch_id)
    return mod.CONFIG, dict(mod.RULES)


def get_smoke(arch_id: str) -> Tuple[ModelConfig, Dict[str, Optional[str]]]:
    mod = _module(arch_id)
    return mod.SMOKE, dict(mod.RULES)


def rules_for(model_cfg: ModelConfig) -> Dict[str, Optional[str]]:
    """The rule table of the architecture whose full or smoke config has
    ``model_cfg``'s name."""
    for mod in _MODULES.values():
        if model_cfg.name in (mod.CONFIG.name, mod.SMOKE.name):
            return dict(mod.RULES)
    raise KeyError(f"no architecture has a config named "
                   f"{model_cfg.name!r}; pass the rules explicitly")


__all__ = ["ARCH_IDS", "GradientFlowConfig", "MeshConfig", "ModelConfig",
           "MoEConfig", "OptimizerConfig", "SHAPES", "SSMConfig",
           "ShapeConfig", "TrainConfig", "get_arch", "get_smoke", "rules_for",
           "shapes_for"]

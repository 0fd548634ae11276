"""Architecture registry of the port: --arch <id> resolves here.
``ARCH_IDS`` are the JAX package's architectures, in its registry's
order; ``PORT_ARCH_IDS`` those only the port runs."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs import (arctic_480b, falcon_mamba_7b, grok1_314b,
                                 internvl2_26b, musicgen_large, olmo_1b,
                                 qwen3_32b, smollm_135m, stablelm_12b,
                                 trinity_mini, zamba2_27b)
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

# (full config, smoke config, rule table) of each architecture.
_ARCHS = {a: (m.CONFIG, m.SMOKE, m.RULES) for a, m in _MODULES.items()}
_ARCHS["trinity-mini"] = (trinity_mini.CONFIG, trinity_mini.SMOKE,
                          trinity_mini.RULES)
_ARCHS["trinity-mini-ep4"] = (trinity_mini.EP4, trinity_mini.SMOKE,
                              trinity_mini.RULES)
PORT_ARCH_IDS = ("trinity-mini", "trinity-mini-ep4")


def _arch(arch_id: str):
    try:
        return _ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown architecture {arch_id!r} (known: {sorted(_ARCHS)}); "
            f"see ROADMAP.md queue A") from None


def get_arch(arch_id: str) -> Tuple[ModelConfig, Dict[str, Optional[str]]]:
    """(full config, its rule table: logical axis -> 'model' or None;
    ``parallel.sharding``)."""
    full, _, rules = _arch(arch_id)
    return full, dict(rules)


def get_smoke(arch_id: str) -> Tuple[ModelConfig, Dict[str, Optional[str]]]:
    _, smoke, rules = _arch(arch_id)
    return smoke, dict(rules)


def rules_for(model_cfg: ModelConfig) -> Dict[str, Optional[str]]:
    """The rule table of the architecture whose full or smoke config has
    ``model_cfg``'s name."""
    for full, smoke, rules in _ARCHS.values():
        if model_cfg.name in (full.name, smoke.name):
            return dict(rules)
    raise KeyError(f"no architecture has a config named "
                   f"{model_cfg.name!r}; pass the rules explicitly")


__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "GradientFlowConfig", "MeshConfig", "ModelConfig",
           "MoEConfig", "OptimizerConfig", "SHAPES", "SSMConfig",
           "ShapeConfig", "TrainConfig", "get_arch", "get_smoke", "rules_for",
           "shapes_for"]

from repro_torch.models.hybrid_lm import HybridLM
from repro_torch.models.registry import build_model
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import TransformerLM

__all__ = ["HybridLM", "MambaLM", "TransformerLM", "build_model"]

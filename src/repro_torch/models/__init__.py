from repro_torch.models.registry import build_model
from repro_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM", "build_model"]

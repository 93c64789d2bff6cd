from repro_torch.models.lm import Model
from repro_torch.models.registry import build_model

__all__ = ["Model", "build_model"]

from repro_torch.models.lm import Model
from repro_torch.models.registry import build_model, input_specs

__all__ = ["Model", "build_model", "input_specs"]

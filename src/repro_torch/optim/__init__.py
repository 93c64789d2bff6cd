from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["adamw_init", "adamw_update", "cosine_warmup"]

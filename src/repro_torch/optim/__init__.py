from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.compression import (
    compress_grads,
    compressed_allreduce,
    compression_init,
    decompress_and_correct,
)

__all__ = ["adamw_init", "adamw_update", "compress_grads", "compressed_allreduce",
           "compression_init", "cosine_warmup", "decompress_and_correct"]

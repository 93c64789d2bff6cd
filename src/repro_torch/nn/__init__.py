"""Neural-network building blocks, the port of the reference's
``repro.nn``: dense layers, norms and the coupling conditioners at the
package level; attention, MoE, the SSM mixers, rotary embeddings and the
FFNs in their modules."""

# ``core``'s modules import ``nn.nets``, and ``nn.linear`` imports
# ``core.types``: load ``core`` first, so that a cold ``import
# repro_torch.nn`` never meets a half-loaded ``nn.linear``
import repro_torch.core  # noqa: F401  isort: skip
from repro_torch.nn.linear import Dense, dense_apply, dense_init
from repro_torch.nn.nets import CouplingCNN, CouplingMLP
from repro_torch.nn.norm import layernorm, rmsnorm

__all__ = [
    "Dense",
    "dense_init",
    "dense_apply",
    "rmsnorm",
    "layernorm",
    "CouplingMLP",
    "CouplingCNN",
]

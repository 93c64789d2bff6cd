"""rwkv6-7b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""

from repro_torch.config import ArchSpec, ModelConfig, SSMConfig, register_arch

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", expand=1, head_dim=64),
)

REDUCED = CONFIG.replace(
    name="rwkv6-7b-reduced",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=384,
    ssm=SSMConfig(kind="rwkv6", expand=1, head_dim=16),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="arXiv:2404.05892; hf"))

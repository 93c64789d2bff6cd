"""yi-6b — dense llama-arch GQA [arXiv:2403.04652; hf]."""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=4, head_dim=128, rope_theta=5e6),
    ffn_kind="swiglu",
)

REDUCED = CONFIG.replace(
    name="yi-6b-reduced",
    n_layers=2,
    d_model=64,
    d_ff=160,
    vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="arXiv:2403.04652; hf"))

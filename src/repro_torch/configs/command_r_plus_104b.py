"""command-r-plus-104b — dense GQA kv=8, no-bias, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01]."""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    d_ff=33792,
    vocab_size=256000,
    attention=AttentionConfig(n_heads=96, n_kv_heads=8, head_dim=128, rope_theta=75e4),
    ffn_kind="swiglu",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    name="command-r-plus-104b-reduced",
    n_layers=2,
    d_model=96,
    d_ff=256,
    vocab_size=512,
    attention=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=16),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="hf:CohereForAI/c4ai-command-r-v01"))

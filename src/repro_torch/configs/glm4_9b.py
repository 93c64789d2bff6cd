"""glm4-9b — dense, RoPE, GQA kv=2, qkv bias [hf:THUDM/glm-4-9b]."""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151552,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=2, head_dim=128, rope_theta=1e4, qkv_bias=True
    ),
    ffn_kind="swiglu",
)

REDUCED = CONFIG.replace(
    name="glm4-9b-reduced",
    n_layers=2,
    d_model=64,
    d_ff=192,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="hf:THUDM/glm-4-9b"))

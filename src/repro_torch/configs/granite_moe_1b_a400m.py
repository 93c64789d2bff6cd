"""granite-moe-1b-a400m — 32 experts top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, MoEConfig, register_arch

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49155,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=64),
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    ffn_kind="swiglu",
)

REDUCED = CONFIG.replace(
    name="granite-moe-1b-a400m-reduced",
    n_layers=2,
    d_model=64,
    d_ff=64,
    vocab_size=384,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="hf:ibm-granite/granite-3.0-1b-a400m-base"))

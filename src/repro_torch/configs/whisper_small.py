"""whisper-small — encoder-decoder audio model; conv front end stubbed
(precomputed 1500-frame embeddings) [arXiv:2212.04356].

As in the reference: RoPE instead of learned/sinusoidal absolute positions,
RMSNorm instead of LayerNorm."""

from repro_torch.config import (
    ArchSpec,
    AttentionConfig,
    FrontendConfig,
    ModelConfig,
    register_arch,
)

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder
    encoder_layers=12,
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attention=AttentionConfig(n_heads=12, n_kv_heads=12, head_dim=64, qkv_bias=True),
    frontend=FrontendConfig(kind="audio", n_frames=1500),
    ffn_kind="gelu_mlp",
)

REDUCED = CONFIG.replace(
    name="whisper-small-reduced",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=384,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16, qkv_bias=True),
    frontend=FrontendConfig(kind="audio", n_frames=12),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="arXiv:2212.04356"))

"""granite-34b — dense code model, MQA (kv=1), GELU MLP
[arXiv:2405.04324; hf].  Upstream is gpt-bigcode (absolute positions); we use
RoPE uniformly, as the reference does."""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attention=AttentionConfig(n_heads=48, n_kv_heads=1, head_dim=128),
    ffn_kind="gelu_mlp",
)

REDUCED = CONFIG.replace(
    name="granite-34b-reduced",
    n_layers=3,
    d_model=64,
    d_ff=256,
    vocab_size=384,
    attention=AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=16),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="arXiv:2405.04324; hf"))

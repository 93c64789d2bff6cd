"""zamba2-7b — hybrid: Mamba2 blocks + one shared attention+MLP block applied
every 6 Mamba2 blocks (shared weights) [arXiv:2411.15242].

81 Mamba2 blocks, ssm_state=64; the shared transformer block (32-head MHA,
d_ff=14336) is reused at every application (weights in ``Ctx.extra``; each
application has its own norms and KV cache).  Upstream alternates two shared
blocks; the reference uses one, and so does the port.
"""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, SSMConfig, register_arch

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=112),
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_attn_every=6,
)

REDUCED = CONFIG.replace(
    name="zamba2-7b-reduced",
    n_layers=5,  # 2 superblocks of 2 + tail of 1
    d_model=64,
    d_ff=128,
    vocab_size=384,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
    ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    hybrid_attn_every=2,
)

register_arch(ArchSpec(CONFIG, REDUCED, source="arXiv:2411.15242"))

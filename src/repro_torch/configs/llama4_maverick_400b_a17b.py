"""llama4-maverick-400b-a17b — MoE 128e top-1, alternating dense/MoE layers,
shared expert, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

The reference's interpretation: 48 layers with MoE every other layer
(interleave=2), 128 routed experts top-1 + 1 shared expert, expert d_ff=8192
— this reproduces the ~400B total / ~17B active parameter budget.
"""

from repro_torch.config import ArchSpec, AttentionConfig, ModelConfig, MoEConfig, register_arch

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=5e5),
    moe=MoEConfig(
        n_experts=128, top_k=1, d_ff_expert=8192, interleave=2, shared_expert=True
    ),
    ffn_kind="swiglu",
)

REDUCED = CONFIG.replace(
    name="llama4-maverick-400b-a17b-reduced",
    n_layers=4,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128, interleave=2, shared_expert=True),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="hf:meta-llama/Llama-4-Scout-17B-16E"))

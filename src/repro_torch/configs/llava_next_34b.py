"""llava-next-34b — VLM: Yi-34B-style backbone + anyres patch front end (stub)
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The modality front end is a stub: ``models/registry.py::input_specs`` names
precomputed patch embeddings (CLIP-dim 1024); a learned projector maps them
into the text stream."""

from repro_torch.config import (
    ArchSpec,
    AttentionConfig,
    FrontendConfig,
    ModelConfig,
    register_arch,
)

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64000,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128, rope_theta=5e6),
    frontend=FrontendConfig(kind="vision", n_patches=576),
    ffn_kind="swiglu",
)

REDUCED = CONFIG.replace(
    name="llava-next-34b-reduced",
    n_layers=2,
    d_model=64,
    d_ff=160,
    vocab_size=384,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    frontend=FrontendConfig(kind="vision", n_patches=8),
)

register_arch(ArchSpec(CONFIG, REDUCED, source="hf:llava-hf/llava-v1.6-mistral-7b-hf"))

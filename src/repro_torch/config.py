"""Configurations of the port: single-device training (``TrainConfig``)
and the language models (``AttentionConfig``, ``MoEConfig``,
``SSMConfig``, ``ModelConfig``, the architecture registry), copied from the
reference's ``repro/config.py`` with its fields and defaults.

``TrainConfig`` holds the fields of the port's supervised loop
(``train/loop.py``), with the reference's defaults but one:
``checkpoint_dir`` is None, no checkpoints, unless a directory is named
(the reference's default, ``"checkpoints"``, is relative to the working
directory).  ``seed`` is kept for the reference's layout; a model arrives
initialised from the generator it was built with.  The reference's
``remat_policy`` is not kept (``train_lm`` takes the stack's engine as its
``grad_mode``).  ``grad_compression`` (``optim/compression.py``) and the
GPipe fields (``train_pipeline``) are the reference's.

``ModelConfig`` keeps every field of the reference so a configuration reads
the same in both packages.  ``SSMConfig`` (Mamba2 and RWKV6 mixers),
``MoEConfig`` (the routed experts) and ``FrontendConfig`` (the vision and
audio front ends, which take precomputed embeddings) are ported, and
``ShapeSpec`` names an input cell for ``models/registry.py::input_specs``.
Architectures register themselves from ``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    seed: int = 0
    # fault tolerance
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None  # None: no checkpoints
    keep_checkpoints: int = 3
    max_restarts: int = 3
    step_timeout_s: float = 0.0  # 0 = straggler watchdog off
    # error-feedback gradient compression: none | topk | int8
    grad_compression: str = "none"
    compression_ratio: float = 0.01  # for topk
    # gradient accumulation: microbatches per (per-rank) step; 1 = off
    accum_steps: int = 1
    # host input pipeline: batches built ahead of the running step; 0 = none
    prefetch: int = 2
    # GPipe depth parallelism (train_pipeline): microbatches streamed
    # through the "pipe" mesh axis per step; 0 = no pipeline mode
    pipeline_microbatches: int = 0
    pipeline_axis: str = "pipe"

    def __post_init__(self):
        if self.grad_compression not in ("none", "topk", "int8"):
            raise ValueError(f"grad_compression must be none, topk or int8, got "
                             f"{self.grad_compression!r}")


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    causal: bool = True
    qkv_bias: bool = False
    # sliding-window size (0 = full attention)
    window: int = 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # MoE every ``interleave``-th block (1 = every block, 2 = alternating)
    interleave: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str  # "mamba2" | "rwkv6"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # chunk length for the blocked scan
    # rwkv6: 0 = per-token wkv scan; >0 = chunked
    wkv_chunk: int = 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class FrontendConfig:
    """A modality front end that takes precomputed embeddings."""

    kind: str  # "audio" | "vision"
    # vision: number of patch embeddings prepended to the text sequence
    n_patches: int = 576
    # audio: number of encoder frames produced by the (stubbed) conv front end
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None

    # hybrid (zamba2): apply the shared attention block every k SSM blocks
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper): encoder depth; n_layers is the decoder depth
    encoder_layers: int = 0
    # the layer stack as an additive coupling over two residual streams
    reversible: bool = True

    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master parameter dtype
    residual_dtype: str = "float32"  # reversible residual stream dtype

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    ffn_kind: str = "swiglu"  # swiglu | gelu_mlp
    logit_softcap: float = 0.0
    # sequence-parallel attention (distribution slice)
    attn_seq_shard: bool = False

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.ssm is not None and self.hybrid_attn_every == 0 and self.attention is None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def _attn_params(self) -> int:
        a = self.attention
        if a is None:
            return 0
        return self.d_model * (a.q_dim + 2 * a.kv_dim) + a.q_dim * self.d_model

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.ffn_kind == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        if s is None:
            return 0
        d_in = s.d_inner(self.d_model)
        if s.kind == "mamba2":
            n_heads = s.n_heads(self.d_model)
            in_proj = self.d_model * (2 * d_in + 2 * s.d_state + n_heads)
            return in_proj + d_in * s.d_conv + d_in * self.d_model + 2 * n_heads
        return 5 * self.d_model * d_in + d_in * self.d_model

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count, as the reference counts it;
        ``active_only`` counts the MoE experts a token uses."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for i in range(self.n_layers + self.encoder_layers):
            if self.family == "hybrid":
                n += self._ssm_params()
                continue
            if self.ssm is not None and self.family == "ssm":
                n += self._ssm_params()
                if self.ssm.kind == "rwkv6":
                    n += 2 * self.d_model * self.d_ff
                    continue
            else:
                n += self._attn_params()
            if self.moe is not None and (i % self.moe.interleave == self.moe.interleave - 1):
                k = self.moe.top_k if active_only else self.moe.n_experts
                n += k * self._ffn_params(self.moe.d_ff_expert)
                if self.moe.shared_expert:
                    n += self._ffn_params(self.moe.d_ff_expert)
                n += self.d_model * self.moe.n_experts
            else:
                n += self._ffn_params(self.d_ff)
        if self.hybrid_attn_every and self.attention is not None:
            n += self._attn_params() + self._ffn_params(self.d_ff)
        return n


@dataclass(frozen=True)
class ShapeSpec:
    """One input cell: a train, prefill or decode batch of ``global_batch``
    sequences of ``seq_len`` positions."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the input-shape cells of the dry run, the reference's
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """The reference's skip rule: ``long_500k`` needs sub-quadratic
    attention, so it runs for the ``ssm`` and ``hybrid`` families only."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    """A registered architecture: full config + reduced smoke-test config."""

    config: ModelConfig
    reduced: ModelConfig
    notes: str = ""
    source: str = ""


def register_arch(spec: ArchSpec) -> ArchSpec:
    name = spec.config.name
    if name in _REGISTRY and _REGISTRY[name] is not spec:
        raise ValueError(f"duplicate architecture registration: {name}")
    _REGISTRY[name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    """The registered architecture ``name``: yi-6b, glm4-9b, granite-34b,
    command-r-plus-104b, granite-moe-1b-a400m, llama4-maverick-400b-a17b,
    rwkv6-7b, zamba2-7b, whisper-small or llava-next-34b."""
    import repro_torch.configs  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)

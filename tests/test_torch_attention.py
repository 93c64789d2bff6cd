"""The port's attention side against the JAX reference on the CPU: the plain
flash attention (``flash_sdpa``'s CPU path) against the reference's Pallas
kernel in interpret mode, ``attn_apply`` with and without a cache, and the
norm, rotary and FFN primitives.  Inputs come from numpy with a seed;
weights are drawn once and handed to both packages.

Tolerances: ``flash_sdpa`` at the reference's own ``_tol``
(``tests/test_kernels.py:43``: 2e-5 in f32, 2e-2 in bf16), and so the
TF32 kernel's CPU mirror (``attention_tf32_ref``: 3xTF32 products, the
online softmax over 64-key tiles) in f32; ``attn_apply``
at 1e-5 absolute in f32 (its outputs are O(1): two products of width 64 and
a softmax, summed in another order) and 2e-2 in bf16 (one bf16 ulp of the
O(1) outputs, with scores rounded to bf16 on both sides); the elementwise
primitives and the FFNs at 1e-6 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttentionConfig
from repro.kernels.attention.ops import flash_sdpa as j_flash_sdpa
from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro.nn.attention import attn_apply as j_attn_apply
from repro.nn.attention import make_cache as j_make_cache
from repro.nn.mlp import ffn_apply as j_ffn_apply
from repro.nn.norm import layernorm as j_layernorm
from repro.nn.norm import rmsnorm as j_rmsnorm
from repro.nn.rotary import apply_rope as j_apply_rope
from repro_torch.config import AttentionConfig
from repro_torch.kernels.attention import attention as kern
from repro_torch.kernels.attention.ops import flash_sdpa
from repro_torch.kernels.attention.ref import attention_tf32_ref
from repro_torch.nn.attention import attn_apply, make_cache
from repro_torch.nn.mlp import ffn_apply
from repro_torch.nn.norm import layernorm, rmsnorm
from repro_torch.nn.rotary import apply_rope

torch.set_num_threads(4)
SEED = 20261017
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    """Run the reference's Pallas kernel body (interpret mode), as its own
    kernel tests do, rather than its CPU dispatch to the jnp oracle."""
    from repro.kernels.common import INTERPRET_ENV

    monkeypatch.setenv(INTERPRET_ENV, "1")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a JAX and a torch tensor of ``dtype`` (bf16
    rounded once, in JAX, so both sides hold the same values)."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


# (B, Hq, Hkv, Sq, Skv, D): the reference's kernel-test shapes
# (tests/test_kernels.py:277-279), the head dims of src/repro/configs
# (16, 112, 128), and a top-left causal case with Sq != Skv
FLASH_SHAPES = [
    (1, 4, 4, 256, 256, 32), (2, 8, 2, 256, 256, 64), (1, 6, 1, 512, 512, 64),
    (2, 4, 2, 128, 128, 16), (1, 4, 1, 128, 128, 112), (1, 8, 2, 128, 128, 128),
    (1, 4, 2, 128, 256, 32),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_sdpa_matches_the_reference_kernel(interpret, shape, dtype, causal):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(SEED)
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal(s, np.float32), dtype)
                                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    o_ref = j_flash_sdpa(jq, jk, jv, causal=causal)
    o = flash_sdpa(q, k, v, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol(dtype))
    np.testing.assert_allclose(_np(o), _np(j_attention_ref(jq, jk, jv, causal=causal)),
                               **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tf32_mirror_keeps_the_f32_gate(interpret, shape, causal):
    """The TF32 kernel's design on the CPU (``attention_tf32_ref``) against
    the reference's Pallas kernel in interpret mode, f32, at the reference's
    own 2e-5: splitting every operand of both products into TF32 hi and lo
    (P included) keeps f32's gate, before any card run."""
    b, hq, hkv, sq, skv, d = shape
    assert d % kern.TF32_HEAD_DIM_STEP == 0
    rng = np.random.default_rng(SEED + 1)
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal(s, np.float32), "float32")
                                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    assert kern.flash_path(q, k, v) == "tf32"
    o = attention_tf32_ref(q, k, v, causal=causal)
    assert o.dtype == torch.float32 and o.shape == q.shape
    np.testing.assert_allclose(_np(o), _np(j_flash_sdpa(jq, jk, jv, causal=causal)),
                               **_tol("float32"))


def test_flash_path_rule_for_f32():
    """f32 with a head dim that is a multiple of 8 takes the TF32 kernel when
    its 16-byte copies can take q, k and v; other head dims, a base off 16
    bytes and rows whose stride is no multiple of 16 bytes take the
    CUDA-core kernel; the TF32 block's ring fits what a block may opt in to
    at every padded head dim, each thread's copies whole."""
    for d in (8, 16, 32, 64, 112, 128):
        q = torch.zeros(2, 4, 64, d)
        assert kern.flash_path(q, q, q) == "tf32"
        # (B, S, H, D) viewed as (B, H, S, D), as attn_apply passes them
        t = torch.zeros(2, 64, 4, d).transpose(1, 2)
        assert kern.flash_path(t, t, t) == "tf32"
    for d in (4, 12, 36, 100):
        q = torch.zeros(2, 4, 64, d)
        assert kern.flash_path(q, q, q) == "cuda_core"
    q = torch.zeros(2, 4, 64, 64)
    off = torch.zeros(2 * 4 * 64 * 64 + 1)[1:].view(2, 4, 64, 64)
    assert kern.flash_path(off, q, q) == kern.flash_path(q, off, q) == "cuda_core"
    padded = torch.zeros(2, 4, 64, 66)[..., :64]  # rows 264 bytes apart
    assert kern.flash_path(q, padded, q) == "cuda_core"
    assert kern.flash_path(q.double(), q.double(), q.double()) == "cuda_core"
    assert [kern.tf32_head_dim(d) for d in (8, 32, 40, 64, 72, 128)] == [32, 32, 64, 64, 128, 128]
    keys, stages, warps = kern.TF32_PLAN
    assert kern.TF32_ROWS == 16 * warps and keys % 8 == 0 and stages >= 2
    for dp in (32, 64, 128):
        assert kern.tf32_smem_bytes(dp) <= 232448
        assert keys * dp // 4 % (32 * warps) == 0
    assert set(kern.flash_attention.launches_by_path) == {"tensor_core", "tf32", "cuda_core"}


def test_flash_sdpa_takes_strided_heads():
    """attn_apply hands the kernel (B, S, H, D) tensors viewed as (B, H, S,
    D); the plain path gives the same result on the view as on a copy."""
    rng = np.random.default_rng(SEED)
    q = torch.from_numpy(rng.standard_normal((2, 128, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 128, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 128, 2, 32), np.float32))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    torch.testing.assert_close(flash_sdpa(*views), flash_sdpa(*(t.contiguous() for t in views)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("q_shape,k_shape,what", [
    ((1, 4, 64, 130), (1, 2, 64, 130), "head_dim 130"),
    ((1, 4, 64, 6), (1, 2, 64, 6), "head_dim 6"),
    ((1, 4, 64, 32), (1, 3, 64, 32), "Hq % Hkv"),
    ((1, 4, 64, 32), (2, 2, 64, 32), "batch"),
])
def test_flash_attention_refuses_shapes_it_cannot_take(q_shape, k_shape, what):
    """The CUDA wrapper raises before it builds or launches anything."""
    q, k = torch.zeros(q_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError):
        kern.flash_attention(q, k, k.clone())
    assert kern.flash_attention.launches == 0, what


def _attn_case(acfg_kw, d_model=64, seed=SEED):
    """(jax cfg, port cfg, jax params, port params): weights drawn by numpy,
    biases nonzero when the config has them."""
    jcfg, cfg = JAttentionConfig(**acfg_kw), AttentionConfig(**acfg_kw)
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d_model, cfg.q_dim), "wk": (d_model, cfg.kv_dim),
              "wv": (d_model, cfg.kv_dim), "wo": (cfg.q_dim, d_model)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    tree = {k: (d_model**-0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


ATTN_CASES = {
    "causal": dict(n_heads=4, n_kv_heads=2, head_dim=16),
    "qkv_bias": dict(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
    "window": dict(n_heads=4, n_kv_heads=1, head_dim=16, window=5),
    "bidirectional": dict(n_heads=4, n_kv_heads=4, head_dim=16, causal=False),
    "rope_theta": dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=5e6),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_apply_without_cache(case, dtype):
    jcfg, cfg, jp, p = _attn_case(ATTN_CASES[case])
    rng = np.random.default_rng(SEED + 1)
    jx, x = _pair(rng.standard_normal((2, 24, 64), np.float32), dtype)
    out_ref, _ = j_attn_apply(jp, jx, jcfg, jnp.arange(24))
    out, cache = attn_apply(p, x, cfg, torch.arange(24))
    assert cache is None and out.dtype == x.dtype
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(out_ref), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "qkv_bias", "window"])
def test_attn_apply_with_cache(case, dtype):
    """A prompt of 8 at position 0, then 3 tokens at cache_pos 8 and one at
    11, into a cache of 16: outputs and the caches match the reference's."""
    jcfg, cfg, jp, p = _attn_case(ATTN_CASES[case])
    rng = np.random.default_rng(SEED + 2)
    jdt, dt = DTYPES[dtype]
    jcache, cache = j_make_cache(jcfg, 2, 16, jdt), make_cache(cfg, 2, 16, dt)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-5)
    for pos0, s in ((0, 8), (8, 3), (11, 1)):
        jx, x = _pair(rng.standard_normal((2, s, 64), np.float32), dtype)
        out_ref, jcache = j_attn_apply(jp, jx, jcfg, pos0 + jnp.arange(s), cache=jcache,
                                       cache_pos=jnp.asarray(pos0, jnp.int32))
        out, cache = attn_apply(p, x, cfg, pos0 + torch.arange(s), cache=cache, cache_pos=pos0)
        np.testing.assert_allclose(_np(out), _np(out_ref), **tol, err_msg=f"pos0 {pos0}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **tol)


@pytest.mark.parametrize("seq", [128, 96])
def test_attn_apply_flash_switch(interpret, seq):
    """``impl="flash"`` takes the kernel path at S = 128 in both packages and
    the einsum path at S = 96 (not a multiple of 128), as
    ``tests/test_kernels.py::test_flash_impl_integrates_with_attention_op``
    pins for the reference."""
    jcfg, cfg, jp, p = _attn_case(dict(n_heads=4, n_kv_heads=2, head_dim=32))
    rng = np.random.default_rng(SEED + 3)
    x = rng.standard_normal((2, seq, 64)).astype(np.float32)
    pos = np.arange(seq)
    out_flash, _ = attn_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos), impl="flash")
    out_xla, _ = attn_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    ref_flash, _ = j_attn_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), impl="flash")
    np.testing.assert_allclose(_np(out_flash), _np(ref_flash), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(out_flash), _np(out_xla), rtol=2e-4, atol=2e-4)
    if seq % 128:
        torch.testing.assert_close(out_flash, out_xla, rtol=0, atol=0)


def test_attn_apply_refuses_sequence_sharding_and_overlong_writes():
    """``seq_shard=True`` with no mesh bound is the unsharded call (it
    raised before the model-sharded meshes; ``tests/test_torch_dist_model.py``
    runs it on a mesh); a cache write past the cache's end raises."""
    _, cfg, _, p = _attn_case(ATTN_CASES["causal"])
    x = torch.randn(1, 4, 64, generator=torch.Generator().manual_seed(SEED))
    sharded, _ = attn_apply(p, x, cfg, torch.arange(4), seq_shard=True)
    assert torch.equal(sharded, attn_apply(p, x, cfg, torch.arange(4))[0])
    with pytest.raises(ValueError, match="past its length"):
        attn_apply(p, x, cfg, torch.arange(4), cache=make_cache(cfg, 1, 6, torch.float32),
                   cache_pos=3)


def test_norms_and_rope_match_the_reference():
    rng = np.random.default_rng(SEED + 4)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32) * 3.0
    g, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    tx, tg, tb = map(torch.from_numpy, (x, g, b))
    np.testing.assert_allclose(_np(rmsnorm(tx, tg)), _np(j_rmsnorm(x, g)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(layernorm(tx, tg, tb)), _np(j_layernorm(x, g, b)),
                               rtol=0, atol=1e-6)
    for theta in (1e4, 5e6):
        pos = np.arange(3, 43)
        np.testing.assert_allclose(_np(apply_rope(tx, torch.from_numpy(pos), theta)),
                                   _np(j_apply_rope(x, pos, theta)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_ffns_match_the_reference(kind):
    rng = np.random.default_rng(SEED + 5)
    d, dff = 64, 160
    shapes = ({"w_gate": (d, dff), "w_up": (d, dff), "w_down": (dff, d)} if kind == "swiglu" else
              {"w_in": (d, dff), "b_in": (dff,), "w_out": (dff, d), "b_out": (d,)})
    tree = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    out = ffn_apply({k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(x), kind)
    ref = j_ffn_apply({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), kind)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-6)

"""yi-6b served from the port against the JAX reference on the CPU, at the
reference's ``REDUCED`` width (2 layers, d_model 64, 4/2 heads, vocab 256):
``Model.prefill``, ``decode_step`` and ``ServeEngine.generate``, in both
stack forms (reversible and standard), the parameter bridge both ways, and
the configuration registry.  The parameters are the reference's ``init``
with the norms perturbed, carried across by ``bridge.params_from_numpy``.

Tolerances, on each logits tensor as ``max |a - b| <= tol * max |b|``:
1e-5 in f32 (``dtype="float32"``: measured ~8e-7, products of width 64-160
summed in another order), 3e-2 at the default bf16 activations (measured up
to 1.5e-2: the logits are a bf16 product, so a few bf16 ulps of the largest
logit).  Greedy tokens are equal in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.yi_6b import CONFIG as J_CONFIG
from repro.configs.yi_6b import REDUCED as J_REDUCED
from repro.models.lm import Model as JModel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.config import get_arch, list_archs
from repro_torch.configs.yi_6b import CONFIG, REDUCED
from repro_torch.models import Model, build_model
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(4)
SEED = 20261017
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
PROMPT, MAX_LEN = 12, 20


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(dtype="float32", reversible=True, seed=SEED):
    """(jax model, jax params, port model, numpy tree, prompt tokens)."""
    jm = JModel(J_REDUCED.replace(dtype=dtype, reversible=reversible))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed % 997)))
    rng = np.random.default_rng(seed)
    tree["final_norm"] = tree["final_norm"] + 0.1 * rng.standard_normal(64).astype(np.float32)
    for unit in ("attn", "ffn"):
        norm = tree["blocks"][unit]["norm"]
        tree["blocks"][unit]["norm"] = norm + 0.1 * rng.standard_normal(norm.shape).astype(np.float32)
    m = Model(REDUCED.replace(dtype=dtype, reversible=reversible), device="cpu")
    params_from_numpy(m, tree)
    tokens = rng.integers(0, REDUCED.vocab_size, (2, PROMPT)).astype(np.int32)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), m, tree, tokens


CASES = [("float32", True), ("float32", False), ("bfloat16", True), ("bfloat16", False)]


@pytest.mark.parametrize("dtype,reversible", CASES)
def test_prefill_and_decode_match_the_reference(dtype, reversible):
    """Prefill, then three decode steps fed the reference's greedy tokens:
    logits and caches agree at every step."""
    jm, jp, m, _, tokens = _pair(dtype, reversible)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.make_caches(2, MAX_LEN))
    log, c = m.prefill({"tokens": torch.from_numpy(tokens)}, m.make_caches(2, MAX_LEN))
    assert log.dtype == torch.float32 and log.shape == (2, REDUCED.vocab_size)
    assert _rel(log, jlog) <= TOL[dtype]
    for i in range(3):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(PROMPT + i, jnp.int32))
        log, c = m.decode_step(torch.from_numpy(nxt), c, PROMPT + i)
        assert _rel(log, jlog) <= TOL[dtype], f"decode step {i}"
    for key in ("k", "v"):
        assert _rel(c["blocks"]["attn"][key], jc["blocks"]["attn"][key]) <= TOL[dtype]


@pytest.mark.parametrize("dtype,reversible", CASES)
def test_generate_matches_the_reference(dtype, reversible):
    jm, jp, m, _, tokens = _pair(dtype, reversible, seed=SEED + 1)
    jtok, jlog = JServeEngine(jm, jp, MAX_LEN).generate({"tokens": jnp.asarray(tokens)}, 6)
    tok, log = ServeEngine(m, MAX_LEN, device="cpu").generate({"tokens": tokens}, 6)
    assert tok.dtype == torch.int32 and tok.shape == (2, 6)
    assert _rel(log, jlog) <= TOL[dtype]
    if dtype == "float32":
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_generate_stops_at_eos_as_the_reference():
    """With ``eos_id`` the first greedy token of each sequence, every
    sequence is done after one step: both packages return one column."""
    jm, jp, m, _, tokens = _pair(seed=SEED + 2)
    first, _ = ServeEngine(m, MAX_LEN, device="cpu").generate({"tokens": tokens}, 1)
    eos = int(first[0, 0])
    jtok, _ = JServeEngine(jm, jp, MAX_LEN).generate({"tokens": jnp.asarray(tokens)}, 5, eos_id=eos)
    tok, _ = ServeEngine(m, MAX_LEN, device="cpu").generate({"tokens": tokens}, 5, eos_id=eos)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_decode_with_cache_matches_a_fresh_prefill():
    """The logits after decoding token t at position P equal a fresh
    prefill over the prompt extended by t (f32)."""
    _, _, m, _, tokens = _pair(seed=SEED + 3)
    t = torch.from_numpy(tokens)
    log, caches = m.prefill({"tokens": t}, m.make_caches(2, MAX_LEN))
    nxt = log.argmax(-1, keepdim=True)
    step, _ = m.decode_step(nxt, caches, PROMPT)
    fresh, _ = m.prefill({"tokens": torch.cat([t, nxt.int()], 1)}, m.make_caches(2, MAX_LEN))
    assert _rel(step, fresh) <= TOL["float32"]


def test_temperature_sampling_follows_the_generator():
    _, _, m, _, tokens = _pair(seed=SEED + 4)
    engine = ServeEngine(m, MAX_LEN, temperature=0.8, device="cpu")
    runs = [engine.generate({"tokens": tokens}, 6, generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < REDUCED.vocab_size


def test_bridge_round_trip_is_exact():
    _, _, m, tree, _ = _pair()
    back = tree_to_numpy(m, like=tree)
    flat, flat_back = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
    assert all(np.array_equal(a, b) for a, b in zip(flat, flat_back))
    assert m.blocks.attn.attn.wq.shape == (REDUCED.n_layers, 64, 64)


def test_configs_and_registry_match_the_reference():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(J_CONFIG)
    assert dataclasses.asdict(REDUCED) == dataclasses.asdict(J_REDUCED)
    assert CONFIG.param_count() == J_CONFIG.param_count()
    assert list_archs() == ["command-r-plus-104b", "glm4-9b", "granite-34b",
                            "granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
                            "llava-next-34b", "rwkv6-7b", "whisper-small", "yi-6b", "zamba2-7b"]
    assert get_arch("yi-6b").reduced == REDUCED
    llava, _ = build_model(get_arch("llava-next-34b").reduced, device="cpu")
    assert llava.frontend.proj.shape == (1024, 64)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="no layout"):
        build_model(REDUCED.replace(family="no-such-family"), device="cpu")
    model, cfg = build_model("yi-6b", device="cpu", n_layers=1, d_model=32, d_ff=64,
                             vocab_size=64, attention=REDUCED.attention)
    assert cfg.n_layers == 1 and model.embed.shape == (64, 32)

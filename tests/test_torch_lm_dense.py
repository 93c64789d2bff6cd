"""The rest of the dense family (glm4-9b: qkv bias, kv 2; granite-34b: MQA,
the GELU MLP; command-r-plus-104b: tied embeddings, the head ``embed.T``)
and yi-6b, from the port against the JAX reference on the CPU at the
reference's ``REDUCED`` widths: serving (``prefill``, ``decode_step``,
``ServeEngine.generate``) and ``train_loss`` with every gradient leaf.  The
parameters are the reference's ``init`` with its constant leaves perturbed
(``torch_lm_parity.perturbed``), carried across by
``bridge.params_from_numpy``.

Tolerances, as ``max |a - b| <= tol * max |b|``:

* serving, on each logits tensor: 1e-5 in f32 (measured up to ~1e-6) and
  3e-2 at the default bf16 activations, as ``test_torch_lm.py`` holds yi-6b;
  greedy tokens equal in f32;
* training, in f32: the loss at 1e-5 (measured 0 to 7.4e-8), each gradient
  leaf at 1e-4 of its largest entry (measured, against the reference in the
  same mode: ``invertible`` up to 1.3e-5, granite-34b's ``wk``;
  ``autodiff`` up to 2.5e-6).  ``coupled`` and ``remat`` are held to the
  port's own ``autodiff`` at the same gates (measured up to 8.6e-6 and 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import get_arch
from repro_torch.configs import UNPORTED_ARCHS
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from torch_lm_parity import (configs, leaf_errors, make_pair, port_loss_grad, ref_loss_grad,
                             token_batch)

torch.set_num_threads(4)
DENSE = ("glm4-9b", "granite-34b", "command-r-plus-104b")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LOSS, TOL_LEAF = 1e-5, 1e-4
PROMPT, MAX_LEN = 12, 20
SOURCES = {"glm4-9b": "hf:THUDM/glm-4-9b", "granite-34b": "arXiv:2405.04324; hf",
           "command-r-plus-104b": "hf:CohereForAI/c4ai-command-r-v01"}


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _prompt(vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (2, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype,reversible", [("float32", True), ("float32", False),
                                              ("bfloat16", True)])
def test_prefill_and_decode_match_the_reference(arch, dtype, reversible):
    """Prefill, then three decode steps fed the reference's greedy tokens:
    logits and the KV caches agree at every step."""
    jm, jp, m, _ = make_pair(arch, dtype=dtype, reversible=reversible)
    tokens = _prompt(m.cfg.vocab_size, 1)
    prefill, decode_step = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jlog, jc = prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.make_caches(2, MAX_LEN))
    log, c = m.prefill({"tokens": torch.from_numpy(tokens)}, m.make_caches(2, MAX_LEN))
    assert log.dtype == torch.float32 and log.shape == (2, m.cfg.vocab_size)
    assert _rel(log, jlog) <= TOL[dtype]
    for i in range(3):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jc = decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(PROMPT + i, jnp.int32))
        log, c = m.decode_step(torch.from_numpy(nxt), c, PROMPT + i)
        assert _rel(log, jlog) <= TOL[dtype], f"decode step {i}"
    for key in ("k", "v"):
        assert _rel(c["blocks"]["attn"][key], jc["blocks"]["attn"][key]) <= TOL[dtype]


@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_the_reference(arch):
    jm, jp, m, _ = make_pair(arch, dtype="float32")
    tokens = _prompt(m.cfg.vocab_size, 2)
    jtok, jlog = JServeEngine(jm, jp, MAX_LEN).generate({"tokens": jnp.asarray(tokens)}, 6)
    tok, log = ServeEngine(m, MAX_LEN, device="cpu").generate({"tokens": tokens}, 6)
    assert _rel(log, jlog) <= TOL["float32"]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ("yi-6b",) + DENSE)
@pytest.mark.parametrize("mode", ["invertible", "autodiff"])
def test_train_loss_and_gradients_match_the_reference(arch, mode):
    jm, jp, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16)
    ref_loss, ref_grads = ref_loss_grad(jm, jp, batch, mode)
    loss, grads = port_loss_grad(m, batch, mode)
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    errs = leaf_errors(m, tree, grads, ref_grads)
    assert max(errs.values()) <= TOL_LEAF, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert all(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("arch", ("yi-6b",) + DENSE)
def test_coupled_and_remat_match_the_ports_autodiff(arch):
    _, _, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16, seed=3)
    ad_loss, ad_grads = port_loss_grad(m, batch, "autodiff")
    for mode in ("coupled", "remat"):
        loss, grads = port_loss_grad(m, batch, mode)
        assert abs(loss - ad_loss) <= TOL_LOSS * abs(ad_loss), mode
        errs = leaf_errors(m, tree, grads, ad_grads)
        assert max(errs.values()) <= TOL_LEAF, (mode, max(errs.items(), key=lambda kv: kv[1]))


def test_fused_coupled_backward_equals_autodiff():
    """The port of the reference's ``tests/test_system.py``
    ``test_fused_coupled_backward_equals_autodiff`` at its own bound (5e-4):
    glm4-9b ``REDUCED`` in f32, a ``SyntheticTokens`` batch of 2 x 16."""
    model, cfg = build_model(get_arch("glm4-9b").reduced, device="cpu", dtype="float32",
                             residual_dtype="float32")
    batch = SyntheticTokens(cfg.vocab_size, 16, 2, seed=0).batch_at(0)
    params = list(model.parameters())
    g_c = torch.autograd.grad(model.train_loss(batch, grad_mode="coupled")[0], params)
    g_a = torch.autograd.grad(model.train_loss(batch, grad_mode="autodiff")[0], params)
    assert max(float((a - b).abs().max()) for a, b in zip(g_c, g_a)) < 5e-4


def test_tied_head_sums_both_gradient_paths():
    """command-r-plus-104b has no ``lm_head``: its head is ``embed.T``, and
    the embedding's gradient is the lookup's plus the head's, as the
    reference's."""
    jm, jp, m, tree = make_pair("command-r-plus-104b", dtype="float32")
    assert "lm_head" not in dict(m.named_parameters()) and m.cfg.tie_embeddings
    batch = token_batch(m.cfg.vocab_size, 2, 16, seed=5)
    _, ref_grads = ref_loss_grad(jm, jp, batch, "invertible")
    _, grads = port_loss_grad(m, batch, "invertible")
    err = np.abs(grads["embed"].numpy() - ref_grads["embed"]).max()
    assert err <= TOL_LEAF * np.abs(ref_grads["embed"]).max()
    # rows of tokens never looked up still get the head's gradient
    unseen = np.setdiff1d(np.arange(m.cfg.vocab_size), batch["tokens"])
    assert float(grads["embed"][torch.from_numpy(unseen)].abs().max()) > 0


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_registry_match_the_reference(arch):
    jmod, pmod = configs(arch)
    assert dataclasses.asdict(pmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(pmod.REDUCED) == dataclasses.asdict(jmod.REDUCED)
    assert pmod.CONFIG.param_count() == jmod.CONFIG.param_count()
    spec = get_arch(arch)
    assert spec.config == pmod.CONFIG and spec.reduced == pmod.REDUCED
    assert spec.source == SOURCES[arch] and arch not in UNPORTED_ARCHS
    model, _ = build_model(spec.reduced, device="cpu")
    attn = model.blocks.attn.attn
    assert ("bq" in attn) == pmod.CONFIG.attention.qkv_bias
    assert attn.wk.shape[-1] == pmod.REDUCED.attention.kv_dim
    assert ("w_in" in model.blocks.ffn.ffn) == (pmod.CONFIG.ffn_kind == "gelu_mlp")

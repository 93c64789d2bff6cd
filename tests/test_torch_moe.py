"""The MoE family from the port against the JAX reference on the CPU:
``nn/moe.py::moe_apply`` alone (routing, capacity dispatch, the
load-balance aux, the shared expert, dropped tokens, its gradient), then
granite-moe-1b-a400m (interleave 1: attention + MoE, 4 experts top-2 at
``REDUCED``) and llama4-maverick-400b-a17b (interleave 2: attention + FFN,
attention + MoE; 8 experts top-1 and a shared expert at ``REDUCED``)
served and trained.  Parameters are the reference's ``init`` (the models'
constant leaves perturbed), carried across by ``bridge.params_from_numpy``.

Tolerances, as ``max |a - b| <= tol * max |b|`` unless stated:

* ``moe_apply`` in f32: expert indices and the keep mask equal; outputs
  and aux within 1e-5 (measured up to ~3e-7); the gradients of x and of
  every parameter within 1e-4 of the largest entry (measured up to 3.8e-5,
  llama4's router: a sum over every token's probabilities in another
  order);
* serving: 1e-5 in f32 and 3e-2 in bf16 on the logits, greedy tokens equal
  in f32, as ``test_torch_lm.py``;
* training in f32: the loss and the aux metric at 1e-5 (measured 0 to
  7e-8), each gradient leaf at 1e-4 of its largest entry (measured up to
  3.8e-5 under ``invertible``, llama4's ``attn0.attn.wk``, and 1.9e-6 under
  ``autodiff``); ``coupled`` and ``remat`` against the port's own
  ``autodiff``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.config import get_arch as j_get_arch
from repro.nn.moe import _capacity as j_capacity
from repro.nn.moe import moe_apply as j_moe_apply
from repro.nn.moe import moe_init as j_moe_init
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import MoEConfig, get_arch
from repro_torch.models import build_model
from repro_torch.nn.moe import (_capacity, dispatch_slots, moe_apply, moe_init, pinned_routes,
                                route)
from repro_torch.serve.engine import ServeEngine
from torch_lm_parity import (SEED, configs, leaf_errors, make_pair, port_loss_grad,
                             ref_loss_grad, token_batch)

torch.set_num_threads(4)
MOE = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_MOE, TOL_LOSS, TOL_LEAF = 1e-5, 1e-5, 1e-4
PROMPT, MAX_LEN = 12, 20
# (d_model, MoEConfig kwargs, ffn kind, batch, seq): granite-moe's and
# llama4's REDUCED experts, the GELU MLP, and a capacity factor that drops
MOE_CASES = {
    "granite": (64, dict(n_experts=4, top_k=2, d_ff_expert=64), "swiglu", 2, 16),
    "llama4": (64, dict(n_experts=8, top_k=1, d_ff_expert=128, interleave=2,
                        shared_expert=True), "swiglu", 2, 16),
    "gelu": (32, dict(n_experts=4, top_k=2, d_ff_expert=48), "gelu_mlp", 2, 24),
    "drops": (32, dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=0.25), "swiglu",
              3, 64),
}


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def _ref_routing(params, x, cfg):
    """The reference's routing and keep mask (``nn/moe.py:73-88``)."""
    b, s, _ = x.shape
    cap = j_capacity(s, cfg)
    logits = (x @ params["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = expert_idx.reshape(b, s * cfg.top_k)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32), axis=1) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    return expert_idx, pos_in_e < cap


def _moe_pair(case: str, seed=SEED):
    d, kw, kind, b, s = MOE_CASES[case]
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    jp = j_moe_init(jax.random.PRNGKey(seed % 991), d, jcfg, kind)
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jcfg, cfg, kind, jp, _to_torch(jp), x


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_apply_matches_the_reference(case):
    jcfg, cfg, kind, jp, p, x = _moe_pair(case)
    assert _capacity(x.shape[1], cfg) == j_capacity(x.shape[1], jcfg)
    j_idx, j_keep = jax.jit(_ref_routing, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    _, _, idx = route(p, torch.from_numpy(x), cfg)
    slot, keep = dispatch_slots(idx, cfg, _capacity(x.shape[1], cfg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep).reshape(keep.shape))
    if case == "drops":
        assert 0.2 < float((~keep).float().mean()) < 0.9, "the case must drop tokens"
        assert int((slot == cfg.n_experts * _capacity(x.shape[1], cfg)).sum()) == int((~keep).sum())
    jy, jaux = jax.jit(j_moe_apply, static_argnums=(2, 3))(jp, jnp.asarray(x), jcfg, kind)
    y, aux = moe_apply(p, torch.from_numpy(x), cfg, kind)
    assert y.shape == x.shape and aux.shape == (x.shape[0],)
    assert _rel(y, jy) <= TOL_MOE and _rel(aux, jaux) <= TOL_MOE


def test_moe_apply_with_expert_biases_matches_the_reference():
    """The GELU experts' (E, F) and (E, D) biases (zero at init, drawn here)
    broadcast over each expert's own rows, as the reference's do."""
    jcfg, cfg, kind, jp, _, x = _moe_pair("gelu", seed=SEED + 3)
    rng = np.random.default_rng(SEED + 4)
    experts = dict(jp["experts"])
    for k in ("b_in", "b_out"):
        experts[k] = jnp.asarray(rng.standard_normal(experts[k].shape).astype(np.float32))
    jp = {**jp, "experts": experts}
    jy, jaux = jax.jit(j_moe_apply, static_argnums=(2, 3))(jp, jnp.asarray(x), jcfg, kind)
    y, aux = moe_apply(_to_torch(jp), torch.from_numpy(x), cfg, kind)
    assert _rel(y, jy) <= TOL_MOE and _rel(aux, jaux) <= TOL_MOE


@pytest.mark.parametrize("case", ["granite", "llama4", "drops"])
def test_moe_apply_gradients_match_the_reference(case):
    """The VJP of ``(y, aux)`` against random cotangents: x's and every
    parameter's gradient (routing is piecewise constant, as in JAX)."""
    jcfg, cfg, kind, jp, p, x = _moe_pair(case, seed=SEED + 1)
    rng = np.random.default_rng(SEED + 2)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gaux = rng.standard_normal(x.shape[0]).astype(np.float32)
    def j_vjp(pp, xx, g, ga):
        return jax.vjp(lambda p_, x_: j_moe_apply(p_, x_, jcfg, kind), pp, xx)[1]((g, ga))

    jgp, jgx = jax.jit(j_vjp)(jp, jnp.asarray(x), jnp.asarray(gy), jnp.asarray(gaux))
    leaves = [v.requires_grad_() for v in jax.tree_util.tree_leaves(p)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe_apply(p, xt, cfg, kind)
    grads = torch.autograd.grad([y, aux], [xt, *leaves],
                                [torch.from_numpy(gy), torch.from_numpy(gaux)])
    assert _rel(grads[0], jgx) <= TOL_LEAF
    for g, jg in zip(grads[1:], jax.tree_util.tree_leaves(jgp)):
        assert _rel(g, jg) <= TOL_LEAF


def test_moe_apply_is_bitwise_repeatable_and_keeps_dropped_tokens_out():
    """Two calls give the same bits; a dropped token's slot is the spare one,
    so it never overwrites a kept token (a token dropped in every expert it
    chose takes only the shared path, here none: its output is 0)."""
    _, cfg, kind, _, p, x = _moe_pair("drops")
    xt = torch.from_numpy(x)
    y1, a1 = moe_apply(p, xt, cfg, kind)
    y2, a2 = moe_apply(p, xt, cfg, kind)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    _, _, idx = route(p, xt, cfg)
    _, keep = dispatch_slots(idx, cfg, _capacity(x.shape[1], cfg))
    all_dropped = ~keep.reshape(idx.shape).any(-1)
    assert bool(all_dropped.any())
    assert float(y1[all_dropped].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["granite", "llama4"])
def test_pinned_routes_replay_a_routing(case):
    """``pinned_routes`` with the choices a pass made gives that pass's bits
    (output, aux and gradients); with other choices the gate values are the
    probabilities at them, and the pin ends with its block."""
    _, cfg, kind, _, p, x = _moe_pair(case, seed=SEED + 5)
    leaves = [v.requires_grad_() for v in jax.tree_util.tree_leaves(p)]

    def run(xt):
        y, aux = moe_apply(p, xt, cfg, kind)
        return [y, aux, *torch.autograd.grad(y.square().sum() + aux.sum(), leaves)]

    xt = torch.from_numpy(x)
    _, gates, idx = route(p, xt, cfg)
    free = run(xt)
    with pinned_routes([idx]):
        pinned = run(xt)
    assert all(torch.equal(a, b) for a, b in zip(free, pinned))
    other = torch.roll(idx, 1, dims=-1) if cfg.top_k > 1 else (idx + 1) % cfg.n_experts
    with pinned_routes([other]):
        probs, g_other, i_other = route(p, xt, cfg)
    assert torch.equal(i_other, other)
    want = probs.gather(-1, other)
    assert torch.allclose(g_other, want / (want.sum(-1, keepdim=True) + 1e-9), rtol=0, atol=0)
    assert torch.equal(route(p, xt, cfg)[2], idx)


def test_moe_init_shapes():
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, shared_expert=True)
    p = moe_init(torch.Generator().manual_seed(0), 8, cfg, "swiglu")
    assert p["router"].shape == (8, 4) and p["experts"]["w_gate"].shape == (4, 8, 16)
    assert p["experts"]["w_down"].shape == (4, 16, 8) and p["shared"]["w_up"].shape == (8, 16)
    assert not torch.equal(p["experts"]["w_gate"][0], p["experts"]["w_gate"][1])


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype,reversible", [("float32", True), ("float32", False),
                                              ("bfloat16", True)])
def test_prefill_and_decode_match_the_reference(arch, dtype, reversible):
    jm, jp, m, _ = make_pair(arch, dtype=dtype, reversible=reversible)
    tokens = np.random.default_rng(1).integers(0, m.cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    prefill, decode_step = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jlog, jc = prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.make_caches(2, MAX_LEN))
    log, c = m.prefill({"tokens": torch.from_numpy(tokens)}, m.make_caches(2, MAX_LEN))
    assert _rel(log, jlog) <= TOL[dtype]
    for i in range(3):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jc = decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(PROMPT + i, jnp.int32))
        log, c = m.decode_step(torch.from_numpy(nxt), c, PROMPT + i)
        assert _rel(log, jlog) <= TOL[dtype], f"decode step {i}"


@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_the_reference(arch):
    jm, jp, m, _ = make_pair(arch, dtype="float32")
    tokens = np.random.default_rng(2).integers(0, m.cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jtok, jlog = JServeEngine(jm, jp, MAX_LEN).generate({"tokens": jnp.asarray(tokens)}, 6)
    tok, log = ServeEngine(m, MAX_LEN, device="cpu").generate({"tokens": tokens}, 6)
    assert _rel(log, jlog) <= TOL["float32"]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mode", ["invertible", "autodiff"])
def test_train_loss_and_gradients_match_the_reference(arch, mode):
    """Loss, the summed aux metric and every gradient leaf; the aux of each
    MoE layer lands once (llama4's MoE unit reads x1 and writes x2)."""
    jm, jp, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16)
    ref_loss, ref_grads = ref_loss_grad(jm, jp, batch, mode)
    loss, grads = port_loss_grad(m, batch, mode)
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    _, j_metrics = jm.train_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, grad_mode=mode)
    with torch.no_grad():
        _, metrics = m.train_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                  grad_mode=mode)
    j_aux = float(j_metrics["aux"])
    assert abs(float(metrics["aux"]) - j_aux) <= TOL_LOSS * j_aux
    errs = leaf_errors(m, tree, grads, ref_grads)
    assert max(errs.values()) <= TOL_LEAF, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    router = [k for k in grads if k.endswith("moe.router")]
    assert router and all(float(grads[k].abs().max()) > 0 for k in router)


@pytest.mark.parametrize("arch", MOE)
def test_coupled_and_remat_match_the_ports_autodiff(arch):
    _, _, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16, seed=3)
    ad_loss, ad_grads = port_loss_grad(m, batch, "autodiff")
    for mode in ("coupled", "remat"):
        loss, grads = port_loss_grad(m, batch, mode)
        assert abs(loss - ad_loss) <= TOL_LOSS * abs(ad_loss), mode
        errs = leaf_errors(m, tree, grads, ad_grads)
        assert max(errs.values()) <= TOL_LEAF, (mode, max(errs.items(), key=lambda kv: kv[1]))


@pytest.mark.parametrize("arch", MOE)
def test_configs_layout_and_registry_match_the_reference(arch):
    jmod, pmod = configs(arch)
    assert dataclasses.asdict(pmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(pmod.REDUCED) == dataclasses.asdict(jmod.REDUCED)
    assert pmod.CONFIG.param_count() == jmod.CONFIG.param_count()
    assert pmod.CONFIG.param_count(active_only=True) == jmod.CONFIG.param_count(active_only=True)
    spec = get_arch(arch)
    assert spec.config == pmod.CONFIG and spec.reduced == pmod.REDUCED
    assert spec.source == j_get_arch(arch).source
    model, cfg = build_model(spec.reduced, device="cpu")
    names = [u.name for u in model.layout.main.units]
    if cfg.moe.interleave == 1:
        assert names == ["attn", "moe"] and model.layout.main.n_super == cfg.n_layers
    else:
        assert names == ["attn0", "ffn0", "attn1", "moe1"]
        assert model.layout.main.n_super == cfg.n_layers // 2
        assert model.blocks.moe1.moe.shared.w_gate.shape == (2, 64, 128)
    moe = dict(model.named_parameters())
    key = "blocks.moe.moe.experts.w_gate" if cfg.moe.interleave == 1 else \
        "blocks.moe1.moe.experts.w_gate"
    assert moe[key].shape == (model.layout.main.n_super, cfg.moe.n_experts, cfg.d_model,
                              cfg.moe.d_ff_expert)

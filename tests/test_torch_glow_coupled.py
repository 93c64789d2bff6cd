"""Unrolled GLOW (``build_glow``, ``GLOW_COUPLED``) in the port against the
JAX reference: the affine coupling's logdet, ``log_prob``, ``inverse``, the
``kernel_inverse`` serving twin, and the gradient in all three engines.

``GLOW_COUPLED``'s structure at a small size (2 scales x 2 steps, hidden 8)
on (2, 8, 8, 3) and (2, 12, 12, 3) images (3x3 at the last scale: a ragged
M).  Parameters come from the reference's ``init``, every float leaf
perturbed with fan-in-scaled numpy noise (``init`` zeroes actnorm and each
conditioner's last conv, which would make every coupling the identity), and
the same tree goes to both sides through ``bridge.params_from_numpy``.  The
reference runs its default CPU path (the kernels' jnp oracles).

Tolerances, each with its reason:

* ``log_prob``: 1e-5 relative; it scales with the dimension D;
* latents, inverses, samples: 1e-4 absolute per element in f32, the
  reference's own kernel bound;
* the loss: 1e-6 absolute, an f32 mean of order 1; every gradient leaf:
  1e-4 absolute, the reference's grad-parity bound;
* the coupling's logdet against a brute-force Jacobian: 1e-4 absolute, the
  f32 log-determinant of a 16x16 or 20x20 matrix;
* a layer's coupled hook against the generic invert-then-VJP step: 1e-5
  absolute, the same arithmetic in another order;
* ``W W^-1 - I``: 1e-7, a few roundings of ``W^-1``'s f32 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.core import build_glow as j_build_glow
from repro.core.autodiff import value_and_grad_nll as j_value_and_grad_nll
from repro.serve.engine import FlowServeEngine as JFlowServeEngine
from repro_torch.bridge import params_from_numpy, tree_paths, tree_to_numpy
from repro_torch.configs.flows import GLOW_COUPLED, GLOW_FIG1, GLOW_PAPER, GLOW_SCANNED, build_flow
from repro_torch.core import (
    ActNorm,
    AffineCoupling,
    Conv1x1,
    InvertibleChain,
    build_glow,
    derive_key,
    share_parameters,
    std_normal_sample,
    value_and_grad_nll,
)
from repro_torch.core import coupling as coupling_mod
from repro_torch.core.autodiff import chain_backward
from repro_torch.core.conv1x1 import conv1x1_init, lu_weight, lu_weight_inv, lu_weight_inv_solves
from repro_torch.nn.nets import CouplingCNN
from repro_torch.serve.engine import FlowServeEngine
from torch_parity import SEED, as_np, close, grad_errors, perturbed, to_jax

torch.set_num_threads(2)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
SHAPE = (2, 8, 8, 3)


def _tree(mode="coupled", seed=SEED):
    jflow = j_build_glow(**SMALL, grad_mode=mode)
    tree = jflow.init(jax.random.PRNGKey(seed % 1000), jnp.zeros(SHAPE, jnp.float32))
    return perturbed(tree, np.random.default_rng(seed), stacked=False)


def _port(tree, mode="coupled", **kw):
    return params_from_numpy(build_glow(**SMALL, grad_mode=mode, device="cpu", **kw), tree)


@pytest.fixture(scope="module")
def tree():
    return _tree()


def _live(net: nn.Module, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    return net


@pytest.mark.parametrize("kernel_training", [False, True])
@pytest.mark.parametrize("flip,additive,c", [(False, False, 4), (True, False, 5),
                                             (False, True, 4), (True, True, 5)])
def test_affine_coupling_logdet_matches_brute_force_jacobian(flip, additive, c, kernel_training):
    ca = c - c // 2 if flip else c // 2
    net = _live(CouplingCNN(c - ca, ca if additive else 2 * ca, 4, device="cpu"), c)
    layer = AffineCoupling(net, flip=flip, additive=additive, kernel_training=kernel_training)
    shape = (1, 2, 2, c)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, ld = layer(x)
    jac = torch.autograd.functional.jacobian(lambda v: layer(v.reshape(shape))[0].reshape(-1),
                                             x.reshape(-1))
    _, logabsdet = torch.linalg.slogdet(jac.double())
    assert abs(float(ld[0]) - float(logabsdet)) <= 1e-4
    if not additive:
        assert abs(float(ld[0])) > 1e-2  # the coupling is live
    close(layer.inverse(y), x)


@pytest.mark.parametrize("hw", [8, 12])
def test_forward_inverse_and_log_prob_match_reference(tree, hw):
    jflow = j_build_glow(**SMALL, grad_mode="coupled")
    jparams = to_jax(tree)
    flow = _port(tree)
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32)
    jz, jld = jflow.forward(jparams, jnp.asarray(x))
    with torch.no_grad():
        z, ld = flow(torch.from_numpy(x))
    assert len(z) == len(jz) == 2
    for a, r in zip(z, jz):
        close(a, r)
    np.testing.assert_allclose(as_np(ld), np.asarray(jld), rtol=1e-5)
    ref = np.asarray(JFlowServeEngine(jflow, jparams).log_prob(jnp.asarray(x)))
    got = FlowServeEngine(flow, device="cpu").log_prob(x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    # the inverse of one numpy latent on both sides
    rng = np.random.default_rng(hw + 1)
    zs = tuple(rng.standard_normal(v.shape).astype(np.float32) for v in jz)
    with torch.no_grad():
        back = flow.inverse(tuple(map(torch.from_numpy, zs)))
    close(back, jflow.inverse(jparams, tuple(map(jnp.asarray, zs))))
    with torch.no_grad():
        close(flow.inverse(z), x)


def test_kernel_inverse_twin_serves_the_samples(tree, monkeypatch):
    """``FlowServeEngine(flow, sample_flow=twin)``: the twin is a second
    build with ``kernel_inverse=True`` that holds the flow's own parameters,
    and ``sample`` inverts through it (every coupling through
    ``fused_coupling_inv_rows``, the whole-row inverse), matching the
    reference's twin on the same latent."""
    calls = [0]
    inv = coupling_mod.fused_coupling_inv_rows

    def counting(*a, **kw):
        calls[0] += 1
        return inv(*a, **kw)

    monkeypatch.setattr(coupling_mod, "fused_coupling_inv_rows", counting)
    flow = _port(tree)
    twin = share_parameters(build_glow(**SMALL, grad_mode="coupled", kernel_inverse=True,
                                       device="cpu", generator=torch.Generator().manual_seed(9)),
                            flow)
    assert all(a is b for a, b in zip(flow.parameters(), twin.parameters()))
    assert all(a is b for a, b in zip(flow.buffers(), twin.buffers()))
    engine = FlowServeEngine(flow, device="cpu", sample_flow=twin)
    with torch.no_grad():
        z_data, _ = flow(torch.zeros(SHAPE))
    like = tuple(torch.empty_like(v, device="meta") for v in z_data)
    gen = torch.Generator().manual_seed(SEED)
    samples = engine.sample(gen, like)
    assert calls[0] == SMALL["n_scales"] * SMALL["k_steps"]
    z = std_normal_sample(derive_key(gen, 0, "cpu"), like)
    jtwin = j_build_glow(**SMALL, grad_mode="coupled", kernel_inverse=True)
    close(samples, jtwin.inverse(to_jax(tree), tuple(jnp.asarray(v.numpy()) for v in z)))
    with torch.no_grad():
        close(samples, flow.inverse(z))
    # one parameter set: a change to the flow is the twin's
    with torch.no_grad():
        flow.layers[4].layer.net.conv3.b.add_(0.5)
    assert not torch.allclose(engine.sample(gen, like), samples)
    calls[0] = 0
    FlowServeEngine(flow, device="cpu").sample(gen, like)
    assert calls[0] == 0


@pytest.mark.parametrize("mode", ["invertible", "coupled", "autodiff"])
def test_value_and_grad_nll_matches_reference(tree, mode):
    jflow = j_build_glow(**SMALL, grad_mode=mode)
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    jloss, jgrads = j_value_and_grad_nll(jflow.forward, to_jax(tree), jnp.asarray(x))
    flow = _port(tree, mode)
    assert flow.engine == mode
    loss, grads = value_and_grad_nll(flow, torch.from_numpy(x))
    assert abs(float(loss) - float(jloss)) <= 1e-6
    assert set(grads) == {n for n, _ in flow.named_parameters()}
    errs = grad_errors(flow, tree, grads, jgrads)
    assert len(errs) == len(grads) == 2 * 2 * 11 and max(errs.values()) <= 1e-4, errs
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    assert all(p.grad is None for p in flow.parameters())


def _layers(seed=0):
    gen = torch.Generator().manual_seed(seed)
    an = ActNorm(6, device="cpu")
    with torch.no_grad():
        an.log_s.normal_(0, 0.3, generator=gen)
        an.b.normal_(0, 0.3, generator=gen)

    def coupling(**kw):
        flip = kw.get("flip", False)
        ca = 3
        width = ca if kw.get("additive") else 2 * ca
        return AffineCoupling(_live(CouplingCNN(6 - ca, width, 4, device="cpu"), 7 + flip), **kw)

    return {
        "actnorm": an,
        "conv1x1": Conv1x1(6, generator=gen, device="cpu"),
        "coupling": coupling(),
        "coupling_kernel_training": coupling(kernel_training=True),
        "coupling_flip": coupling(flip=True),
        "coupling_additive": coupling(additive=True),
    }


@pytest.mark.parametrize("name", list(_layers()))
def test_coupled_hooks_match_the_generic_step(name):
    """A layer's ``fused_bwd`` (rebuild + closed-form or one-pass cotangents)
    gives what the generic step gives: rebuild by ``inverse``, then the local
    VJP of the forward, through the chain engine's own reverse walk."""
    layer = _layers()[name]
    assert hasattr(layer, "fused_bwd")
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        y, _ = layer(torch.randn((2, 3, 3, 6), generator=g))
    gy, gld = torch.randn(y.shape, generator=g), torch.randn(2, generator=g)
    fused = chain_backward([layer], y, gy, gld, None, use_fused=True)
    generic = chain_backward([layer], y, gy, gld, None, use_fused=False)
    close(fused[0], generic[0], atol=1e-5)
    close(fused[1], generic[1], atol=1e-5)
    assert set(fused[2][0]) == set(generic[2][0]) == {n for n, _ in layer.named_parameters()}
    for key, v in generic[2][0].items():
        close(fused[2][0][key], v, atol=1e-5)


@pytest.mark.parametrize("c", [12, 24, 48])
def test_lu_weight_inv_inverts_the_weight_the_forward_applies(c):
    """The reversible backward rebuilds each 1x1 conv's input with
    ``lu_weight_inv``; it must invert the rounded f32 W that the forward
    multiplies by, to the final rounding of ``W^-1`` (1e-7 in
    ``W W^-1 - I``), where the reference's two triangular solves invert the
    exact ``L U`` and miss the rounded W by several times more."""
    g = torch.Generator().manual_seed(c)
    worst = {"newton": 0.0, "solves": 0.0}
    for seed in range(10):
        lu = conv1x1_init(torch.Generator().manual_seed(seed), c)
        lu["l"] = lu["l"] + 0.05 / c**0.5 * torch.randn((c, c), generator=g)
        lu["log_s"] = lu["log_s"] + 0.05 * torch.randn(c, generator=g)
        w = lu_weight(lu).double()
        eye = torch.eye(c, dtype=torch.float64)
        for name, fn in (("newton", lu_weight_inv), ("solves", lu_weight_inv_solves)):
            w_inv = fn(lu)
            assert w_inv.dtype == torch.float32
            worst[name] = max(worst[name], (w @ w_inv.double() - eye).abs().max().item())
    assert worst["newton"] <= 1e-7 < worst["solves"]
    assert worst["solves"] > 3 * worst["newton"]


class _Counting(nn.Module):
    """A conditioner that counts its evaluations."""

    def __init__(self, inner, counter):
        super().__init__()
        self.inner, self.counter = inner, counter

    def forward(self, x, cond=None):
        self.counter[0] += 1
        return self.inner(x, cond)


@pytest.mark.parametrize("mode,calls_per_layer", [("invertible", 3), ("coupled", 2)])
def test_coupled_backward_evaluates_the_conditioner_once(mode, calls_per_layer):
    """Forward 1 + the fused backward 1 under ``coupled``; forward 1 +
    inverse 1 + the local VJP 1 under ``invertible`` (the reference's
    ``tests/test_autodiff.py`` probe)."""
    counter, depth = [0], 3
    layers = [AffineCoupling(_Counting(_live(CouplingCNN(3, 6, 4, device="cpu"), i), counter),
                             flip=bool(i % 2), kernel_training=mode == "coupled")
              for i in range(depth)]
    chain = InvertibleChain(layers, grad_mode=mode)
    value_and_grad_nll(chain, torch.randn((4, 2, 2, 6), generator=torch.Generator().manual_seed(0)))
    assert counter[0] == calls_per_layer * depth


def test_configs_build_the_unrolled_glow():
    flow = build_flow(GLOW_COUPLED, channels=3, device="cpu")
    couplings = [layer.layer for layer in flow.layers if isinstance(getattr(layer, "layer", None),
                                                                    AffineCoupling)]
    assert len(flow.layers) == 1 + 3 * (1 + 3 * 8) + 2 and len(couplings) == 24
    assert flow.grad_mode == flow.engine == "coupled"
    assert all(c.kernel_training and not c.kernel_inverse for c in couplings)
    for cfg in (GLOW_PAPER, GLOW_FIG1):
        f = build_flow(cfg, channels=3, device="cpu")
        assert f.grad_mode == "invertible"
        assert not any(getattr(layer.layer, "kernel_training", False) for layer in f.layers
                       if hasattr(layer, "layer"))
    # the same density model as the scanned build, parameter for parameter
    scanned = build_flow(GLOW_SCANNED, channels=3, device="cpu")
    assert (sum(p.numel() for p in flow.parameters())
            == sum(p.numel() for p in scanned.parameters()))


def test_bridge_carries_the_glow_tree_both_ways(tree):
    flow = _port(tree)
    back = tree_to_numpy(flow, like=tree)
    want, got = tree_paths(flow, tree), tree_paths(flow, back)
    assert want.keys() == got.keys() and len(want) == len(flow.state_dict())
    for key, v in want.items():
        assert got[key].dtype == v.dtype, key
        np.testing.assert_array_equal(got[key], v, err_msg=key)

"""The port's gradient engines on scanned GLOW against the JAX reference.

``GLOW_SCANNED``'s structure at a small size (2 scales x 2 steps, hidden 8)
on (2, 8, 8, 3), in the four modes of the reference: ``invertible``,
``coupled`` with the ``reversible`` and with the ``stored`` backward, and
``autodiff``.  The port's ``value_and_grad_nll`` is held against the
reference's ``value_and_grad_nll(flow.forward, ...)`` on one perturbed
parameter tree (``tests/torch_parity.py``) and one numpy batch, every
gradient leaf compared through ``bridge.tree_to_numpy``.  The reference runs
its CPU path; ``coupled_bwd`` is passed explicitly, and
``REPRO_COUPLED_BWD`` is kept out of the environment.

Tolerances, each with its reason:

* loss: 1e-6 absolute; an f32 mean of order 1;
* every gradient leaf: 1e-4 absolute, the reference's own grad-parity bound
  (``tests/test_flowstep.py``);
* round trip after a backward: 1e-4 absolute, the kernel bound.

Also here: the conditioner evaluations of a train step per mode, and the
paper's claim on the CPU, that the tensors a forward saves for the backward
do not grow with depth under ``invertible`` and ``coupled``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.autodiff import value_and_grad_nll as j_value_and_grad_nll
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro_torch.bridge import params_from_numpy
from repro_torch.core import glow_scan, value_and_grad_nll
from repro_torch.core.chain import OnFirst, Split
from repro_torch.core.glow_scan import build_glow_scanned, resolve_coupled_bwd
from repro_torch.core.haar import HaarSqueeze
from repro_torch.core.actnorm import ActNorm
from repro_torch.core.types import Invertible
from repro_torch.core.objectives import nll_bits_per_dim, nll_loss
from torch_parity import close, grad_errors, make_pair

torch.set_num_threads(2)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
SHAPE = (2, 8, 8, 3)
MODES = [("invertible", "auto"), ("coupled", "reversible"), ("coupled", "stored"),
         ("autodiff", "auto")]


@pytest.fixture(scope="module")
def pair():
    _, jparams, _, tree = make_pair(SMALL, SHAPE)
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    return jparams, tree, x


def _port(tree, mode, coupled_bwd, cfg=SMALL):
    return params_from_numpy(build_glow_scanned(**cfg, grad_mode=mode, coupled_bwd=coupled_bwd,
                                                device="cpu"), tree)


@pytest.mark.parametrize("mode,coupled_bwd", MODES)
def test_value_and_grad_nll_matches_reference(pair, mode, coupled_bwd, monkeypatch):
    monkeypatch.delenv("REPRO_COUPLED_BWD", raising=False)
    jparams, tree, x = pair
    jflow = j_build_glow_scanned(**SMALL, grad_mode=mode, coupled_bwd=coupled_bwd)
    jloss, jgrads = j_value_and_grad_nll(jflow.forward, jparams, jnp.asarray(x))
    flow = _port(tree, mode, coupled_bwd)
    loss, grads = value_and_grad_nll(flow, torch.from_numpy(x))
    assert abs(float(loss) - float(jloss)) <= 1e-6
    assert set(grads) == {n for n, _ in flow.named_parameters()}
    errs = grad_errors(flow, tree, grads, jgrads)
    assert len(errs) == len(grads) and max(errs.values()) <= 1e-4, errs
    # the gradients are live, not all zeros
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    assert all(p.grad is None for p in flow.parameters())
    with torch.no_grad():
        z, _ = flow(torch.from_numpy(x))
        close(flow.inverse(z), x)


def test_bits_per_dim_is_the_nll_in_bits(pair):
    _, tree, x = pair
    flow = _port(tree, "coupled", "reversible")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        bpd, nll = float(nll_bits_per_dim(flow, xt)), float(nll_loss(flow, xt))
    np.testing.assert_allclose(bpd, (nll + np.log(256.0)) / np.log(2.0), rtol=1e-6)


def test_coupled_bwd_resolution():
    assert resolve_coupled_bwd("auto", "cpu") == "stored"
    assert resolve_coupled_bwd("auto", "cuda") == "reversible"
    assert resolve_coupled_bwd("reversible", "cpu") == "reversible"
    with pytest.raises(ValueError):
        resolve_coupled_bwd("bogus", "cpu")
    flow = build_glow_scanned(**SMALL, grad_mode="coupled", device="cpu")
    assert flow.grad_mode == "coupled" and flow.engine == "autodiff"
    assert flow.layers[2].layer.coupled_bwd == "stored"
    flow = build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible", device="cpu")
    assert flow.engine == "coupled" and flow.layers[2].layer.engine == "coupled"


def test_on_first_offers_only_the_hooks_of_its_layer():
    assert hasattr(OnFirst(HaarSqueeze()), "fused_bwd")
    assert not hasattr(OnFirst(HaarSqueeze()), "invertible_bwd")
    assert hasattr(OnFirst(ActNorm(4, device="cpu")), "fused_bwd")
    assert not hasattr(OnFirst(Invertible()), "fused_bwd")
    stack = build_glow_scanned(**SMALL, device="cpu").layers[2]
    assert hasattr(stack, "fused_bwd") and hasattr(stack, "invertible_bwd")
    assert hasattr(Split(), "fused_bwd")


@pytest.mark.parametrize("mode,coupled_bwd,per_step,fused_per_step", [
    ("coupled", "reversible", 2, 1),  # forward 1 + fused backward 1
    ("invertible", "auto", 3, 0),     # forward 1 + inverse 1 + VJP 1
    ("coupled", "stored", 1, 0),      # autograd keeps the activations
    ("autodiff", "auto", 1, 0),
])
def test_conditioner_evaluations_per_train_step(mode, coupled_bwd, per_step, fused_per_step,
                                                monkeypatch):
    calls = {"net": 0, "coupling_bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(glow_scan, "coupling_cnn_apply",
                        counting("net", glow_scan.coupling_cnn_apply))
    monkeypatch.setattr(glow_scan, "fused_coupling_bwd_rows",
                        counting("coupling_bwd", glow_scan.fused_coupling_bwd_rows))
    flow = build_glow_scanned(**SMALL, grad_mode=mode, coupled_bwd=coupled_bwd, device="cpu")
    value_and_grad_nll(flow, torch.randn(SHAPE))
    steps = SMALL["n_scales"] * SMALL["k_steps"]
    assert calls == {"net": per_step * steps, "coupling_bwd": fused_per_step * steps}


def _saved_bytes(mode, k_steps):
    """Bytes of the tensors one loss's forward saves for its backward."""
    flow = build_glow_scanned(n_scales=2, k_steps=k_steps, hidden=8, grad_mode=mode,
                              coupled_bwd="reversible", device="cpu",
                              generator=torch.Generator().manual_seed(0))
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = nll_loss(flow, x)
    loss.backward()
    assert all(p.grad is not None for p in flow.parameters())
    return total[0]


def test_saved_bytes_flat_in_depth_for_the_memory_frugal_engines():
    """The paper's claim on the CPU (reference ``tests/test_autodiff.py``
    memory tests): only the output crosses from forward to backward, so the
    saved bytes do not depend on depth; plain autograd's grow with it."""
    inv = [_saved_bytes("invertible", k) for k in (2, 6)]
    cpl = [_saved_bytes("coupled", k) for k in (2, 6)]
    ad = [_saved_bytes("autodiff", k) for k in (2, 6)]
    assert inv[0] == inv[1] == cpl[0] == cpl[1], (inv, cpl)
    assert ad[1] > 2 * ad[0] and ad[0] > 4 * inv[0], (ad, inv)

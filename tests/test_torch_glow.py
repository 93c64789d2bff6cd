"""The served slice of the port as a whole: scanned GLOW (``GLOW_SCANNED``)
``log_prob`` and sampling against the JAX reference, the parameter bridge,
and the sampling-stream contract.

Parameters come from the reference's ``init``, every float leaf perturbed
with numpy noise (``init`` zeroes actnorm and each conditioner's last conv,
which would make every coupling the identity), and the same tree goes to both
sides.  The noise is scaled by each weight's fan-in: every coupling is live
at any width, and the flows stay well conditioned at full depth (latents of
order 1 to 10; flat noise of the same size makes the 24-step flow blow up),
so the absolute f32 bound below measures the port and not f32 round-off at
large magnitudes.  ``chip_smoke.py`` perturbs the port's own init the same
way.
Inputs and latents are numpy arrays from a fixed seed.

Tolerances, each with its reason:

* ``log_prob``: 1e-5 relative; its value scales with the dimension D
  (-0.5*|z|^2 - D/2*log(2*pi) + logdet), so an absolute bound would tighten
  or loosen with the image size;
* latents, samples and round trips: 1e-4 absolute per element in f32, the
  reference's own kernel bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.glow_scan import GlowStepStack as JGlowStepStack
from repro.serve.engine import FlowServeEngine as JFlowServeEngine
from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.configs.flows import GLOW_SCANNED, FlowConfig, build_flow
from repro_torch.core import GlowStepStack, build_glow_scanned, derive_key, std_normal_sample
from repro_torch.serve.engine import FlowServeEngine
from torch_parity import SEED, as_np, close, make_pair, perturbed, to_jax

torch.set_num_threads(2)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)


@pytest.fixture(scope="module")
def small():
    return make_pair(SMALL, (2, 8, 8, 3))


def test_glow_step_stack_matches_reference():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 6, 6, 12)).astype(np.float32)  # M = 36
    jstack = JGlowStepStack(2, hidden=8)
    tree = perturbed(jstack.init(jax.random.PRNGKey(3), jnp.asarray(x)), rng)
    stack = params_from_numpy(GlowStepStack(12, 2, hidden=8, device="cpu"), tree)
    jy, jld = jstack.forward(to_jax(tree), jnp.asarray(x))
    y, ld = stack(torch.from_numpy(x))
    close(y, jy)
    np.testing.assert_allclose(as_np(ld), np.asarray(jld), rtol=1e-5)
    # the couplings are live: the logdet is not only the per-channel constants
    an, lu = tree["an"]["log_s"], tree["lu"]["log_s"]
    assert np.abs(as_np(ld) - 36 * (an.sum() + lu.sum())).min() > 1e-2
    close(stack.inverse(y), jstack.inverse(to_jax(tree), jy))
    close(stack.inverse(y), x)


@pytest.mark.parametrize("hw", [8, 12])  # 12: 3x3 at the last scale, ragged M
def test_log_prob_matches_reference(small, hw):
    jflow, jparams, flow, _ = small
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32)
    ref = np.asarray(JFlowServeEngine(jflow, jparams).log_prob(jnp.asarray(x)))
    got = FlowServeEngine(flow, device="cpu").log_prob(x)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_sampling_inverse_matches_reference(small):
    """The same numpy latent through both inverses (the reference's
    ``derive_key`` bits are not reproduced, so the noise is shared)."""
    jflow, jparams, flow, _ = small
    with torch.no_grad():
        proto, _ = flow(torch.zeros(2, 8, 8, 3))
    rng = np.random.default_rng(5)
    z = tuple(rng.standard_normal(tuple(v.shape)).astype(np.float32) for v in proto)
    jx = jflow.inverse(jparams, tuple(jnp.asarray(v) for v in z))
    with torch.no_grad():
        x = flow.inverse(tuple(torch.from_numpy(v) for v in z))
        close(x, jx)
        z_back, _ = flow(x)
    for a, b in zip(z_back, z):
        close(a, b)


def test_engine_sample_is_seeded_and_round_trips(small):
    _, _, flow, _ = small
    engine = FlowServeEngine(flow, device="cpu")
    like = tuple(torch.empty(s, device="meta") for s in [(3, 2, 2, 24), (3, 4, 4, 6)])
    a = engine.sample(torch.Generator().manual_seed(7), like)
    b = engine.sample(torch.Generator().manual_seed(7), like)
    c = engine.sample(torch.Generator().manual_seed(8), like)
    assert a.shape == (3, 8, 8, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(engine.log_prob(a)).all()


def test_derive_key_contract():
    """Same seed and tag -> same draws, whatever the caller did with its
    generator (which is read, never advanced); other tags -> other draws."""
    like = (torch.empty(4, 3, device="meta"), torch.empty(2, device="meta"))
    g = torch.Generator().manual_seed(11)
    first = std_normal_sample(derive_key(g, 0), like)
    state = g.get_state()
    torch.randn(5, generator=g)  # the caller uses its generator meanwhile
    again = std_normal_sample(derive_key(g, 0), like)
    other = std_normal_sample(derive_key(g, 1), like)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0])
    assert [tuple(v.shape) for v in first] == [(4, 3), (2,)]
    g2 = torch.Generator().manual_seed(11)
    derive_key(g2, 0)
    assert torch.equal(g2.get_state(), torch.Generator().manual_seed(11).get_state())
    assert not torch.equal(state, g.get_state())


def test_bridge_maps_every_leaf_once(small):
    _, _, flow, tree = small
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    paths = tree_paths(flow, tree)
    assert len(paths) == n_leaves == len(flow.state_dict())
    assert set(paths) == set(flow.state_dict())
    assert "layers.2.layer.lu.l" in paths and "layers.5.layer.net.conv3.w" in paths


def test_bridge_integer_leaves_are_integer_buffers(small):
    _, _, flow, tree = small
    buffers = dict(flow.named_buffers())
    params = dict(flow.named_parameters())
    for i in (2, 5):
        perm, sign = buffers[f"layers.{i}.layer.lu.inv_perm"], buffers[f"layers.{i}.layer.lu.sign_s"]
        assert perm.dtype == torch.int32 and sign.dtype == torch.int8
        assert f"layers.{i}.layer.lu.inv_perm" not in params
        np.testing.assert_array_equal(perm.numpy(), np.asarray(tree[i]["lu"]["inv_perm"]))
    assert all(p.is_floating_point() for p in params.values())


def test_bridge_raises_on_unmapped_leaves(small):
    _, _, _, tree = small
    flow = build_glow_scanned(**SMALL, channels=3, device="cpu")
    extra = list(tree)
    extra[2] = dict(tree[2], scale=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="tree-only"):
        params_from_numpy(flow, tuple(extra))
    missing = list(tree)
    missing[2] = {k: v for k, v in tree[2].items() if k != "an"}
    with pytest.raises(KeyError, match="module-only"):
        params_from_numpy(flow, tuple(missing))
    wrong = list(tree)
    wrong[2] = dict(tree[2], lu=dict(tree[2]["lu"], sign_s=np.ones((2, 12), np.float32)))
    with pytest.raises(TypeError):
        params_from_numpy(flow, tuple(wrong))


def test_build_flow_ports_only_glow_scanned():
    flow = build_flow(GLOW_SCANNED, device="cpu")
    assert flow.grad_mode == "coupled" and len(flow.layers) == 1 + 3 * 2 + 2
    # the unrolled GLOW is ported too (tests/test_torch_glow_coupled.py)
    assert build_flow(FlowConfig(name="glow", kind="glow"), device="cpu").grad_mode == "invertible"
    # and cHINT (tests/test_torch_conditional.py)
    assert build_flow(FlowConfig(name="chint", kind="chint"), device="cpu").grad_mode == "invertible"
    # and RealNVP and the hyperbolic network (tests/test_torch_zoo.py): every
    # kind of the reference builds, and an unknown one raises
    for kind in ("realnvp", "hyperbolic"):
        assert build_flow(FlowConfig(name=kind, kind=kind), device="cpu").grad_mode == "invertible"
    with pytest.raises(ValueError):
        build_flow(FlowConfig(name="nope", kind="nope"), device="cpu")

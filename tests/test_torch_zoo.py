"""The rest of the flow zoo in the PyTorch port (``repro_torch``) against the
JAX reference (``repro``): RealNVP (``core/realnvp.py``) and the hyperbolic
leapfrog network (``core/hyperbolic.py``).

Inputs and parameters come from the reference's conformance registry
(``tests/conformance.py``: the ``hyperbolic-*`` cases and the ``realnvp`` and
``hyperbolic`` chain builders, with their examples and perturbed trees),
carried into the port by ``repro_torch.bridge``.  The reference runs on its
CPU path (its Pallas coupling kernels in interpret mode where
``kernel_training`` turns them on); the port takes each kernel's plain
version on the CPU.

Tolerances are the registry's: 1e-4 absolute per element for forward
outputs, round trips and every gradient leaf (``GRAD_PARITY_TOL``), 1e-3 for
a logdet against the log |det| of the Jacobian (``LOGDET_TOL``), losses to
1e-5 absolute (``test_builder_grad_parity``).  The round-trip property test
scales its bound by the chain's output magnitude: an absolute bound fails
on f32 rounding where the chain grows |x| by orders of magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conformance import (
    CASES_BY_NAME,
    CHAIN_BUILDERS,
    GRAD_PARITY_TOL,
    LOGDET_TOL,
    ROUNDTRIP_TOL,
    perturb,
)
from repro.core import InvertibleChain as JInvertibleChain
from repro.core import build_realnvp as j_build_realnvp
from repro.core import value_and_grad_nll as j_value_and_grad_nll
from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.configs import flows as flow_configs
from repro_torch.core import (
    ActNorm,
    AffineCoupling,
    Conv1x1,
    HyperbolicLayer,
    InvertibleChain,
    build_hyperbolic,
    build_realnvp,
    flatten_state,
    value_and_grad_nll,
)
from repro_torch.kernels.coupling import ops as coupling_ops
from repro_torch.nn.nets import CouplingMLP

torch.set_num_threads(2)

RNG = jax.random.PRNGKey(20260728)  # the reference's conformance key
SEED = 20261017
MODES = ("autodiff", "invertible", "coupled")


def _np(tree):
    return jax.tree_util.tree_map(lambda v: None if v is None else np.asarray(v), tree,
                                  is_leaf=lambda v: v is None)


def _t(a):
    if isinstance(a, tuple):
        return tuple(_t(v) for v in a)
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _close(a, b, atol):
    if isinstance(a, tuple):
        for u, v in zip(a, b):
            _close(u, v, atol)
        return
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the registry's hyperbolic cases
# ---------------------------------------------------------------------------

#: the registry's hyperbolic cases: name -> port layer from the channel count
PORT_CASES = {
    "hyperbolic-dense": lambda c: HyperbolicLayer(c, alpha=0.3, conv=False, device="cpu"),
    "hyperbolic-conv": lambda c: HyperbolicLayer(c, alpha=0.3, conv=True, device="cpu"),
}


def make_case(name):
    """(reference layer, its params, port layer, x) of a registry case: x
    is the pair state, the port holding the reference's perturbed
    parameters."""
    jlayer, params, x, _ = CASES_BY_NAME[name].make(RNG)
    x = tuple(np.asarray(v) for v in x)
    layer = PORT_CASES[name](x[0].shape[-1])
    params_from_numpy(layer, _np(params))
    return jlayer, params, layer, x


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_forward_and_round_trip(name):
    jlayer, params, layer, x = make_case(name)
    jy, jld = jlayer.forward(params, tuple(jnp.asarray(v) for v in x))
    with torch.no_grad():
        y, ld = layer(_t(x))
        back = layer.inverse(y)
    _close(y, jy, 1e-4)
    assert ld.shape == (x[0].shape[0],) and ld.dtype == torch.float32
    assert not ld.any() and not np.asarray(jld).any()
    _close(back, x, ROUNDTRIP_TOL)
    # the state's first leaf passes through: x_cur becomes y's x_prev
    assert torch.equal(y[0], _t(x[1]))


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_logdet_matches_jacobian(name):
    """The logdet (0: volume-preserving) against log |det| of the flattened
    pair map's Jacobian."""
    _, _, layer, x = make_case(name)
    shape, n = x[0].shape, x[0].size
    flat = torch.cat([_t(v).reshape(-1) for v in x])

    def fwd(v):
        y, _ = layer((v[:n].reshape(shape), v[n:].reshape(shape)))
        return torch.cat([u.reshape(-1) for u in y])

    jac = torch.autograd.functional.jacobian(fwd, flat)
    _, ref = np.linalg.slogdet(jac.double().numpy())
    with torch.no_grad():
        _, ld = layer(_t(x))
    np.testing.assert_allclose(float(ld.sum()), ref, rtol=LOGDET_TOL, atol=LOGDET_TOL)


def _j_grads(jlayer, params, x, mode, wz):
    chain = JInvertibleChain([jlayer], grad_mode=mode)

    def loss(p, x_):
        z, ld = chain.forward((p,), x_)
        return jnp.sum(jnp.concatenate([v.reshape(-1) for v in z]) * wz) - jnp.sum(ld)

    return jax.grad(loss, argnums=(0, 1))(params, tuple(jnp.asarray(v) for v in x))


def _port_grads(layer, x, mode, wz):
    chain = InvertibleChain([layer], grad_mode=mode)
    xt = tuple(_t(v).requires_grad_() for v in x)
    z, ld = chain(xt)
    loss = torch.sum(torch.cat([v.reshape(-1) for v in z]) * torch.from_numpy(wz)) - torch.sum(ld)
    named = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [*named.values(), *xt])
    return dict(zip(named, grads[:len(named)])), grads[len(named):]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_grad_parity(name, mode):
    """Parameters' and both state leaves' cotangents in each engine against
    the reference's in the same engine, and against the port's plain
    autograd, within ``GRAD_PARITY_TOL``."""
    jlayer, params, layer, x = make_case(name)
    wz = np.random.default_rng(SEED).standard_normal(2 * x[0].size).astype(np.float32)
    jgp, jgx = _j_grads(jlayer, params, x, mode, wz)
    gp, gx = _port_grads(layer, x, mode, wz)
    gp_ad, gx_ad = _port_grads(layer, x, "autodiff", wz)
    ref = tree_paths(layer, _np(jgp))
    assert set(gp) == set(ref) == {"k.w", "k.b"}
    for key, g in gp.items():
        _close(g, ref[key], GRAD_PARITY_TOL)
        _close(g, gp_ad[key], GRAD_PARITY_TOL)
    _close(gx, jgx, GRAD_PARITY_TOL)
    _close(gx, gx_ad, GRAD_PARITY_TOL)


# ---------------------------------------------------------------------------
# the registry's realnvp and hyperbolic chain builders
# ---------------------------------------------------------------------------

#: name -> port builder from (example, grad_mode), as the registry builds them
PORT_BUILDERS = {
    "realnvp": lambda x, gm: build_realnvp(x.shape[-1], depth=4, hidden=16, grad_mode=gm,
                                           device="cpu"),
    "hyperbolic": lambda x, gm: build_hyperbolic(x[0].shape[-1], depth=4, alpha=0.3, conv=False,
                                                 grad_mode=gm, device="cpu"),
}


def _chain_pair(name, mode):
    """(reference builder, its perturbed params, port chain, example)."""
    build, example = CHAIN_BUILDERS[name]
    x = example(RNG)
    params = perturb(build("autodiff").init(RNG, x), jax.random.fold_in(RNG, 5), 0.05)
    x = tuple(np.asarray(v) for v in x) if isinstance(x, tuple) else np.asarray(x)
    flow = params_from_numpy(PORT_BUILDERS[name](x, mode), _np(params))
    return build, params, flow, x


def _jx(x):
    return tuple(jnp.asarray(v) for v in x) if isinstance(x, tuple) else jnp.asarray(x)


@pytest.mark.parametrize("name", sorted(PORT_BUILDERS))
def test_builder_round_trip_and_logdet(name):
    """The chain's output against the reference's, the round trip, and the
    logdet summed over the batch against log |det| of the whole batch's
    Jacobian (block-diagonal: the sum of the samples')."""
    build, params, flow, x = _chain_pair(name, "coupled")
    jz, jld = build("coupled").forward(params, _jx(x))
    xt = _t(x)
    with torch.no_grad():
        z, ld = flow(xt)
        back = flow.inverse(z)
    _close(z, jz, 1e-4)
    _close(ld, jld, 1e-4)
    _close(back, x, ROUNDTRIP_TOL)
    leaves = xt if isinstance(xt, tuple) else (xt,)
    sizes = [v.numel() for v in leaves]

    def fwd(v):
        parts = [p.reshape(u.shape) for p, u in zip(torch.split(v, sizes), leaves)]
        y, _ = flow(tuple(parts) if isinstance(xt, tuple) else parts[0])
        return flatten_state(y).reshape(-1)

    jac = torch.autograd.functional.jacobian(fwd, torch.cat([v.reshape(-1) for v in leaves]))
    _, ref = np.linalg.slogdet(jac.double().numpy())
    np.testing.assert_allclose(float(ld.sum()), ref, rtol=LOGDET_TOL, atol=LOGDET_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PORT_BUILDERS))
def test_builder_grad_parity(name, mode):
    """``value_and_grad_nll`` in each engine against the reference's in the
    same engine and against the port's autodiff: the loss within 1e-5, each
    gradient leaf within ``GRAD_PARITY_TOL``."""
    build, params, flow, x = _chain_pair(name, mode)
    _, _, flow_ad, _ = _chain_pair(name, "autodiff")
    jl, jg = j_value_and_grad_nll(build(mode).forward, params, _jx(x))
    loss, grads = value_and_grad_nll(flow, _t(x))
    loss_ad, grads_ad = value_and_grad_nll(flow_ad, _t(x))
    assert abs(float(loss) - float(jl)) < 1e-5 and abs(float(loss) - float(loss_ad)) < 1e-5
    ref = tree_paths(flow, _np(jg))
    assert set(grads) == set(ref)
    for key, g in grads.items():
        _close(g, ref[key], GRAD_PARITY_TOL)
        _close(g, grads_ad[key], GRAD_PARITY_TOL)


@pytest.mark.parametrize("name", sorted(PORT_BUILDERS))
def test_builder_fused_path_engages(name):
    """Under ``coupled`` every layer's ``fused_bwd`` runs exactly once a
    backward: no layer falls back to the generic invert-then-VJP step."""
    _, _, flow, x = _chain_pair(name, "coupled")
    counts = [0] * len(flow.layers)
    for i, layer in enumerate(flow.layers):
        orig = layer.fused_bwd

        def counted(*a, _i=i, _orig=orig, **kw):
            counts[_i] += 1
            return _orig(*a, **kw)

        layer.fused_bwd = counted
    value_and_grad_nll(flow, _t(x))
    assert counts == [1] * len(flow.layers)


@pytest.mark.parametrize("mode,calls_per_layer", [("invertible", 3), ("coupled", 2)])
@pytest.mark.parametrize("name", sorted(PORT_BUILDERS))
def test_conditioner_eval_count(name, mode, calls_per_layer):
    """The coupled backward evaluates each coupling conditioner (RealNVP)
    or each leapfrog ``op`` (hyperbolic) once, 2 a layer with the forward;
    invert-then-VJP twice, 3 a layer."""
    _, _, flow, x = _chain_pair(name, mode)
    counter = [0]
    if name == "realnvp":
        nets = [layer.net for layer in flow.layers if isinstance(layer, AffineCoupling)]
        for net in nets:
            net.register_forward_pre_hook(lambda *_: counter.__setitem__(0, counter[0] + 1))
    else:
        nets = list(flow.layers)
        for layer in nets:
            orig = layer._op

            def counted(*a, _orig=orig):
                counter[0] += 1
                return _orig(*a)

            layer._op = counted
    assert len(nets) == 4
    value_and_grad_nll(flow, _t(x))
    assert counter[0] == calls_per_layer * len(nets)


# ---------------------------------------------------------------------------
# RealNVP's kernel_training path on the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_training", [False, True])
def test_coupled_realnvp_with_kernel_training_matches_reference(kernel_training, monkeypatch):
    """``tests/test_autodiff.py``'s dense coupled-chain case (depth 6,
    hidden 32, (8, 6)), its parameters perturbed so every coupling is live:
    the port's coupled chain, with and without ``kernel_training``, against
    the reference's in the same setting (its Pallas kernels in interpret
    mode) and against the port's autodiff.  With ``kernel_training`` the
    forward and the coupled backward take the coupling row ops (their plain
    versions here), one call of each a coupling."""
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 6))
    jflow = j_build_realnvp(depth=6, hidden=32, grad_mode="coupled",
                            kernel_training=kernel_training)
    params = perturb(jflow.init(jax.random.PRNGKey(0), x), jax.random.PRNGKey(1), 0.05)
    jl, jg = j_value_and_grad_nll(jflow.forward, params, x)
    flow = params_from_numpy(build_realnvp(6, depth=6, hidden=32, grad_mode="coupled",
                                           kernel_training=kernel_training, device="cpu"),
                             _np(params))
    flow_ad = params_from_numpy(build_realnvp(6, depth=6, hidden=32, grad_mode="autodiff",
                                              device="cpu"), _np(params))
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "fused_coupling_fwd_rows"), ("bwd", "fused_coupling_bwd_rows")):
        real = getattr(coupling_ops, name)

        def counted(*a, _key=key, _real=real, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(coupling_ops, name, counted)
        monkeypatch.setattr(f"repro_torch.core.coupling.{name}", counted)
    xt = _t(np.asarray(x))
    loss, grads = value_and_grad_nll(flow, xt)
    loss_ad, grads_ad = value_and_grad_nll(flow_ad, xt)
    assert calls == ({"fwd": 6, "bwd": 6} if kernel_training else {"fwd": 0, "bwd": 0})
    assert abs(float(loss) - float(jl)) < 1e-5 and abs(float(loss) - float(loss_ad)) < 1e-5
    ref = tree_paths(flow, _np(jg))
    for key, g in grads.items():
        _close(g, ref[key], GRAD_PARITY_TOL)
        _close(g, grads_ad[key], GRAD_PARITY_TOL)


@pytest.mark.parametrize("d", [2, 7])
def test_realnvp_kernel_path_takes_unequal_and_single_column_halves(d):
    """Odd D (halves of D // 2 and D - D // 2, the wider one transformed on
    the flipped layers) and D = 2 (one column a half): the row ops' round
    trip and the coupled kernel-path gradient against autodiff."""
    g = torch.Generator().manual_seed(SEED + d)
    flow = build_realnvp(d, depth=4, hidden=16, grad_mode="coupled", kernel_training=True,
                         generator=g, device="cpu")
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    flow_ad = build_realnvp(d, depth=4, hidden=16, grad_mode="autodiff", device="cpu")
    flow_ad.load_state_dict(flow.state_dict())
    x = torch.randn(16, d, generator=g)
    with torch.no_grad():
        z, ld = flow(x)
        z_ad, ld_ad = flow_ad(x)
        back = flow.inverse(z)
    _close(z, z_ad.numpy(), 1e-5)
    _close(ld, ld_ad.numpy(), 1e-5)
    _close(back, x.numpy(), ROUNDTRIP_TOL)
    loss, grads = value_and_grad_nll(flow, x)
    loss_ad, grads_ad = value_and_grad_nll(flow_ad, x)
    assert abs(float(loss) - float(loss_ad)) < 1e-5
    for key, gr in grads.items():
        _close(gr, grads_ad[key].numpy(), GRAD_PARITY_TOL)


def test_build_flow_builds_realnvp_and_hyperbolic():
    flow = flow_configs.build_flow(flow_configs.REALNVP_2D, device="cpu")
    assert flow.grad_mode == "invertible" and len(flow.layers) == 2 * 8
    assert flow.layers[1].net.layers[0].w.shape == (1, 128)  # D = 2: one column a half
    deep = flow_configs.build_flow(flow_configs.HYPERBOLIC_DEEP, device="cpu")
    assert deep.grad_mode == "coupled" and len(deep.layers) == 16
    assert all(layer.conv and layer.alpha == 0.25 for layer in deep.layers)
    assert deep.layers[0].k.w.shape == (3, 3, 3, 3)
    x = (torch.randn(2, 8, 8, 3), torch.randn(2, 8, 8, 3))
    with torch.no_grad():
        back = deep.inverse(deep(x)[0])
    _close(back, tuple(v.numpy() for v in x), ROUNDTRIP_TOL)


# ---------------------------------------------------------------------------
# the chain round trip as a property
# ---------------------------------------------------------------------------


@given(
    dim=st.integers(min_value=2, max_value=12),
    batch=st.integers(min_value=1, max_value=5),
    depth=st.integers(min_value=1, max_value=4),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=10, deadline=None, derandomize=True)
def test_realnvp_chain_round_trip_property(dim, batch, depth, seed):
    """The reference's ``test_chain_roundtrip`` chain (``ActNorm``,
    ``Conv1x1``, alternating ``AffineCoupling`` with MLP conditioners of one
    hidden layer of 8, every parameter perturbed by 0.2), its examples drawn
    from a fixed seed: ``inverse(forward(x))`` within ``ROUNDTRIP_TOL`` of
    the chain's largest output magnitude (at least 1)."""
    g = torch.Generator().manual_seed(seed)
    layers = []
    for i in range(depth):
        flip = bool(i % 2)
        n = dim - dim // 2 if flip else dim // 2
        layers += [ActNorm(dim, device="cpu"), Conv1x1(dim, generator=g, device="cpu"),
                   AffineCoupling(CouplingMLP(dim - n, 2 * n, hidden=8, depth=1, generator=g,
                                              device="cpu"), flip=flip)]
    chain = InvertibleChain(layers)
    with torch.no_grad():
        for p in chain.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=g))
        x = torch.randn(batch, dim, generator=g)
        y, ld = chain(x)
        back = chain.inverse(y)
    scale = max(1.0, float(y.abs().max()))
    assert float((back - x).abs().max()) <= ROUNDTRIP_TOL * scale
    assert ld.shape == (batch,) and bool(torch.isfinite(ld).all())

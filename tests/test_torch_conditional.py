"""The conditional-flow path of the PyTorch port (``repro_torch``) against the
JAX reference (``repro``): HINT couplings, cHINT chains, ``ConditionalFlow``
and its supervised training.

Inputs and parameters come from the reference's conformance registry
(``tests/conformance.py``: the same cases, examples and perturbed trees) or
from the reference's ``init``, perturbed with numpy noise, carried into the
port by ``repro_torch.bridge``.  The reference runs on its CPU path (its
Pallas kernels in interpret mode where a case turns them on); the port takes
each kernel's plain version on the CPU.

Tolerances are the registry's: 1e-4 absolute per element for forward
outputs, round trips and every gradient leaf (``GRAD_PARITY_TOL``), 1e-3 for
a logdet against the log |det| of the Jacobian (``LOGDET_TOL``); losses to
1e-5 absolute, as ``test_builder_grad_parity`` holds them; the 8-step loss
curve to 1e-4 relative and the trained parameters to rtol 1e-3 with atol
1e-4, as ``test_torch_train.py`` holds ``train_flow``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from conformance import (
    CASES_BY_NAME,
    CHAIN_BUILDERS,
    GRAD_PARITY_TOL,
    LOGDET_TOL,
    ROUNDTRIP_TOL,
    perturb,
)
from repro.config import TrainConfig as JTrainConfig
from repro.core import ConditionalFlow as JConditionalFlow
from repro.core import InvertibleChain as JInvertibleChain
from repro.core import SummaryMLP as JSummaryMLP
from repro.core import build_chint as j_build_chint
from repro.core import value_and_grad_nll as j_value_and_grad_nll
from repro.data.synthetic import SyntheticInverseProblem as JSyntheticInverseProblem
from repro.train.loop import train_conditional_flow as j_train_conditional_flow
from repro_torch.bridge import params_from_numpy, tree_paths, tree_to_numpy
from repro_torch.config import TrainConfig
from repro_torch.configs import flows as flow_configs
from repro_torch.core import (
    ActNorm,
    AffineCoupling,
    ConditionalFlow,
    Conv1x1,
    HINTCoupling,
    InvertibleChain,
    SummaryMLP,
    amortized_vi_loss,
    build_chint,
    flatten_state,
    value_and_grad_nll,
)
from repro_torch.data.synthetic import SyntheticInverseProblem
from repro_torch.nn.nets import CouplingMLP
from repro_torch.train.loop import train_conditional_flow, train_flow

torch.set_num_threads(2)

RNG = jax.random.PRNGKey(20260728)  # the reference's conformance key
SEED = 20261017
MODES = ("autodiff", "invertible", "coupled")


def _np(tree):
    return jax.tree_util.tree_map(lambda v: None if v is None else np.asarray(v), tree,
                                  is_leaf=lambda v: v is None)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def mlp(d_in, d_out):
    """The registry's ``mlp_factory`` (hidden 16, one hidden layer)."""
    return CouplingMLP(d_in, d_out, hidden=16, depth=1, device="cpu")


def _affine(c, flip=False, d_cond=0, **kw):
    ca = c - c // 2 if flip else c // 2
    return AffineCoupling(CouplingMLP(c - ca, 2 * ca, hidden=16, depth=1, d_cond=d_cond,
                                      device="cpu"), flip=flip, **kw)


#: the registry's cases the port builds: name -> (port layer from (c, d_cond))
PORT_CASES = {
    "actnorm-dense": lambda c, d: ActNorm(c, device="cpu"),
    "conv1x1-dense": lambda c, d: Conv1x1(c, device="cpu"),
    "affine-mlp": lambda c, d: _affine(c),
    "affine-mlp-flip": lambda c, d: _affine(c, flip=True),
    "affine-conditional": lambda c, d: _affine(c, d_cond=d),
    "hint-depth0": lambda c, d: HINTCoupling(mlp, c, d, depth=0),
    "hint-depth1": lambda c, d: HINTCoupling(mlp, c, d, depth=1),
    "hint-depth2": lambda c, d: HINTCoupling(mlp, c, d, depth=2),
    "hint-depth3": lambda c, d: HINTCoupling(mlp, c, d, depth=3),
    "hint-tiny-identity": lambda c, d: HINTCoupling(mlp, c, d, depth=2),
    "hint-conditional": lambda c, d: HINTCoupling(mlp, c, d, depth=2),
    "hint-kernel": lambda c, d: HINTCoupling(mlp, c, d, depth=2, kernel_inverse=True),
}


def make_case(name):
    """(reference layer, its params, port layer, x, cond) of a registry case,
    the port holding the reference's perturbed parameters."""
    case = CASES_BY_NAME[name]
    jlayer, params, x, cond = case.make(RNG)
    d_cond = 0 if cond is None else cond.shape[-1]
    layer = PORT_CASES[name](x.shape[-1], d_cond)
    params_from_numpy(layer, _np(params))
    return jlayer, params, layer, np.asarray(x), None if cond is None else np.asarray(cond)


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_forward_and_round_trip(name):
    jlayer, params, layer, x, cond = make_case(name)
    jy, jld = jlayer.forward(params, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        y, ld = layer(_t(x), _t(cond))
        back = layer.inverse(y, _t(cond))
    _close(y, jy, 1e-4)
    _close(ld, jld, 1e-4)
    assert ld.shape == (x.shape[0],) and ld.dtype == torch.float32
    _close(back, x, ROUNDTRIP_TOL)


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_logdet_matches_jacobian(name):
    """The logdet against log |det| of the flattened forward's Jacobian
    (batch-1 examples, so the Jacobian is the sample's), the registry's
    check with ``torch.autograd.functional.jacobian``."""
    _, _, layer, x, cond = make_case(name)
    c = _t(cond)
    jac = torch.autograd.functional.jacobian(
        lambda v: layer(v.reshape(x.shape), c)[0].reshape(-1), _t(x).reshape(-1))
    _, ref = np.linalg.slogdet(jac.double().numpy())
    with torch.no_grad():
        _, ld = layer(_t(x), c)
    np.testing.assert_allclose(float(ld.sum()), ref, rtol=LOGDET_TOL, atol=LOGDET_TOL)


def _j_grads(jlayer, params, x, cond, mode, wz):
    chain = JInvertibleChain([jlayer], grad_mode=mode)

    def loss(p, x_, c_):
        z, ld = chain.forward((p,), x_, c_)
        return jnp.sum(ravel_pytree(z)[0] * wz) - jnp.sum(ld)

    argnums = (0, 1) if cond is None else (0, 1, 2)
    return jax.grad(loss, argnums=argnums, allow_int=True)(
        params, jnp.asarray(x), None if cond is None else jnp.asarray(cond))


def _port_grads(layer, x, cond, mode, wz):
    chain = InvertibleChain([layer], grad_mode=mode)
    xt = _t(x).requires_grad_()
    ct = None if cond is None else _t(cond).requires_grad_()
    z, ld = chain(xt, ct)
    loss = torch.sum(flatten_state(z).reshape(-1) * torch.from_numpy(wz)) - torch.sum(ld)
    named = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [*named.values(), xt, *([ct] if ct is not None else [])])
    return dict(zip(named, grads[:len(named)])), grads[len(named)], (
        grads[-1] if ct is not None else None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_case_grad_parity(name, mode):
    """Parameters', input's and condition's cotangents in each engine
    against the reference's in the same engine, and against the port's
    plain autograd, within ``GRAD_PARITY_TOL``."""
    jlayer, params, layer, x, cond = make_case(name)
    wz = np.random.default_rng(SEED).standard_normal(x.size).astype(np.float32)
    jg = _j_grads(jlayer, params, x, cond, mode, wz)
    gp, gx, gc = _port_grads(layer, x, cond, mode, wz)
    gp_ad, gx_ad, gc_ad = _port_grads(layer, x, cond, "autodiff", wz)
    ref = tree_paths(layer, _np(jg[0]))
    for key, g in gp.items():
        _close(g, ref[key], GRAD_PARITY_TOL)
        _close(g, gp_ad[key], GRAD_PARITY_TOL)
    _close(gx, jg[1], GRAD_PARITY_TOL)
    _close(gx, gx_ad, GRAD_PARITY_TOL)
    if cond is not None:
        _close(gc, jg[2], GRAD_PARITY_TOL)
        _close(gc, gc_ad, GRAD_PARITY_TOL)


@pytest.mark.parametrize("scale", ["glorot", "he", "lecun", 0.3, "zeros"])
def test_dense_matches_reference(scale):
    """``dense_init``'s layout and scale (the draws differ: the moments are
    held, over 512 x 512 weights), and ``dense_apply`` / ``Dense`` on the
    reference's parameters."""
    from repro.nn.linear import dense_apply as j_dense_apply
    from repro.nn.linear import dense_init as j_dense_init
    from repro_torch.nn.linear import Dense, dense_apply, dense_init

    jp = j_dense_init(jax.random.PRNGKey(0), 512, 512, scale=scale)
    p = dense_init(torch.Generator().manual_seed(0), 512, 512, scale=scale)
    assert {k: v.shape for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    np.testing.assert_allclose(float(p["w"].std()), float(jnp.std(jp["w"])), rtol=0.02)
    assert not bool(p["b"].any())
    layer = Dense(512, 7, device="cpu")
    params = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (512, 7))),
              "b": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (7,)))}
    params_from_numpy(layer, params)
    x = np.random.default_rng(SEED).standard_normal((3, 512)).astype(np.float32)
    ref = j_dense_apply(params, jnp.asarray(x))
    _close(layer(_t(x)), ref, 1e-4)
    _close(dense_apply({k: _t(v) for k, v in params.items()}, _t(x)), ref, 1e-4)


# ---------------------------------------------------------------------------
# the chint builder of the registry (depth 2, recursion 2, hidden 16, (4, 8))
# ---------------------------------------------------------------------------


def _chint_pair(mode):
    build, example = CHAIN_BUILDERS["chint"]
    x = example(RNG)
    params = perturb(build("autodiff").init(RNG, x), jax.random.fold_in(RNG, 5), 0.05)
    flow = build_chint(8, 0, depth=2, recursion=2, hidden=16, grad_mode=mode, device="cpu")
    return build, params, params_from_numpy(flow, _np(params)), np.asarray(x)


@pytest.mark.parametrize("mode", MODES)
def test_chint_builder_grad_parity(mode):
    build, params, flow, x = _chint_pair(mode)
    jl, jg = j_value_and_grad_nll(build(mode).forward, params, jnp.asarray(x))
    loss, grads = value_and_grad_nll(flow, _t(x))
    assert abs(float(loss) - float(jl)) < 1e-5
    ref = tree_paths(flow, _np(jg))
    for key, g in grads.items():
        _close(g, ref[key], GRAD_PARITY_TOL)


def test_chint_builder_fused_path_engages():
    """Under ``coupled`` every layer's ``fused_bwd`` runs exactly once a
    backward, and each HINT block's recursion stays inside its own hook."""
    _, _, flow, x = _chint_pair("coupled")
    counts = [0] * len(flow.layers)
    for i, layer in enumerate(flow.layers):
        orig = layer.fused_bwd

        def counted(*a, _i=i, _orig=orig, **kw):
            counts[_i] += 1
            return _orig(*a, **kw)

        layer.fused_bwd = counted
    value_and_grad_nll(flow, _t(x))
    assert counts == [1] * len(flow.layers)


@pytest.mark.parametrize("mode,calls_per_node", [("invertible", 3), ("coupled", 2)])
def test_hint_conditioner_eval_count(mode, calls_per_node):
    """The coupled backward evaluates each cross conditioner once (with the
    forward, 2 a node); invert-then-VJP twice (3 a node)."""
    counter = [0]

    def counting(d_in, d_out):
        net = CouplingMLP(d_in, d_out, hidden=8, depth=1, device="cpu")
        net.register_forward_pre_hook(lambda *_: counter.__setitem__(0, counter[0] + 1))
        return net

    layer = HINTCoupling(counting, 8, depth=2)
    n_nodes = sum(1 for m in layer.modules() if isinstance(m, HINTCoupling) and not m.is_leaf)
    assert n_nodes == 3  # c = 8, depth 2: the root and two c = 4 children
    torch.manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    counter[0] = 0
    value_and_grad_nll(InvertibleChain([layer], grad_mode=mode), torch.randn(4, 8))
    assert counter[0] == calls_per_node * n_nodes


# ---------------------------------------------------------------------------
# ConditionalFlow
# ---------------------------------------------------------------------------

D_THETA, D_Y, D_SUM = 8, 12, 6


def _cflow_pair(mode, seed=SEED):
    """(reference model, its perturbed params, port model, theta, y)."""
    jmodel = JConditionalFlow(
        j_build_chint(depth=2, recursion=2, hidden=16, grad_mode=mode), JSummaryMLP(D_SUM, 16),
        sample_flow=j_build_chint(depth=2, recursion=2, hidden=16, kernel_inverse=True))
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((5, D_THETA)).astype(np.float32)
    y = rng.standard_normal((5, D_Y)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(seed % 1000), jnp.asarray(theta), jnp.asarray(y))
    params = perturb(params, jax.random.PRNGKey(seed % 1000 + 1), 0.1)
    model = ConditionalFlow(
        build_chint(D_THETA, D_SUM, depth=2, recursion=2, hidden=16, grad_mode=mode,
                    device="cpu"),
        SummaryMLP(D_Y, D_SUM, 16, device="cpu"),
        sample_flow=build_chint(D_THETA, D_SUM, depth=2, recursion=2, hidden=16,
                                kernel_inverse=True, device="cpu"), device="cpu")
    params_from_numpy(model, _np(params))
    return jmodel, params, model, theta, y


def test_conditional_flow_bridge_round_trip():
    _, params, model, _, _ = _cflow_pair("coupled")
    back = tree_paths(model, tree_to_numpy(model, like=_np(params)))
    for key, v in tree_paths(model, _np(params)).items():
        np.testing.assert_array_equal(back[key], v)
    assert params["flow"][2]["a"]["a"] == {"leaf": None}
    assert set(model.state_dict()) == set(back)


@pytest.mark.parametrize("mode", MODES)
def test_conditional_flow_log_prob_loss_and_grads(mode):
    jmodel, params, model, theta, y = _cflow_pair(mode)
    jlp = jmodel.log_prob(params, jnp.asarray(theta), jnp.asarray(y))
    with torch.no_grad():
        lp = model.log_prob(theta, y)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
    jl, jg = jax.value_and_grad(jmodel.loss, allow_int=True)(params, jnp.asarray(theta), jnp.asarray(y))
    loss = model.loss(theta, y)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(loss.item() - float(jl)) < 1e-5
    ref = tree_paths(model, _np(jg))
    assert any(k.startswith("summary.") for k in grads)
    for key, g in grads.items():
        _close(g, ref[key], GRAD_PARITY_TOL)
    # the functional objective is the same loss
    vi = amortized_vi_loss(model.flow, torch.from_numpy(theta), torch.from_numpy(y),
                           model.summary)
    assert vi.item() == loss.item()


def test_kernel_inverse_twin_matches_reference():
    """The sampling twin's inverse (the coupling inverse op on each cross
    node) against the reference's twin (its Pallas inverse in interpret
    mode) for the same z and cond."""
    jmodel, params, model, _, y = _cflow_pair("coupled")
    rng = np.random.default_rng(SEED + 1)
    z = rng.standard_normal((7, D_THETA)).astype(np.float32)
    jcond = jmodel._cond(params, jnp.asarray(y[:1].repeat(7, 0)))
    jx = jmodel.sample_flow.inverse(params["flow"], jnp.asarray(z), jcond)
    with torch.no_grad():
        cond = model._cond(y[:1].repeat(7, 0))
        x = model.sample_flow.inverse(torch.from_numpy(z), cond)
        x_plain = model.flow.inverse(torch.from_numpy(z), cond)
        z_back, _ = model.flow(x, cond)
    assert all(m.kernel_inverse for m in model.sample_flow.modules() if isinstance(m, HINTCoupling))
    _close(x, jx, 1e-4)
    _close(x, x_plain, 1e-4)
    _close(z_back, z, ROUNDTRIP_TOL)


def test_posterior_sampler_streams():
    """``draw(g, n)`` equals ``sample(g, y, n)`` bit for bit, repeats for the
    same seed, and ``sample_like`` takes another stream."""
    _, _, model, _, y = _cflow_pair("coupled")
    draw = model.posterior_sampler(y[:2], theta_dim=D_THETA)
    a = draw(torch.Generator().manual_seed(3), 4)
    b = model.sample(torch.Generator().manual_seed(3), y[:2], 4, D_THETA)
    assert a.shape == (8, D_THETA) and torch.equal(a, b)
    assert not torch.equal(a, draw(torch.Generator().manual_seed(4), 4))
    like = model.sample_like(torch.Generator().manual_seed(3), y[:2],
                             torch.empty(2, D_THETA, device="meta"))
    assert like.shape == (2, D_THETA) and not torch.equal(like, a[::4])


def test_sample_flow_must_mirror_flow():
    flow = build_chint(D_THETA, 0, depth=2, hidden=8, device="cpu")
    with pytest.raises(ValueError):
        ConditionalFlow(flow, sample_flow=build_chint(D_THETA, 0, depth=1, hidden=8, device="cpu"),
                        device="cpu")


def test_twin_shares_the_trained_parameters():
    _, _, model, _, _ = _cflow_pair("coupled")
    p = next(model.flow.parameters())
    with torch.no_grad():
        p.add_(1.0)
    assert next(model.sample_flow.parameters()) is p
    twin_buffers = dict(model.sample_flow.named_buffers())
    for name, b in model.flow.named_buffers():
        assert twin_buffers[name] is b


# ---------------------------------------------------------------------------
# configurations, devices, data
# ---------------------------------------------------------------------------


def test_build_flow_builds_chint():
    assert not hasattr(flow_configs, "_NOT_PORTED")  # every kind of the reference builds
    for cfg in (flow_configs.CHINT_COUPLED, flow_configs.CHINT_POSTERIOR):
        flow = flow_configs.build_flow(cfg, device="cpu")
        assert flow.grad_mode == cfg.grad_mode and len(flow.layers) == 3 * cfg.depth
        hint = flow.layers[2]
        assert not hint.kernel_inverse  # the sampling twin's option, off in training
        # d_theta 32: the root cross node (cb = 16) and two c = 16 children
        # (cb = 8) whose c = 8 children are identity leaves
        crosses = [m.cross for m in hint.modules() if isinstance(m, HINTCoupling)
                   and not m.is_leaf]
        assert [c.layers[-1].w.shape[1] for c in crosses] == [32, 16, 16]
        assert crosses[0].layers[0].w.shape == (16 + 64, cfg.hidden)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_refuse_the_cpu_unless_named():
    flow = build_chint(4, 0, depth=1, hidden=4, device="cpu")
    data = SyntheticInverseProblem(4, 4, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_chint(4, 0, depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConditionalFlow(flow)
    model = ConditionalFlow(flow, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_conditional_flow(model, data, TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_flow(flow, data, TrainConfig(steps=1))


def test_synthetic_inverse_problem_is_step_indexed_with_its_posterior():
    data = SyntheticInverseProblem(d_theta=4, d_y=6, sigma=0.5, batch=8, seed=2)
    a, b = data.batch_at(3), data.batch_at(3)
    assert a["theta"].shape == (8, 4) and a["y"].shape == (8, 6)
    assert a["theta"].dtype == a["y"].dtype == torch.float32
    assert torch.equal(a["theta"], b["theta"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["theta"], data.batch_at(4)["theta"])
    # the posterior against the reference's formula on the same A and y
    ref = JSyntheticInverseProblem(d_theta=4, d_y=6, sigma=0.5)
    ref.a_mat = jnp.asarray(data.a_mat.numpy())
    y = a["y"][0]
    mu, cov = data.posterior(y)
    jmu, jcov = ref.posterior(jnp.asarray(y.numpy()))
    assert mu.dtype == cov.dtype == torch.float64
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# train_conditional_flow against the reference's
# ---------------------------------------------------------------------------


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def test_train_conditional_flow_loss_curve_matches_reference(tmp_path):
    steps, seed = 8, 3
    rng = np.random.default_rng(seed)
    a_mat = rng.standard_normal((D_THETA, D_Y)).astype(np.float32) / np.sqrt(D_THETA)
    batches = []
    for _ in range(steps):
        theta = rng.standard_normal((16, D_THETA)).astype(np.float32)
        y = (theta @ a_mat + 0.3 * rng.standard_normal((16, D_Y))).astype(np.float32)
        batches.append({"theta": theta, "y": y})
    cfg = dict(steps=steps, lr=1e-2, warmup_steps=2)
    jmodel = JConditionalFlow(j_build_chint(depth=2, recursion=2, hidden=16, grad_mode="coupled"),
                              JSummaryMLP(D_SUM, 16))
    jres = j_train_conditional_flow(
        jmodel, _Batches([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
        JTrainConfig(**cfg, seed=seed, prefetch=0, checkpoint_dir=str(tmp_path / "ck")))
    tree = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(batches[0]["theta"]),
                           jnp.asarray(batches[0]["y"])))
    model = ConditionalFlow(
        build_chint(D_THETA, D_SUM, depth=2, recursion=2, hidden=16, grad_mode="coupled",
                    device="cpu"), SummaryMLP(D_Y, D_SUM, 16, device="cpu"), device="cpu")
    params_from_numpy(model, tree)
    res = train_conditional_flow(model, _Batches(batches), TrainConfig(**cfg), device="cpu")
    assert res.final_step == jres.final_step == steps - 1 and len(res.losses) == steps
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)
    trained = tree_paths(model, tree_to_numpy(model, like=tree))
    ref = tree_paths(model, _np(jres.params))
    for key, v in trained.items():
        np.testing.assert_allclose(v, ref[key], rtol=1e-3, atol=1e-4, err_msg=key)

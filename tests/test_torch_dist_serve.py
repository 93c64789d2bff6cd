"""Batch-sharded serving on two ``gloo`` ranks
(``tests/torch_dist_workers.py``): each rank runs its rows and every rank
gets the whole batch back.

* ``FlowServeEngine(mesh=...)`` on the scanned GLOW (2 scales x 2 steps,
  hidden 8): ``log_prob`` against the reference's ``FlowServeEngine`` and
  ``sample`` against the reference's inverse of the same latent draws (the
  port's generator's) and the one-process engine's, each within 1e-4 of
  scale;
* a cHINT ``ConditionalFlow(mesh=...)``: ``log_prob`` against the
  reference's, posterior draws against the reference's sampling twin on the
  same z and cond, and ``PosteriorEngine``'s streamed mean and std against
  the one-process engine's (the mesh-parity invariant), within 1e-4;
* both launchers with ``--mesh 2,1`` on the ``lg-smoke`` scenario.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conformance import perturb
from repro.core import ConditionalFlow as JConditionalFlow
from repro.core import SummaryMLP as JSummaryMLP
from repro.core import build_chint as j_build_chint
from repro.serve.engine import FlowServeEngine as JFlowServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core import derive_key, std_normal_sample
from repro_torch.serve.engine import FlowServeEngine
from repro_torch.uq.posterior import PosteriorEngine
from torch_dist_workers import conditional, scenario_launcher, serve_flow, spawn
from torch_parity import SEED, make_pair

torch.set_num_threads(1)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
SHAPE = (4, 8, 8, 3)
TOL = 1e-4


def _close_scaled(a, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(a, np.float32) - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1.0), err


def test_sharded_flow_serving_matches_the_reference(tmp_path):
    jflow, jparams, flow, tree = make_pair(SMALL, SHAPE)
    x = np.random.default_rng(8).uniform(-0.5, 0.5, SHAPE).astype(np.float32)
    outs = spawn(serve_flow, 2, tmp_path, dict(SMALL, grad_mode="coupled"),
                 jax.tree_util.tree_map(np.asarray, tree), x, 11)
    j_lp = JFlowServeEngine(jflow, jparams).log_prob(jnp.asarray(x))
    # the latent draws the engine makes, at the whole batch's extent
    with torch.no_grad():
        z_like, _ = flow(torch.from_numpy(x))
    like = tuple(torch.empty_like(v, device="meta") for v in z_like)
    z = std_normal_sample(derive_key(torch.Generator().manual_seed(11), 0, "cpu"), like)
    j_x = jflow.inverse(jparams, tuple(jnp.asarray(v.numpy()) for v in z))
    one = FlowServeEngine(flow, device="cpu").sample(torch.Generator().manual_seed(11), like)
    for out in outs:
        _close_scaled(out["log_prob"], j_lp)
        _close_scaled(out["samples"], j_x)
        # the same draws as one process (not bit for bit: the CPU's
        # convolutions block by thread count, which differs between processes)
        _close_scaled(out["samples"], one.numpy())
    assert np.array_equal(outs[0]["log_prob"], outs[1]["log_prob"])


D_THETA, D_Y, D_SUM = 8, 12, 6
MODEL_KW = dict(d_theta=D_THETA, d_y=D_Y, d_summary=D_SUM, depth=2, hidden=16)


def _cflow_pair(seed=SEED):
    jmodel = JConditionalFlow(
        j_build_chint(depth=2, recursion=2, hidden=16, grad_mode="coupled"),
        JSummaryMLP(D_SUM, 16),
        sample_flow=j_build_chint(depth=2, recursion=2, hidden=16, kernel_inverse=True))
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((6, D_THETA)).astype(np.float32)
    y = rng.standard_normal((6, D_Y)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(seed % 1000), jnp.asarray(theta), jnp.asarray(y))
    params = perturb(params, jax.random.PRNGKey(seed % 1000 + 1), 0.1)
    return jmodel, params, theta, y


def test_sharded_conditional_flow_and_posterior_statistics(tmp_path):
    jmodel, params, theta, y = _cflow_pair()
    from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint

    kw = dict(depth=2, recursion=2, hidden=16, device="cpu")
    model = ConditionalFlow(build_chint(D_THETA, D_SUM, grad_mode="coupled", **kw),
                            SummaryMLP(D_Y, D_SUM, 16, device="cpu"),
                            sample_flow=build_chint(D_THETA, D_SUM, kernel_inverse=True, **kw),
                            device="cpu")
    params_from_numpy(model, jax.tree_util.tree_map(np.asarray, params))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    y_obs = y[:1]
    stats_kw = dict(n_samples=64, chunk=16)
    outs = spawn(conditional, 2, tmp_path, MODEL_KW, state, theta, y, y_obs, 21, 6, stats_kw)
    j_lp = jmodel.log_prob(params, jnp.asarray(theta), jnp.asarray(y))
    # the reference's twin on the draws' own z and cond
    with torch.no_grad():
        cond = model._cond(torch.from_numpy(y_obs)).repeat_interleave(6, dim=0)
    z = std_normal_sample(derive_key(torch.Generator().manual_seed(21), 0, "cpu"),
                          torch.empty((6, D_THETA), device="meta"))
    jcond = jmodel._cond(params, jnp.asarray(np.repeat(y_obs, 6, axis=0)))
    j_draws = jmodel.sample_flow.inverse(params["flow"], jnp.asarray(z.numpy()), jcond)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), rtol=0, atol=1e-5)
    one = PosteriorEngine(model, y=torch.from_numpy(y_obs), theta_dim=D_THETA).run(
        torch.Generator().manual_seed(22), **stats_kw)
    for out in outs:
        _close_scaled(out["log_prob"], j_lp)
        _close_scaled(out["draws"], j_draws)
        assert out["n"] == one.n == 64
        np.testing.assert_allclose(out["mean"], one.mean, rtol=0, atol=TOL)
        np.testing.assert_allclose(out["std"], one.std, rtol=0, atol=TOL)


def test_scenario_launchers_on_a_two_rank_mesh(tmp_path):
    outs = spawn(scenario_launcher, 2, tmp_path / "run", str(tmp_path / "ck"))
    for rank, out in enumerate(outs):
        assert f"mesh=2x1 backend=gloo rank={rank}/2" in out, out
        assert "scenario=lg-smoke (amortized posterior)" in out and "done at step 3" in out
        assert "posterior stats over n=1024 draws" in out, out

"""Shared helpers of the GLOW parity tests (``test_torch_glow*.py``,
``test_torch_engines*.py``): one perturbed parameter tree of the JAX
reference, loaded into both packages, and the per-leaf gradient
comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro_torch.bridge import params_from_numpy, tree_paths, tree_to_numpy
from repro_torch.core import build_glow_scanned

SEED = 20261017


def perturbed(tree, rng, scale=0.05, stacked=True):
    """Every float leaf of a tree plus noise of standard deviation
    ``scale / sqrt(fan_in)``, ``fan_in`` the product of the axes before the
    output axis (1 for per-channel vectors), after the leading k axis of a
    stacked (k, ...) tree."""
    lead = 1 if stacked else 0

    def bump(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            std = scale / np.sqrt(np.prod(a.shape[lead:-1]))
            return (a + std * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(bump, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def as_np(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def close(a, b, atol=1e-4):
    np.testing.assert_allclose(as_np(a), as_np(b), rtol=0, atol=atol)


def make_pair(cfg: dict, x_shape, seed=SEED):
    """(jax flow, jax params, port flow, numpy tree): one perturbed tree of
    the reference's init, loaded into both."""
    jflow = j_build_glow_scanned(**cfg, grad_mode="coupled")
    tree = jflow.init(jax.random.PRNGKey(seed % 1000), jnp.zeros(x_shape, jnp.float32))
    tree = perturbed(tree, np.random.default_rng(seed))
    flow = build_glow_scanned(**cfg, grad_mode="coupled", channels=x_shape[-1], device="cpu")
    return jflow, to_jax(tree), params_from_numpy(flow, tree), tree


def grad_errors(flow, tree, grads, jgrads) -> dict:
    """Max absolute difference of each float gradient leaf of the port
    (``{name: grad}``) and the reference (a tree like ``tree``), by state key."""
    port = tree_paths(flow, tree_to_numpy(flow, like=tree, values=grads))
    ref = tree_paths(flow, jgrads)
    return {k: float(np.abs(port[k] - np.asarray(ref[k], np.float32)).max())
            for k, v in port.items() if np.issubdtype(v.dtype, np.floating)}

"""Shared helpers of the LM parity tests (``test_torch_lm_dense.py``,
``test_torch_moe.py``, ``test_torch_lm_train.py``,
``test_torch_lm_frontends.py``, ``test_torch_ssm_train.py``): one perturbed
parameter tree of the reference's ``init`` at an architecture's
``REDUCED`` width, loaded into both packages; the reference's and the
port's ``train_loss`` with its gradient; and the per-leaf comparison."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.lm import Model as JModel
from repro_torch.bridge import params_from_numpy, tree_paths, tree_to_numpy
from repro_torch.models import Model

SEED = 20261017
#: the ported architectures and their config modules' names
MODULES = {
    "yi-6b": "yi_6b", "glm4-9b": "glm4_9b", "granite-34b": "granite_34b",
    "command-r-plus-104b": "command_r_plus_104b", "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b", "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b", "whisper-small": "whisper_small", "llava-next-34b": "llava_next_34b",
}


def configs(arch: str):
    """(reference config module, port config module)."""
    name = MODULES[arch]
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


def perturbed(tree, rng, scale=0.1):
    """Every float leaf drawn as a constant by ``init`` (norms, biases, the
    SSM's lerp weights and decays) plus noise of standard deviation
    ``scale``, so each entry of it is distinct; the random leaves stay."""
    def bump(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating) and a.size > 1 and float(a.std()) == 0.0:
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(bump, tree)


def make_pair(arch: str, seed=SEED, **overrides):
    """(jax model, jax params, port model, numpy tree) at ``arch``'s
    ``REDUCED`` width with ``overrides`` applied to both configs."""
    jmod, pmod = configs(arch)
    jm = JModel(jmod.REDUCED.replace(**overrides))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed % 997)))
    tree = perturbed(tree, np.random.default_rng(seed))
    m = Model(pmod.REDUCED.replace(**overrides), device="cpu")
    params_from_numpy(m, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), m, tree


def token_batch(vocab: int, batch: int, seq: int, seed=SEED) -> dict:
    """``{"tokens", "labels"}`` (batch, seq) int32 numpy arrays, labels the
    tokens shifted by one."""
    seq_ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": seq_ids[:, :-1], "labels": seq_ids[:, 1:]}


def ref_loss_grad(jm, jp, batch: dict, mode: str):
    """The reference's ``(loss, grads)`` of ``train_loss`` under ``mode``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(lambda p: jm.train_loss(p, jb, grad_mode=mode)[0]))
    loss, grads = fn(jp)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def port_loss_grad(m: Model, batch: dict, mode: str):
    """The port's ``(loss, {name: grad})`` of ``train_loss`` under ``mode``."""
    named = dict(m.named_parameters())
    loss, _ = m.train_loss({k: torch.from_numpy(v) for k, v in batch.items()}, grad_mode=mode)
    # an unused leaf (whisper's cross-attention biases) gets None: zero, as in the reference
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.item(), {n: g if g is not None else torch.zeros_like(p)
                         for (n, p), g in zip(named.items(), grads)}


def leaf_errors(m: Model, tree, grads: dict, ref) -> dict:
    """Each gradient leaf's ``max |port - ref| / max |ref|`` by state key;
    ``ref`` is a tree like ``tree`` or another ``{name: grad}`` dict."""
    port = tree_paths(m, tree_to_numpy(m, like=tree, values=grads))
    if isinstance(ref, dict) and all(isinstance(v, torch.Tensor) for v in ref.values()):
        ref = tree_to_numpy(m, like=tree, values=ref)
    ref = tree_paths(m, ref)
    out = {}
    for k, v in port.items():
        r = np.asarray(ref[k], np.float32)
        scale = float(np.abs(r).max())
        out[k] = float(np.abs(v - r).max()) / (scale if scale > 0 else 1.0)
    return out

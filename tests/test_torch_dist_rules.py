"""The port's four model-axis rules (``dist/sharding.py``: ``params_pspecs``,
``layer_slice_pspecs``, ``opt_pspecs``, ``cache_pspecs``) against the
reference's, entry for entry, on the same shape trees: the parameters of
the scanned GLOW at test size, of granite-moe-1b-a400m ``REDUCED`` and of
the whole granite-moe-1b-a400m (its odd vocabulary, 49155, leaves the
embedding's ``d_model`` axis to split), their AdamW states and the served
caches of both granite widths.  The meshes are (1, 2), (2, 2), (4, 2) and
the (2, 2, 2) multi-pod layout, each rule with its flag off and on.  The
reference reads only ``mesh.shape[name]`` and ``mesh.axis_names``, so a
stand-in object is its mesh and no JAX device is forced; the port's mesh is
a ``launch.mesh.MeshSpec``."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import granite_moe_1b_a400m as jgranite
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro.dist import sharding as jsh
from repro.models.lm import Model as JModel
from repro.optim import adamw_init as j_adamw_init
from repro_torch.dist import sharding as psh
from repro_torch.launch.mesh import MeshSpec

MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
RULES = ("params", "params_fsdp", "layer_slice", "opt", "opt_zero1", "cache",
         "cache_seq_fallback")


def _meshes(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes), MeshSpec(shape, axes)


def _shapes(fn, *args):
    return jax.eval_shape(fn, *args)


def _trees():
    """``{name: (params, caches or None)}`` shape trees."""
    jflow = j_build_glow_scanned(n_scales=2, k_steps=2, hidden=8, grad_mode="coupled")
    x = jax.ShapeDtypeStruct((4, 8, 8, 3), jnp.float32)
    out = {"glow_scanned": (_shapes(lambda: jflow.init(jax.random.PRNGKey(0),
                                                       jnp.zeros(x.shape, x.dtype))), None)}
    for name, cfg in (("granite_reduced", jgranite.REDUCED), ("granite", jgranite.CONFIG)):
        jm = JModel(cfg)
        out[name] = (_shapes(jm.init, jax.random.PRNGKey(0)),
                     _shapes(lambda jm=jm: jm.make_caches(8, 528)))
    return out


TREES = _trees()


def _ref(tree):
    """A reference spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda v: isinstance(v, PartitionSpec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rule", RULES)
def test_rules_match_the_reference_entry_for_entry(rule, mesh_name):
    jmesh, pmesh = _meshes(mesh_name)
    n_split = 0
    for name, (params, caches) in TREES.items():
        if rule in ("params", "params_fsdp"):
            fsdp = rule == "params_fsdp"
            ref = _ref(jsh.params_pspecs(params, jmesh, fsdp=fsdp))
            port = psh.params_pspecs(params, pmesh, fsdp=fsdp)
        elif rule == "layer_slice":
            stacked = params["blocks"] if isinstance(params, dict) else [
                p for p in params if p is not None]
            ref = _ref(jsh.layer_slice_pspecs(stacked, jmesh))
            port = psh.layer_slice_pspecs(stacked, pmesh)
        elif rule in ("opt", "opt_zero1"):
            zero1 = rule == "opt_zero1"
            opt = _shapes(j_adamw_init, params)
            ref = _ref(jsh.opt_pspecs(opt, jsh.params_pspecs(params, jmesh), jmesh, zero1=zero1))
            port = psh.opt_pspecs(opt, psh.params_pspecs(params, pmesh), pmesh, zero1=zero1)
        else:
            if caches is None:
                continue
            fallback = rule == "cache_seq_fallback"
            ref = _ref(jsh.cache_pspecs(caches, jmesh, seq_fallback_model=fallback))
            port = psh.cache_pspecs(caches, pmesh, seq_fallback_model=fallback)
        assert port == ref, name
        n_split += sum(bool(s) for s in jax.tree_util.tree_leaves(
            port, is_leaf=lambda v: isinstance(v, tuple)))
    if not (rule == "cache" and mesh_name == "1x2"):  # one data rank splits no cache
        assert n_split > 0


def test_odd_vocabulary_splits_the_model_width():
    """granite-moe-1b-a400m's embedding (49155, 1024): 49155 is odd, so the
    model axis takes ``d_model``, as in the reference; the MoE experts
    (layer-stacked) never split their stack axis."""
    params, _ = TREES["granite"]
    for mesh_name in MESHES:
        jmesh, pmesh = _meshes(mesh_name)
        port = psh.params_pspecs(params, pmesh)
        assert port["embed"] == (None, "model") == tuple(jsh.params_pspecs(params, jmesh)["embed"])
        experts = port["blocks"]["moe"]["moe"]["experts"]
        assert all(s[0] is None for s in experts.values())


def test_local_shard_round_trips_through_the_blocks():
    """``local_shard`` over every rank of a (2, 2) mesh tiles the leaf (the
    stand-in ranks' blocks put back in rank order give the leaf)."""
    leaf = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    spec = ("data", None, "model")

    class Rank:
        shape, mesh_dim_names = (2, 2), ("data", "model")

        def __init__(self, d, m):
            self.idx = {"data": d, "model": m}

        def get_local_rank(self, a):
            return self.idx[a]

    import torch

    t = torch.from_numpy(leaf)
    rows = [torch.cat([psh.local_shard(t, spec, Rank(d, m)) for m in range(2)], dim=2)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), t)
    assert tuple(psh.local_shard(t, spec, Rank(1, 1)).shape) == (2, 6, 4)

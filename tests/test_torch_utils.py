"""The port's tree and cost utilities (``repro_torch/utils``) against the
reference's ``repro/utils``: tree counts, bytes, casts and norms on the
same numpy tree; the cost counter's flops for a product and for a loop
(``tests/test_hlo_walker.py`` asks the same of the HLO walker), and the
walker's dot flops of the same graph, in a subprocess; trip scaling; and
``dist/comm.py``'s dry route."""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils import tree as jtree
from repro_torch import utils
from repro_torch.dist import comm
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils import cost, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trees():
    rng = np.random.default_rng(4)
    np_tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b": [rng.standard_normal((7,)).astype(np.float32),
                     np.arange(6, dtype=np.int32).reshape(2, 3)],
               "c": {"d": rng.standard_normal((2, 2, 2)).astype(np.float32)}}
    jt = {"a": jnp.asarray(np_tree["a"]), "b": [jnp.asarray(v) for v in np_tree["b"]],
          "c": {"d": jnp.asarray(np_tree["c"]["d"])}}
    pt = tree.tree_map(torch.from_numpy, np_tree)
    return np_tree, jt, pt


def test_tree_counts_bytes_and_casts_match_the_reference():
    _np, jt, pt = _trees()
    assert tree.param_count(pt) == jtree.param_count(jt) == 15 + 7 + 6 + 8
    assert tree.param_bytes(pt) == jtree.param_bytes(jt)
    jb, pb = jtree.tree_cast(jt, jnp.bfloat16), tree.tree_cast(pt, torch.bfloat16)
    assert tree.param_bytes(pb) == jtree.param_bytes(jb)
    assert pb["b"][1].dtype == torch.int32 and jb["b"][1].dtype == jnp.int32  # ints left alone
    assert pb["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pb["a"].float().numpy(),
                                  np.asarray(jb["a"].astype(jnp.float32)))
    # the same counts on meta tensors: shapes and dtypes alone
    meta = tree.tree_map(lambda v: torch.empty_like(v, device="meta"), pb)
    assert tree.param_bytes(meta) == tree.param_bytes(pb)


def test_tree_arithmetic_and_global_norm_match_the_reference():
    _np, jt, pt = _trees()
    floats = {"a": pt["a"], "c": pt["c"]}
    jfloats = {"a": jt["a"], "c": jt["c"]}
    added = tree.tree_add(floats, tree.tree_scale(floats, 0.5))
    jadded = jtree.tree_add(jfloats, jtree.tree_scale(jfloats, 0.5))
    np.testing.assert_allclose(added["c"]["d"].numpy(), np.asarray(jadded["c"]["d"]), rtol=1e-7)
    assert float(tree.param_count(tree.tree_zeros_like(floats))) == 23
    assert all(float(v.abs().sum()) == 0 for v in tree.tree_leaves(tree.tree_zeros_like(floats)))
    got, ref = float(tree.global_norm(pt)), float(jtree.global_norm(jt))
    assert abs(got - ref) <= 1e-6 * ref
    assert float(tree.global_norm({})) == 0.0


def test_utils_exports_match_the_reference():
    import repro.utils as jutils

    assert set(utils.__all__) == (set(jutils.__all__)
                                  - {"collective_bytes", "parse_hlo_collectives"}
                                  | {"collective_bytes", "collective_calls"})


def test_matmul_flops_are_exact():
    m, k, n = 128, 512, 64
    a, b = (torch.empty(s, device="meta") for s in ((m, k), (k, n)))
    with cost.CostCounter() as c:
        a @ b
    assert c.cost.flops == 2 * m * k * n
    assert c.cost.bytes == 4 * (m * k + k * n + m * n)


def _layers(n, w, x, scaled):
    """``n`` layers of ``tanh(x @ w)``: unrolled, or through ``trip_range``."""
    steps = cost.trip_range(n, x.device) if scaled else range(n)
    for _ in steps:
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("scaled", [False, True])
def test_a_loop_of_ten_layers_counts_ten_times_one(scaled):
    w, x = torch.empty(256, 256, device="meta"), torch.empty(8, 256, device="meta")
    with cost.CostCounter() as one:
        _layers(1, w, x, False)
    with cost.CostCounter() as ten:
        _layers(10, w, x, scaled)
    assert ten.cost.flops == 10 * one.cost.flops
    assert ten.cost.bytes == 10 * one.cost.bytes


def test_trip_scaled_loop_with_a_backward_equals_the_unrolled_one():
    def run(scaled):
        x = torch.empty(4, 9, 8, device="meta", requires_grad=True)
        w = torch.empty(8, 8, device="meta", requires_grad=True)
        with cost.CostCounter(trip_scaling=scaled) as c:
            s, ys = torch.zeros(4, 8, device="meta"), []
            for t in cost.trip_range(9, x.device):
                s = torch.tanh(s @ w + x[:, t])
                ys.append(2 * s)
            (cost.full_stack(ys, 1, 9).sum() + s.sum()).backward()
        return c.cost

    a, b = run(True), run(False)
    assert (a.flops, a.bytes) == (b.flops, b.bytes)


def test_matmul_flops_match_the_reference_walker():
    """The reference's trip-scaled HLO walker on the same product, in a
    subprocess (``hlo_cost``'s dot flops)."""
    code = textwrap.dedent("""
        import json, jax, jax.numpy as jnp
        from repro.utils.hlo import hlo_cost
        out = {}
        for m, k, n in ((128, 512, 64), (64, 96, 32)):
            co = jax.jit(lambda a, b: a @ b).lower(
                jax.ShapeDtypeStruct((m, k), jnp.float32),
                jax.ShapeDtypeStruct((k, n), jnp.float32)).compile()
            out[f"{m},{k},{n}"] = hlo_cost(co.as_text()).flops
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for key, flops in ref.items():
        m, k, n = map(int, key.split(","))
        a, b = (torch.empty(s, device="meta") for s in ((m, k), (k, n)))
        with cost.CostCounter() as c:
            a @ b
        assert c.cost.flops == flops, key


@pytest.mark.parametrize("backend,kind", [("nccl", "reduce_scatter"), ("gloo", "all_reduce")])
def test_dry_route_counts_the_collective_the_backend_issues(backend, kind):
    mesh = MeshSpec((4, 2), ("data", "model"), backend=backend, rank=5)
    assert (mesh.get_local_rank("data"), mesh.get_local_rank("model")) == (2, 1)
    comm.reset_wire_bytes()
    t = torch.empty(8, 6, device="meta")
    with comm.bound(mesh), cost.CostCounter() as c:
        group, size = comm.axis_group("data")
        assert size == 4 and group.index == 2
        block = comm.reduce_scatter(t, group, dim=0)
        gathered = comm.all_gather(block, group)
        comm.all_reduce(block, group, async_op=True).wait()
    assert tuple(block.shape) == (2, 6) and tuple(gathered.shape) == (4, 2, 6)
    assert block.device.type == "meta"
    wire = comm.wire_bytes()
    assert wire["by_op"] == {kind: 8 * 6 * 4 + (2 * 6 * 4 if kind == "all_reduce" else 0),
                             "all_gather": 2 * 6 * 4,
                             **({} if kind == "all_reduce" else {"all_reduce": 2 * 6 * 4})}
    assert wire["calls"] == {kind: 1 + (kind == "all_reduce"), "all_gather": 1,
                             **({} if kind == "all_reduce" else {"all_reduce": 1})}
    assert cost.collective_bytes(c.cost)["total"] == wire["total"]
    assert cost.collective_bytes(c.cost)["count"] == 3
    assert len(cost.collective_calls(c.cost)) == 3
    assert cost.top_collectives(c.cost, 1)[0][0] == max(wire["by_op"].values()) - (
        2 * 6 * 4 if kind == "all_reduce" else 0)

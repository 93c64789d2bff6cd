"""The distribution slice's pieces that run in one process, against the
reference: the mesh factoring table and the launchers' ``--mesh`` parsing
(``launch/mesh.py``), the batch split rule (``dist/sharding.py``),
error-feedback compression (``optim/compression.py``: exactly-k top-k under
ties, int8's rounding, the local ``compress_grads``, the residual trees
carried across by ``bridge.py``), one-process compressed training against
the reference's loop, and the calls that raised while the model-sharded
meshes waited, which now run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro.launch.mesh import auto_mesh_shape as j_auto_mesh_shape
from repro.optim import compression as jcomp
from repro.train.loop import train_flow as j_train_flow
from repro_torch.bridge import named_from_numpy, params_from_numpy, torch_tree, tree_paths
from repro_torch.config import TrainConfig, get_arch
from repro_torch.core import build_glow_scanned
from repro_torch.dist.sharding import BatchSharding, batch_pspecs
from repro_torch.launch.mesh import (
    MeshSpec,
    auto_mesh_shape,
    make_production_mesh,
    make_test_mesh,
    parse_mesh_arg,
)
from repro_torch.optim import compress_grads, compression_init
from repro_torch.optim.compression import _topk_select
from repro_torch.train.loop import train_flow

torch.set_num_threads(1)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)


@pytest.mark.parametrize("n,shape", [(256, (16, 16)), (8, (4, 2)), (6, (3, 2)), (4, (2, 2)),
                                     (1, (1, 1)), (12, (4, 3)), (7, (7, 1))])
def test_auto_mesh_shape_table(n, shape):
    assert auto_mesh_shape(n) == shape == j_auto_mesh_shape(n)


def test_production_mesh_and_mesh_args():
    assert make_production_mesh() == MeshSpec((16, 16), ("data", "model"))
    multi = make_production_mesh(multi_pod=True)
    assert multi.shape == (2, 16, 16) and multi.mesh_dim_names == ("pod", "data", "model")
    assert multi.size() == 512
    assert parse_mesh_arg("", "cpu") is None
    with pytest.raises(ValueError, match="'auto', 'd,m' or 'p,d,m'"):
        parse_mesh_arg("1,1,1,1", "cpu")
    pod = parse_mesh_arg("1,1,1", "cpu")  # the multi-pod shape, a world of one process
    assert tuple(pod.shape) == (1, 1, 1) and pod.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="does not match the world"):
        parse_mesh_arg("2,1", "cpu")  # a world of one process
    mesh = parse_mesh_arg("auto", "cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError):
        auto_mesh_shape(0)


def test_batch_split_rule():
    mesh = MeshSpec((4, 1), ("data", "model"))
    batch = {"x": torch.zeros(8, 3), "odd": torch.zeros(6, 2), "tiny": torch.zeros(2),
             "scalar": torch.zeros(())}
    assert batch_pspecs(batch, mesh) == {"x": "data", "odd": None, "tiny": None,
                                         "scalar": None}
    assert batch_pspecs(batch, MeshSpec((1, 1), ("data", "model")))["x"] is None
    x = torch.arange(8)
    assert [BatchSharding(4, i).local(x).tolist() for i in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert torch.equal(BatchSharding(4, 1).local(torch.arange(6)), torch.arange(6))


@pytest.mark.parametrize("case", ["all_equal", "quantized", "signed_ties", "random"])
@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.37])
def test_topk_is_exactly_k_under_ties(case, ratio):
    rng = np.random.default_rng(0)
    flat = {"all_equal": np.full(500, 0.25, np.float32),
            "quantized": rng.integers(-3, 4, 500).astype(np.float32),
            "signed_ties": np.tile(np.array([1.0, -1.0, 0.5, -0.5], np.float32), 125),
            "random": rng.standard_normal(500).astype(np.float32)}[case]
    vals, idx = _topk_select(torch.from_numpy(flat), ratio)
    j_vals, j_idx = jcomp._topk_select(jnp.asarray(flat), ratio)
    assert idx.numel() == max(1, int(500 * ratio))
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(vals.numpy(), np.asarray(j_vals))


def test_int8_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5])
    sent, err = compress_grads({"w": g}, {"w": torch.zeros(8)}, "int8")
    # scale = 127 / 127 + 1e-12 = 1 in f32: codes are the rounded values
    assert sent["w"].tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0]
    assert torch.equal(sent["w"] + err["w"], g)


@pytest.mark.parametrize("method,ratio", [("topk", 0.1), ("int8", 0.0), ("none", 0.0)])
def test_compress_grads_matches_the_reference_with_error_feedback(method, ratio):
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 5), "b": (7,), "c": (2, 3, 4)}
    err = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    j_err = {k: jnp.asarray(v) for k, v in err.items()}
    t_err = {k: torch.from_numpy(v) for k, v in err.items()}
    for _ in range(3):  # the residual feeds back
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        j_sent, j_err = jcomp.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, j_err,
                                             method, ratio)
        sent, t_err = compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, t_err,
                                     method, ratio)
        for k in shapes:
            np.testing.assert_allclose(sent[k].numpy(), np.asarray(j_sent[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(t_err[k].numpy(), np.asarray(j_err[k]), rtol=0, atol=1e-6)


def test_residual_trees_carry_across():
    """``compression_init``'s residual tree, with and without the leading
    shard axis, is the reference's, leaf for leaf (``bridge.named_from_numpy``);
    integer buffers carry none."""
    x = jnp.zeros((2, 8, 8, 3))
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled")
    tree = jax.tree_util.tree_map(np.asarray, jflow.init(jax.random.PRNGKey(0), x))
    flow = params_from_numpy(build_glow_scanned(**SMALL, grad_mode="coupled", device="cpu"), tree)
    for n in (None, 2):
        ref = named_from_numpy(flow, jax.tree_util.tree_map(
            np.asarray, jcomp.compression_init(tree, n), is_leaf=lambda v: v is None))
        mine = {k: v for k, v in compression_init(dict(flow.named_parameters()), n).items()}
        assert set(ref) == set(mine) == {k for k, _ in flow.named_parameters()}
        assert all(tuple(mine[k].shape) == tuple(ref[k].shape) for k in ref)
    stacked = torch_tree({"stages": {"w": np.ones((2, 3, 4, 4), np.float32)},
                          "head": np.zeros((4, 1), np.float32)})
    assert stacked["stages"]["w"].shape == (2, 3, 4, 4) and stacked["head"].dtype == torch.float32


class _Batches:
    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, step):
        return self.arrays[step]


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_one_process_compressed_training_matches_the_reference(tmp_path, method):
    rng = np.random.default_rng(4)
    batches = [rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32) - 0.5 for _ in range(3)]
    cfg = dict(steps=3, lr=1e-2, warmup_steps=1, grad_compression=method,
               compression_ratio=0.25)
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible")
    jres = j_train_flow(jflow, _Batches([jnp.asarray(b) for b in batches]),
                        JTrainConfig(**cfg, seed=5, prefetch=0,
                                     checkpoint_dir=str(tmp_path / "ck")),
                        jnp.asarray(batches[0]))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jflow.init(jax.random.PRNGKey(5), jnp.asarray(batches[0])))
    flow = params_from_numpy(build_glow_scanned(**SMALL, grad_mode="coupled",
                                                coupled_bwd="reversible", device="cpu"), tree)
    res = train_flow(flow, _Batches([torch.from_numpy(b) for b in batches]), TrainConfig(**cfg),
                     device="cpu")
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)
    ref = tree_paths(flow, jres.params)
    for key, v in flow.state_dict().items():
        diff = np.abs(v.numpy() - np.asarray(ref[key]))
        if method == "topk":
            assert float(diff.max()) <= 1e-4, key
        else:
            # an int8 code of a gradient entry that sits on a rounding
            # boundary may round the other way under f32 round-off: a few
            # entries may move by one code's update (at lr 1e-2, < 1e-3)
            assert float(diff.max()) <= 1e-3 and np.mean(diff > 1e-4) <= 5e-3, key


def test_model_sharded_meshes_raise_naming_part_2(tmp_path):
    """The three calls that raised while the model-sharded meshes waited
    (ROADMAP.md queue 1, item 7 part 2, now closed) run: ``train_flow`` on a
    (1, 2) mesh (two ``gloo`` ranks), ``attn_apply(seq_shard=True)`` with no
    mesh bound (the unsharded result, bit for bit) and ``ServeEngine`` on a
    mesh (a (1, 1) mesh in this process)."""
    from repro_torch.models import Model
    from repro_torch.nn.attention import attn_apply, attn_init
    from repro_torch.serve.engine import ServeEngine
    from torch_dist_workers import spawn, train_flow_synthetic

    outs = spawn(train_flow_synthetic, 2, tmp_path / "run", (1, 2),
                 dict(SMALL, grad_mode="coupled"))
    assert outs[0]["losses"] == outs[1]["losses"] and np.isfinite(outs[0]["losses"]).all()
    cfg = get_arch("yi-6b").reduced
    p = attn_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.attention)
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    sharded, _ = attn_apply(p, x, cfg.attention, torch.arange(4), seq_shard=True)
    plain, _ = attn_apply(p, x, cfg.attention, torch.arange(4))
    assert torch.equal(sharded, plain)
    engine = ServeEngine(Model(cfg, device="cpu"), 8, device="cpu", mesh=make_test_mesh(1, 1))
    toks, logits = engine.generate({"tokens": torch.zeros(2, 4, dtype=torch.int32)}, 2)
    assert toks.shape == (2, 2) and bool(torch.isfinite(logits).all())

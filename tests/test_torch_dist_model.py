"""The model-sharded meshes of the port on the flow side, each against the
reference's single-device result (the reference's own model-sharded flow
training fails on its mesh, ROADMAP.md queue 3), in ``gloo`` worlds of two
to four ranks (``tests/torch_dist_workers.py::spawn``):

* ``train_flow`` of the scanned GLOW on (1, 2) and (2, 2), every parameter
  and AdamW moment stored as each rank's block: each step's loss within
  1e-4 of its size, every trained leaf within 1e-4 of its scale, each rank
  storing half the parameter and moment bytes;
* an elastic restore (2, 1) -> (1, 2) -> one process (the change of mesh
  warned), against the reference run cut at the same steps;
* the multi-pod (2, 2, 1) data-parallel step (the two data axes, the
  reduction inside the backward over ``("pod", "data")``) against one
  process;
* gradient compression on a model-sharded mesh raises ``ValueError``, as in
  the reference.

The LM side (expert parallelism, sequence-parallel attention, the mesh
``ServeEngine``, ``train_lm``, the launchers) is in
``tests/test_torch_dist_model_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro.train.loop import train_flow as j_train_flow
from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.core import build_glow_scanned
from torch_dist_workers import compression_on_model_mesh, spawn, train_flow_mesh

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
BUILD = dict(SMALL, grad_mode="coupled", coupled_bwd="reversible")
TOL = 1e-4


class _Batches:
    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, step):
        return self.arrays[step % len(self.arrays)]


def _batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32) - 0.5 for _ in range(n)]


def _flow_ref(tmp_path, batches, cfg, seed=5, segments=None):
    """(numpy tree of the initial parameters, the reference's single-device
    ``train_flow`` losses, the port's state keys -> the reference's trained
    leaves).  ``segments``: the run is cut into runs to these step counts,
    each resuming the last one's checkpoint (the cosine schedule reads each
    run's own step count)."""
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible")
    tree = jax.tree_util.tree_map(
        np.asarray, jflow.init(jax.random.PRNGKey(seed), jnp.asarray(batches[0])))
    losses = []
    for steps in segments or (cfg["steps"],):
        jres = j_train_flow(jflow, _Batches([jnp.asarray(b) for b in batches]),
                            JTrainConfig(**dict(cfg, steps=steps), seed=seed, prefetch=0,
                                         checkpoint_dir=str(tmp_path / "jck")),
                            jnp.asarray(batches[0]))
        losses += list(jres.losses)
    flow = build_glow_scanned(**BUILD, device="cpu")
    return tree, losses, tree_paths(flow, jres.params)


def _leaf_close(v, r, tol=TOL):
    r = np.asarray(r, np.float32)
    scale = max(float(np.abs(r).max()), 1.0)
    return float(np.abs(v - r).max()) <= tol * scale


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_model_sharded_train_flow_matches_the_single_device_reference(tmp_path, shape):
    batches = _batches()
    cfg = dict(steps=3, lr=1e-3, warmup_steps=1)
    tree, ref_losses, ref = _flow_ref(tmp_path, batches, cfg)
    outs = spawn(train_flow_mesh, shape[0] * shape[1], tmp_path / "run", shape, BUILD, tree,
                 batches, cfg)
    for out in outs:
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=TOL)
        for key, v in out["params"].items():
            assert _leaf_close(v, ref[key]), key
        b = out["shard_bytes"]
        # each rank stores about half of every split leaf (1-D leaves whole)
        assert 0.45 <= b["params"] / b["params_whole"] <= 0.6, b
        assert 0.45 <= b["moments"] / b["moments_whole"] <= 0.6, b
        assert out["wire"]["by_op"].get("all_gather", 0) > 0
    for key, v in outs[0]["params"].items():
        assert all(np.array_equal(v, o["params"][key]) for o in outs[1:]), key


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """(2, 1) for 2 steps, then (1, 2) to step 4 (restored with a warning
    that the mesh changed), then one process to step 6, each restoring the
    last one's whole-leaf checkpoint, against the reference run cut at the
    same steps."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.loop import train_flow

    batches = _batches(6, seed=8)
    base = dict(lr=1e-3, warmup_steps=1, checkpoint_every=1)
    tree, ref_losses, ref = _flow_ref(tmp_path, batches, dict(base, steps=6),
                                      segments=(2, 4, 6))
    ck = str(tmp_path / "ck")
    wide = spawn(train_flow_mesh, 2, tmp_path / "a", (2, 1), BUILD, tree, batches,
                 dict(base, steps=2), ck)
    assert wide[0]["final_step"] == 1
    sharded = spawn(train_flow_mesh, 2, tmp_path / "b", (1, 2), BUILD, tree, batches,
                    dict(base, steps=4), ck)
    for out in sharded:
        assert out["final_step"] == 3 and len(out["losses"]) == 2
        assert any("written under mesh [2, 1]" in w for w in out["warnings"]), out["warnings"]
    flow = params_from_numpy(build_glow_scanned(**BUILD, device="cpu"), tree)
    res = train_flow(flow, _Batches([torch.from_numpy(b) for b in batches]),
                     TrainConfig(**base, steps=6, checkpoint_dir=ck), device="cpu")
    assert res.final_step == 5 and len(res.losses) == 2
    losses = wide[0]["losses"] + sharded[0]["losses"] + res.losses
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
    for key, v in flow.state_dict().items():
        if v.is_floating_point():
            assert _leaf_close(v.numpy(), ref[key]), key


def test_multi_pod_data_parallel_step_matches_one_process(tmp_path):
    """A (2, 2, 1) ``("pod", "data", "model")`` mesh: the batch splits over
    both data axes and the flow's backward sums over ``("pod", "data")``."""
    batches = [np.concatenate([b, b[::-1]]) for b in _batches()]  # batch 8: 2 rows a rank
    cfg = dict(steps=3, lr=1e-3, warmup_steps=1)
    tree, ref_losses, ref = _flow_ref(tmp_path, batches, cfg)
    outs = spawn(train_flow_mesh, 4, tmp_path / "run", (2, 2, 1), BUILD, tree, batches, cfg,
                 None, ("pod", "data"))
    for out in outs:
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=TOL)
        for key, v in out["params"].items():
            assert _leaf_close(v, ref[key]), key
        assert out["shard_bytes"] == {}  # nothing split: a pure data-parallel mesh
        assert out["wire"]["by_op"].get("all_reduce", 0) > 0


def test_compression_on_a_model_sharded_mesh_raises(tmp_path):
    batches = _batches(1)
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible")
    tree = jax.tree_util.tree_map(
        np.asarray, jflow.init(jax.random.PRNGKey(5), jnp.asarray(batches[0])))
    outs = spawn(compression_on_model_mesh, 2, tmp_path / "run", (1, 2), BUILD, tree, batches)
    for out in outs:
        assert out["error"] is not None and "pure data-parallel mesh" in out["error"]

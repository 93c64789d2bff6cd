"""The port's supervised loop on a data-parallel mesh of two ``gloo`` ranks
(``tests/torch_dist_workers.py``), against the reference's single-device
loop, and the contracts of the reference's ``tests/test_dp_step.py`` and
``tests/test_elastic.py``:

* ``train_flow`` on the scanned GLOW (2 scales x 2 steps, hidden 8;
  ``coupled`` on the reversible walk, its reduction overlapped into the
  backward) with ``accum_steps=2`` and prefetch, 3 steps: each step's loss
  within 1e-4 of its size and every trained parameter within 1e-4 of the
  reference's ``train_flow`` without a mesh (the reference's own 8-shard
  test pins 1e-4);
* ``train_lm`` on granite-moe-1b-a400m ``REDUCED`` in f32, 2 steps, on the
  reference's own token batches, against the
  reference's ``train_lm`` on one device (an MoE's capacity is per
  sequence, so splitting the batch changes no routing);
* int8-compressed training tracks dense training (5e-3 on the loss, the
  reference's bound); a run killed at step 3 and restarted is bitwise the
  uninterrupted one on the mesh;
* a checkpoint records its mesh and a restore onto another mesh shape
  warns; an elastic restart onto a world of one re-zeros the compression
  residuals, with a warning, and resumes.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.train.loop import train_flow as j_train_flow
from repro.train.loop import train_lm as j_train_lm
from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.config import TrainConfig
from repro_torch.core import build_glow_scanned
from repro_torch.launch.mesh import MeshSpec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import train_flow
from torch_dist_workers import spawn, train_flow_dp, train_lm_dp
from torch_lm_parity import configs

torch.set_num_threads(1)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
BUILD = dict(SMALL, grad_mode="coupled", coupled_bwd="reversible")


class _Batches:
    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, step):
        return self.arrays[step % len(self.arrays)]


def _batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32) - 0.5 for _ in range(n)]


def _tree(seed=5, example=None):
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible")
    x = jnp.asarray(example if example is not None else _batches(1)[0])
    return jflow, jax.tree_util.tree_map(np.asarray, jflow.init(jax.random.PRNGKey(seed), x))


def test_dp_train_flow_matches_the_single_device_reference(tmp_path):
    batches = _batches()
    cfg = dict(steps=3, lr=1e-3, warmup_steps=1)
    jflow, tree = _tree(example=batches[0])
    jres = j_train_flow(jflow, _Batches([jnp.asarray(b) for b in batches]),
                        JTrainConfig(**cfg, seed=5, prefetch=0,
                                     checkpoint_dir=str(tmp_path / "jck")),
                        jnp.asarray(batches[0]))
    outs = spawn(train_flow_dp, 2, tmp_path / "run", BUILD, tree, batches,
                 dict(cfg, accum_steps=2, prefetch=2), "data")
    flow = build_glow_scanned(**BUILD, device="cpu")
    ref = tree_paths(flow, jres.params)
    for out in outs:
        np.testing.assert_allclose(out["losses"], jres.losses, rtol=1e-4)
        for key, v in out["params"].items():
            np.testing.assert_allclose(v, np.asarray(ref[key]), rtol=0, atol=1e-4, err_msg=key)
    for key, v in outs[0]["params"].items():
        assert np.array_equal(v, outs[1]["params"][key]), key  # replicated


def test_dp_train_lm_matches_the_single_device_reference(tmp_path):
    arch = "granite-moe-1b-a400m"
    jmod, pmod = configs(arch)
    # f32 activations, as the port's LM parity tests take them (REDUCED is bf16)
    jm_cfg, pm_cfg = jmod.REDUCED.replace(dtype="float32"), pmod.REDUCED.replace(dtype="float32")
    from repro.models.lm import Model as JModel

    jm = JModel(jm_cfg)
    cfg = dict(steps=2, lr=1e-3, warmup_steps=1)
    data_kw = dict(vocab=jm_cfg.vocab_size, seq_len=16, batch=4, seed=1)
    jres = j_train_lm(jm, JSyntheticTokens(**data_kw),
                      JTrainConfig(**cfg, prefetch=0, checkpoint_dir=str(tmp_path / "jck")),
                      rng=jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    # the reference's own token batches, handed across
    batches = [{k: np.asarray(v) for k, v in JSyntheticTokens(**data_kw).batch_at(s).items()}
               for s in range(cfg["steps"])]
    outs = spawn(train_lm_dp, 2, tmp_path / "run", pm_cfg, tree, cfg, batches)
    from repro_torch.models import Model

    model = params_from_numpy(Model(pm_cfg, device="cpu"), tree)
    ref = tree_paths(model, jax.tree_util.tree_map(np.asarray, jres.params))
    for out in outs:
        np.testing.assert_allclose(out["losses"], jres.losses, rtol=1e-4)
        for key, v in out["params"].items():
            r = np.asarray(ref[key], np.float32)
            scale = max(float(np.abs(r).max()), 1.0)
            assert float(np.abs(v - r).max()) <= 1e-4 * scale, key


def test_int8_compressed_training_tracks_dense_and_restarts_bitwise(tmp_path):
    batches = _batches(4, seed=6)
    _jflow, tree = _tree(example=batches[0])
    base = dict(steps=6, lr=1e-3, warmup_steps=2, checkpoint_every=2)
    dense = spawn(train_flow_dp, 2, tmp_path / "dense", BUILD, tree, batches, base, None,
                  str(tmp_path / "ck_dense"))
    int8 = spawn(train_flow_dp, 2, tmp_path / "int8", BUILD, tree, batches,
                 dict(base, grad_compression="int8"), None, str(tmp_path / "ck_int8"))
    d = max(abs(a - b) for a, b in zip(dense[0]["losses"], int8[0]["losses"]))
    assert d < 5e-3, f"int8 training diverged from dense: {d}"
    # residuals are per-rank state: each rank carries its own
    assert any(not np.array_equal(int8[0]["err"][k], int8[1]["err"][k]) for k in int8[0]["err"])
    restarted = spawn(train_flow_dp, 2, tmp_path / "restart", BUILD, tree, batches,
                      dict(base, grad_compression="int8", prefetch=0), None,
                      str(tmp_path / "ck_restart"), (3,))
    for out, ref in zip(restarted, int8):
        assert out["restarts"] == 1 and out["final_step"] == 5
        assert out["losses"] == ref["losses"][2:]
        for key, v in out["params"].items():
            assert np.array_equal(v, ref["params"][key]), key
        for key, v in out["err"].items():
            assert np.array_equal(v, ref["err"][key]), key


def test_elastic_restart_rezeros_compression_residuals(tmp_path):
    batches = _batches(4, seed=7)
    _jflow, tree = _tree(example=batches[0])
    ckdir = str(tmp_path / "ck")
    cfg = dict(lr=1e-3, warmup_steps=2, checkpoint_every=2, grad_compression="int8")
    r1 = spawn(train_flow_dp, 2, tmp_path / "wide", BUILD, tree, batches, dict(cfg, steps=4),
               None, ckdir)
    assert len(r1[0]["losses"]) == 4
    with open(os.path.join(ckdir, "step_00000003", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["mesh"] == {"shape": [2, 1], "axis_names": ["data", "model"]}
    assert any(k.startswith("err/") and v[0] == 2 for k, v in manifest["shapes"].items())
    # the same checkpoint restored onto another mesh shape warns
    flow = params_from_numpy(build_glow_scanned(**BUILD, device="cpu"), tree)
    with pytest.warns(UserWarning, match="written under mesh"):
        ckpt.restore({"params": flow.state_dict()}, ckdir,
                     mesh=MeshSpec((1, 1), ("data", "model")))
    # an elastic restart onto one process: residuals re-zeroed, resumed at 4
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r2 = train_flow(flow, _Batches([torch.from_numpy(b) for b in batches]),
                        TrainConfig(**cfg, steps=8, checkpoint_dir=ckdir), device="cpu")
    assert any("residuals re-zeroed" in str(x.message) for x in w), [str(x.message) for x in w]
    assert r2.final_step == 7 and len(r2.losses) == 4 and all(np.isfinite(r2.losses))
    # the restored parameters are the wide run's
    restored, step = ckpt.restore({"params": flow.state_dict()}, ckdir, step=3)
    for key, v in r1[0]["params"].items():
        assert np.array_equal(restored["params"][key].numpy(), v), key

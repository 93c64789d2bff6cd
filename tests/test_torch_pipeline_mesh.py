"""GPipe on meshes with more axes than ``pipe``: four ``gloo`` ranks on a
``(pipe 2, data 2)``, a ``(data 2, pipe 2)`` and a ``(pod 2, data 1, pipe
2)`` mesh (``tests/torch_dist_workers.py::pipeline_on_mesh``).

* ``pipeline_forward`` and its gradient against the same tanh blocks applied
  in sequence by the reference on one device (``jax.vjp``), within 1e-5,
  the outputs of each stage's two replicas bitwise equal;
* ``train_pipeline`` for 4 steps against the reference's ``train_pipeline``
  on the same mesh shape, run in a subprocess that forges 4 XLA CPU devices
  (as ``tests/test_dp_step.py`` does), from the same numpy parameters and
  batches: every loss within 1e-5 of its magnitude and every final leaf
  within 1e-5 of its scale; each rank's parameters bitwise equal to every
  other rank's, its replica's among them; one checkpoint written;
* ``train_pipeline`` on a ``("data", "model")`` mesh raises ``ValueError``.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_workers import pipeline_on_mesh, spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pipe_data": ((2, 2), ("pipe", "data")), "data_pipe": ((2, 2), ("data", "pipe")),
          "pod_data_pipe": ((2, 1, 2), ("pod", "data", "pipe"))}
S, L_PER, D, M, MB = 2, 2, 16, 4, 3
STEPS, BATCH = 4, 16
CFG = dict(steps=STEPS, lr=1e-2, warmup_steps=2, checkpoint_every=100, pipeline_microbatches=4)
TOL = 1e-5


def _case():
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((S, L_PER, D, D))).astype(np.float32)
    b = (0.1 * rng.standard_normal((S, L_PER, D))).astype(np.float32)
    head = (0.1 * rng.standard_normal((D, 1))).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    gy = rng.standard_normal((M, MB, D)).astype(np.float32)
    xs = [rng.standard_normal((BATCH, D)).astype(np.float32) for _ in range(STEPS)]
    ys = [np.sin(v.sum(-1, keepdims=True)).astype(np.float32) for v in xs]
    return w, b, head, x, gy, xs, ys


def _sequential(w, b, x):
    h = x
    for s in range(w.shape[0]):
        for i in range(w.shape[1]):
            h = jnp.tanh(h @ w[s, i] + b[s, i])
    return h


_REFERENCE = """
import sys, tempfile
import jax, jax.numpy as jnp, numpy as np
from repro.config import TrainConfig
from repro.train.loop import train_pipeline

case = np.load(sys.argv[1])
S, L_PER, STEPS = {S}, {L_PER}, {STEPS}
xs = [case[f"x{{i}}"] for i in range(STEPS)]
ys = [case[f"y{{i}}"] for i in range(STEPS)]

class Data:
    def batch_at(self, step):
        i = step % len(xs)
        return {{"x": jnp.asarray(xs[i]), "y": jnp.asarray(ys[i])}}

out = {{}}
for name, (shape, axes) in {meshes!r}.items():
    mesh = jax.make_mesh(shape, axes)
    cfg = TrainConfig(**{cfg!r}, checkpoint_dir=tempfile.mkdtemp())
    res = train_pipeline(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        lambda: {{"stages": {{"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])}},
                 "head": jnp.asarray(case["head"])}},
        Data(), cfg, mesh=mesh, n_layers_per_stage=L_PER,
        loss_head=lambda p, h, batch: jnp.mean((h @ p["head"] - batch["y"]) ** 2))
    out[f"{{name}}/losses"] = np.asarray(res.losses, np.float64)
    out[f"{{name}}/stages.w"] = np.asarray(res.params["stages"]["w"])
    out[f"{{name}}/stages.b"] = np.asarray(res.params["stages"]["b"])
    out[f"{{name}}/head"] = np.asarray(res.params["head"])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def reference(case, tmp_path_factory):
    """The reference's ``train_pipeline`` on each mesh of 4 forged devices."""
    w, b, head, _x, _gy, xs, ys = case
    tmp = tmp_path_factory.mktemp("reference")
    np.savez(tmp / "case.npz", w=w, b=b, head=head, **{f"x{i}": v for i, v in enumerate(xs)},
             **{f"y{i}": v for i, v in enumerate(ys)})
    code = textwrap.dedent(_REFERENCE.format(S=S, L_PER=L_PER, STEPS=STEPS, meshes=MESHES,
                                             cfg=CFG))
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "case.npz"),
                          str(tmp / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Each mesh's four ranks' results, one ``gloo`` world a mesh."""
    w, b, head, x, gy, xs, ys = case
    init = {"stages": {"w": w, "b": b}, "head": head}
    return {name: spawn(pipeline_on_mesh, 4, tmp_path_factory.mktemp(name), shape, axes, w, b,
                        x, gy, init, xs, ys, CFG, L_PER)
            for name, (shape, axes) in MESHES.items()}


def _replicas(outs):
    """The ranks grouped by pipe stage: each group is one stage's two
    replicas, which differ in their coordinates on the other axes."""
    by_stage = {}
    for out in outs:
        by_stage.setdefault(out["stage"], []).append(out)
    return by_stage


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipeline_forward_and_gradient_on_the_mesh(case, ranks, mesh):
    w, b, _head, x, gy, _xs, _ys = case
    ref, vjp = jax.vjp(_sequential, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    gw, gb, gx = (np.asarray(v) for v in vjp(jnp.asarray(gy)))
    scale = float(np.abs(ref).max())
    outs = ranks[mesh]
    assert sorted(o["stage"] for o in outs) == [0, 0, 1, 1]
    for out in outs:
        s = out["stage"]
        assert np.abs(out["out"] - np.asarray(ref)).max() <= TOL * scale
        assert np.abs(out["gw"] - gw[s]).max() <= TOL * np.abs(gw[s]).max()
        assert np.abs(out["gb"] - gb[s]).max() <= TOL * np.abs(gb[s]).max()
        if s == 0:
            assert np.abs(out["gx"] - gx).max() <= TOL * np.abs(gx).max()
        else:
            assert out["gx"] is None  # the input reaches stage 0 alone
    for stage, (first, second) in _replicas(outs).items():
        assert first["coord"] != second["coord"]
        for key in ("out", "gw", "gb"):
            assert np.array_equal(first[key], second[key]), (stage, key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_pipeline_on_the_mesh_matches_the_reference(ranks, reference, mesh):
    ref_losses = reference[f"{mesh}/losses"]
    for out in ranks[mesh]:
        losses = np.asarray(out["losses"], np.float64)
        assert out["final_step"] == STEPS - 1 and len(losses) == STEPS
        assert np.all(np.abs(losses - ref_losses) <= TOL * np.abs(ref_losses)), (
            losses, ref_losses)
        for key, v in out["params"].items():
            ref = reference[f"{mesh}/{key}"]
            assert v.shape == ref.shape, key
            assert np.abs(v - ref).max() <= TOL * np.abs(ref).max(), key
    # the steps trained: each batch's loss differs from the first's
    assert len(set(ref_losses.tolist())) == STEPS


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_pipeline_parameters_are_bitwise_equal_across_replicas(ranks, mesh):
    outs = ranks[mesh]
    for stage, (first, second) in _replicas(outs).items():
        assert first["coord"] != second["coord"]
        assert first["losses"] == second["losses"], stage
        for key, v in first["params"].items():
            assert np.array_equal(v, second["params"][key]), (stage, key)
    # the whole tree on every rank, the stages' too (summed over the pipe group)
    for key, v in outs[0]["params"].items():
        assert all(np.array_equal(v, o["params"][key]) for o in outs[1:]), key
    # rank 0 wrote the final step once
    assert all(o["checkpoints"] == [f"step_{STEPS - 1:08d}"] for o in outs)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_pipeline_without_a_pipe_axis_raises(ranks, mesh):
    for out in ranks[mesh]:
        assert out["no_pipe_error"] is not None and "'pipe' axis" in out["no_pipe_error"]

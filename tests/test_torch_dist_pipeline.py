"""GPipe over a ``("pipe",)`` mesh of ``gloo`` ranks
(``tests/torch_dist_workers.py``): ``pipeline_forward`` and its gradient
against the same blocks applied in sequence by the reference on one device
(``jax.vjp``), within 1e-5 (f32 tanh blocks; the forward is the same
arithmetic, the gradients sums in another order), with two stages; and
``train_pipeline`` with four stages, the reference's ``tests/test_dp_step.py``
case: its first loss is the sequential model's and the loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_workers import pipeline, spawn, train_pipeline_run

torch.set_num_threads(1)


def _blocks(s, l_per, d, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((s, l_per, d, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal((s, l_per, d))).astype(np.float32)
    return w, b


def _sequential(w, b, x):
    h = x
    for s in range(w.shape[0]):
        for i in range(w.shape[1]):
            h = jnp.tanh(h @ w[s, i] + b[s, i])
    return h


def test_pipeline_forward_and_gradient_match_the_blocks_in_sequence(tmp_path):
    s, l_per, d, m, mb = 2, 2, 16, 4, 3
    w, b = _blocks(s, l_per, d)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    gy = rng.standard_normal((m, mb, d)).astype(np.float32)
    ref, vjp = jax.vjp(_sequential, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    gw, gb, gx = (np.asarray(v) for v in vjp(jnp.asarray(gy)))
    outs = spawn(pipeline, s, tmp_path, w, b, x, gy, l_per)
    for rank, out in enumerate(outs):
        # every stage holds the replicated outputs
        np.testing.assert_allclose(out["out"], np.asarray(ref), rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["gw"], gw[rank], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["gb"], gb[rank], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0]["gx"], gx, rtol=0, atol=1e-5)
    assert outs[1]["gx"] is None  # the input reaches stage 0 alone


@pytest.mark.parametrize("world", [4])
def test_train_pipeline_learns(tmp_path, world):
    l_per, d = 2, 16
    w, b = _blocks(world, l_per, d)
    head = (0.1 * np.random.default_rng(2).standard_normal((d, 1))).astype(np.float32)
    xs, ys = [], []
    for step in range(4):
        x = np.random.default_rng(10 + step).standard_normal((16, d)).astype(np.float32)
        xs.append(x)
        ys.append(np.sin(x.sum(-1, keepdims=True)).astype(np.float32))
    init = {"stages": {"w": w, "b": b}, "head": head}
    cfg = dict(steps=20, lr=1e-2, warmup_steps=2, checkpoint_every=100, pipeline_microbatches=4)
    outs = spawn(train_pipeline_run, world, tmp_path, init, xs, ys, cfg, l_per)
    first = float(jnp.mean((_sequential(w, b, xs[0]) @ head - ys[0]) ** 2))
    for out in outs:
        assert abs(out["losses"][0] - first) <= 1e-5 * max(1.0, first)
        assert np.mean(out["losses"][-4:]) < np.mean(out["losses"][:4]) - 0.01
    for key, v in outs[0]["params"].items():  # replicated on every stage
        assert all(np.array_equal(v, o["params"][key]) for o in outs[1:]), key

"""Training in the port against the JAX reference: AdamW and the cosine
schedule on a random tree, and ``train_flow``'s loss curve.

The optimizer is held to 1e-6 (relative and absolute) per element over
three steps, one of them clipped: the same f32 arithmetic with sums in
another order.  ``train_flow`` runs 3 steps of scanned GLOW (2 scales x 2
steps, hidden 8) on both sides from the reference's own ``init`` and the same
numpy batches; each step's loss is held to 1e-4 relative (three steps of
float32 updates through a 4-step flow), and the trained parameters to
rtol 1e-3 with atol 1e-4.  The reference runs on its CPU path
with ``prefetch=0`` and a checkpoint directory under the test's ``tmp_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.train.loop import train_flow as j_train_flow
from repro_torch.bridge import params_from_numpy, tree_paths, tree_to_numpy
from repro_torch.config import TrainConfig
from repro_torch.core.glow_scan import build_glow_scanned
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
from repro_torch.train.loop import train_flow

torch.set_num_threads(2)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)


def test_cosine_warmup_matches_reference():
    for step in range(0, 24):
        ref = float(j_cosine_warmup(jnp.asarray(step), 3e-3, 5, 20))
        np.testing.assert_allclose(cosine_warmup(step, 3e-3, 5, 20), ref, rtol=1e-6, atol=1e-12)


def test_adamw_matches_reference_on_a_random_tree():
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "s": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["perm"] = np.arange(4, dtype=np.int32)  # integer leaves: no moments, no update
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp, jstate = {k: jnp.asarray(v) for k, v in params.items()}, None
    jstate = j_adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = adamw_init(tp)
    assert set(tstate["mu"]) == {"w", "b", "s"}
    for step, gscale in enumerate([0.01, 10.0, 0.1]):  # the second step is clipped
        grads = {k: (gscale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        lr = cosine_warmup(step, 1e-2, 1, 3)
        jgrads = {**{k: jnp.asarray(v) for k, v in grads.items()},
                  "perm": np.zeros(4, jax.dtypes.float0)}
        jp, jstate, jm = j_adamw_update(jp, jgrads, jstate, JTrainConfig(**cfg), jnp.float32(lr))
        tstate, tm = adamw_update(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                                  tstate, TrainConfig(**cfg), lr)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["clip_scale"]), float(jm["clip_scale"]), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tstate["mu"][k].numpy(), np.asarray(jstate["mu"][k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(jstate["nu"][k]),
                                       rtol=1e-6, atol=1e-12)
        assert tstate["step"] == int(jstate["step"]) == step + 1
    assert torch.equal(tp["perm"], torch.arange(4, dtype=torch.int32))


class _Batches:
    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, step):
        return self.arrays[step]


def test_train_flow_loss_curve_matches_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_COUPLED_BWD", raising=False)
    rng = np.random.default_rng(4)
    batches = [rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32) - 0.5 for _ in range(3)]
    cfg, seed = dict(steps=3, lr=1e-2, warmup_steps=1), 5
    jflow = j_build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible")
    jres = j_train_flow(
        jflow, _Batches([jnp.asarray(b) for b in batches]),
        JTrainConfig(**cfg, seed=seed, prefetch=0, checkpoint_dir=str(tmp_path / "ck")),
        jnp.asarray(batches[0]))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jflow.init(jax.random.PRNGKey(seed), jnp.asarray(batches[0])))
    flow = params_from_numpy(build_glow_scanned(**SMALL, grad_mode="coupled",
                                                coupled_bwd="reversible", device="cpu"), tree)
    res = train_flow(flow, _Batches(batches), TrainConfig(**cfg), device="cpu")
    assert res.final_step == jres.final_step == 2 and len(res.losses) == 3
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)
    # the parameters moved as the reference's did (AdamW normalises each
    # update, so a gradient near zero can amplify f32 round-off: looser)
    trained = tree_paths(flow, tree_to_numpy(flow, like=tree))
    ref = tree_paths(flow, jres.params)
    for key, v in trained.items():
        np.testing.assert_allclose(v, np.asarray(ref[key]), rtol=1e-3, atol=1e-4, err_msg=key)


def test_synthetic_images_are_step_indexed():
    data = SyntheticImages(16, channels=3, batch=4, seed=1)
    a, b = data.batch_at(3), data.batch_at(3)
    assert a.shape == (4, 16, 16, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, data.batch_at(4))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_train_flow_trains_on_synthetic_images():
    flow = build_glow_scanned(**SMALL, grad_mode="coupled", coupled_bwd="reversible", device="cpu")
    res = train_flow(flow, SyntheticImages(8, batch=4), TrainConfig(steps=6, lr=1e-2, warmup_steps=1),
                     device="cpu")
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    assert res.opt_state["step"] == 6

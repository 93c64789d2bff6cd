"""The runtime uses of the sharding rules' options, in two-rank ``gloo``
worlds (``tests/torch_dist_workers.py::spawn``):

* ``zero1``, ``fsdp`` and ``zero1-fsdp`` train steps of granite-moe-1b-a400m
  ``REDUCED`` (f32) on a (2, 1) mesh through
  ``launch/dryrun.py::make_train_step``, against the one-process step
  (accumulating over the ranks' row blocks) and, through its first loss, the reference's single-device ``train_loss`` on
  the same weights, within 1e-5 of each leaf's scale; ``fsdp`` halves a
  rank's stored parameters and ``zero1`` its moments; the blocks round-trip
  through the whole leaves a checkpoint holds;
* the dry run's collectives on ``MeshSpec((2, 1))`` and ``MeshSpec((1, 2))``
  equal, kind by kind, what ``dist/comm.py`` counted in the real step, and
  its argument bytes the rank's stored bytes plus its rows of the batch;
* a ``cache_seq_fallback`` decode on (1, 2) gives the one-process tokens
  (zamba2-7b, whose SSM states the rule splits by heads, and granite-moe),
  and the bf16 ``servefix`` decode step's wire equals the dry run's.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.config import TrainConfig
from repro_torch.launch.dryrun import make_train_step
from repro_torch.models import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.cost import COLLECTIVE_KINDS
from torch_dist_workers import fallback_decode, sharded_lm_steps, spawn
from torch_lm_parity import make_pair, token_batch

torch.set_num_threads(2)
TOL = 1e-5
CFG = dict(lr=1e-3, warmup_steps=1)
STEPS = 3
VARIANTS = ("zero1", "fsdp", "zero1-fsdp")
#: the dry run's kinds of ``dist/comm.py``'s collectives
KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
        "reduce_scatter": "reduce-scatter", "send": "collective-permute"}


def _one_process(arch_cfg, tree, batch):
    """The one-process step, accumulating over the two ranks' row blocks:
    the order in which the data axis sums the gradient (AdamW's first steps
    are nearly sign(g), so an element at the level of f32 reordering noise
    would flip under another order)."""
    model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
    step = make_train_step(model, TrainConfig(**CFG, accum_steps=2))
    state = step.init_state()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    return model, losses, {k: v.detach().numpy() for k, v in model.named_parameters()}


def _leaf_close(v, r, tol=TOL):
    scale = max(float(np.abs(r).max()), 1.0)
    return float(np.abs(v - r).max()) <= tol * scale


def _wire_as_kinds(wire: dict) -> dict:
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for op, n in wire["by_op"].items():
        out[KIND[op]] += n
    out["total"] = sum(wire["by_op"].values())
    out["count"] = sum(wire["calls"].values())
    return out


@pytest.fixture(scope="module")
def granite():
    jm, jp, m, tree = make_pair("granite-moe-1b-a400m", dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 4, 16)
    return jm, jp, m.cfg, tree, batch


def test_zero1_and_fsdp_steps_match_one_process_and_the_reference(granite, tmp_path):
    jm, jp, cfg, tree, batch = granite
    model, losses, params = _one_process(cfg, tree, batch)
    jloss = float(jm.train_loss(jp, {k: jax.numpy.asarray(v) for k, v in batch.items()})[0])
    assert abs(losses[0] - jloss) <= TOL * max(abs(jloss), 1.0)
    outs = spawn(sharded_lm_steps, 2, tmp_path / "run", (2, 1), cfg, tree, batch, CFG, VARIANTS,
                 STEPS)
    for out in outs:
        for variant, res in out.items():
            np.testing.assert_allclose(res["losses"], losses, rtol=TOL, err_msg=variant)
            for key, v in res["params"].items():
                assert _leaf_close(v, params[key]), (variant, key)
            assert res["round_trip"], variant
    stored = {v: outs[0][v]["stored"] for v in VARIANTS}
    # zero1: whole parameters, moments split; fsdp: both split (a leaf too
    # small to divide stays whole, so a little more than half)
    assert stored["zero1"]["params"] == stored["zero1"]["params_whole"]
    assert stored["fsdp"]["params"] < 0.55 * stored["fsdp"]["params_whole"]
    assert stored["zero1"]["moments"] < 0.55 * stored["zero1"]["moments_whole"]
    assert stored["fsdp"]["moments"] < 0.55 * stored["fsdp"]["moments_whole"]
    # zero1 with fsdp: the parameters as fsdp stores them; zero1 still splits
    # a moment whose parameter fsdp left whole over the data axes
    assert stored["zero1-fsdp"]["params"] == stored["fsdp"]["params"]
    assert stored["zero1-fsdp"]["moments"] <= stored["fsdp"]["moments"]
    for variant in VARIANTS:
        a, b = outs[0][variant]["params"], outs[1][variant]["params"]
        assert all(np.array_equal(a[k], b[k]) for k in a)  # every rank the same whole leaves


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_dry_run_collectives_equal_the_counted_wire(granite, tmp_path, shape):
    _jm, _jp, cfg, tree, batch = granite
    variants = ("", "zero1-fsdp")
    outs = spawn(sharded_lm_steps, 2, tmp_path / "run", shape, cfg, tree, batch, CFG, variants, 1)
    for out in outs:
        for variant in variants:
            res = out[variant]
            dry = res["dry"]
            assert dry["collectives"] == _wire_as_kinds(res["wire"]), (shape, variant)
            local = sum(v.nbytes // batch["tokens"].shape[0] * res["rows"]
                        for v in batch.values())
            assert dry["memory"]["argument_bytes"] == res["stored_bytes"] + local, (shape, variant)


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-moe-1b-a400m"])
def test_sequence_fallback_decode_gives_the_one_process_tokens(arch, tmp_path):
    _jm, _jp, m, tree = make_pair(arch, dtype="float32")
    prompt = np.random.default_rng(3).integers(0, m.cfg.vocab_size, (2, 12)).astype(np.int32)
    toks, logits = ServeEngine(m, 20, device="cpu").generate({"tokens": torch.from_numpy(prompt)},
                               6)
    runs = [(m.cfg, False), (m.cfg.replace(dtype="bfloat16"), True)]
    f32, bf16 = zip(*spawn(fallback_decode, 2, tmp_path / "run", (1, 2), runs, tree, prompt, 6,
                           20))
    for out in f32:
        assert np.array_equal(out["tokens"], toks.numpy())
        assert _leaf_close(out["logits"], logits.numpy(), 5e-6)
    for out in bf16:
        assert out["tokens"].shape == (2, 6) and np.isfinite(out["logits"]).all()
        assert out["dry"]["collectives"] == _wire_as_kinds(out["wire"])
    assert np.array_equal(bf16[0]["tokens"], bf16[1]["tokens"])
    assert tree_paths(m, tree)  # the bridged tree named every leaf

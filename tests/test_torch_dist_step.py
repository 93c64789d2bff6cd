"""Data-parallel gradients and the data-parallel step of the port on two
``gloo`` ranks (``tests/torch_dist_workers.py``), against the reference's
single-device functions, and the contracts of the reference's
``tests/test_dp_step.py``:

* ``dp_value_and_grad_nll`` on the scanned GLOW (2 scales x 2 steps, hidden
  8; ``coupled`` on the reversible walk and ``invertible``, each with its
  reduction overlapped into the backward, ``psum_axis="data"``) and on the
  unrolled ``GLOW_COUPLED`` build (trailing reduction) equals the
  reference's ``value_and_grad_nll`` on the whole batch: the loss within
  1e-6 of its size, each gradient leaf within 1e-4 of its largest entry;
  the overlapped reduction equals the trailing one within 1e-6;
* ``compressed_allreduce``: top-k at ratio 1.0 equals the dense sum and
  leaves no residual; int8 is within its quantization error of the dense
  sum; each rank's sent plus carried equals its gradient plus residual
  (the residual telescopes); each rank's sent and carried parts are the
  reference's ``compress_grads`` of its own gradient;
* the compressed step puts fewer bytes on the wire than the dense step and
  all-reduces no float gradient (only the 4-byte loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_glow as j_build_glow
from repro.core.autodiff import value_and_grad_nll as j_value_and_grad_nll
from repro.optim.compression import compress_grads as j_compress_grads
from repro_torch.core import build_glow
from torch_dist_workers import compressed, dp_grads, spawn, step_wire_bytes
from torch_parity import SEED, grad_errors, make_pair, perturbed, to_jax

torch.set_num_threads(1)

SMALL = dict(n_scales=2, k_steps=2, hidden=8)
SHAPE = (4, 8, 8, 3)


def _leaf_errors(flow, tree, grads, jgrads) -> dict:
    """Each leaf's max |port - ref| over the reference leaf's largest entry."""
    from repro_torch.bridge import tree_paths

    abs_errs = grad_errors(flow, tree, {k: torch.from_numpy(v) for k, v in grads.items()},
                           jgrads)
    ref = tree_paths(flow, jgrads)
    return {k: e / max(float(np.abs(np.asarray(ref[k])).max()), 1e-30)
            for k, e in abs_errs.items()}


def _scanned_case():
    jflow, jparams, flow, tree = make_pair(SMALL, SHAPE)
    return jflow, jparams, flow, tree


@pytest.mark.parametrize("kind,mode", [("scanned", "coupled"), ("scanned", "invertible"),
                                       ("unrolled", "coupled")])
def test_dp_value_and_grad_nll_matches_the_single_device_reference(tmp_path, kind, mode):
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    if kind == "scanned":
        jflow, jparams, flow, tree = _scanned_case()
        build_kw = dict(SMALL, grad_mode=mode, coupled_bwd="reversible")
        psum = "data"
    else:
        jflow = j_build_glow(**SMALL, grad_mode=mode)
        tree = jflow.init(jax.random.PRNGKey(SEED % 1000), jnp.zeros(SHAPE, jnp.float32))
        tree = perturbed(tree, np.random.default_rng(SEED), stacked=False)
        jparams = to_jax(tree)
        flow = build_glow(**SMALL, grad_mode=mode, device="cpu")
        build_kw, psum = dict(SMALL, grad_mode=mode), None
    jloss, jgrads = j_value_and_grad_nll(jflow.forward, jparams, jnp.asarray(x))
    tree_np = jax.tree_util.tree_map(np.asarray, tree)
    outs = spawn(dp_grads, 2, tmp_path, kind, build_kw, tree_np, x, psum)
    for rank, out in enumerate(outs):
        given, trailing = out["given"], out["trailing"]
        assert given["psum_axis"] == psum and trailing["psum_axis"] is None
        for run in (given, trailing):
            assert abs(run["loss"] - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
            errs = _leaf_errors(flow, tree_np, run["grads"], jgrads)
            assert max(errs.values()) <= 1e-4, (rank, errs)
        # overlapped (in the backward) against trailing (after it)
        for k, g in given["grads"].items():
            np.testing.assert_allclose(g, trailing["grads"][k], rtol=0, atol=1e-6, err_msg=k)
        if psum is not None:
            # the overlapped run reduced its gradients in the backward: the
            # only all_reduce after it is the loss's
            n_float = sum(v.size for v in given["grads"].values()) * 4
            assert given["wire"]["by_op"]["all_reduce"] == n_float + 4
    # every rank holds the same reduced gradient
    for k, g in outs[0]["given"]["grads"].items():
        assert np.array_equal(g, outs[1]["given"]["grads"][k]), k


def _shards(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, 6, 10)).astype(np.float32)
    e = (0.1 * rng.standard_normal((2, 6, 10))).astype(np.float32)
    return g, e


@pytest.mark.parametrize("method,ratio", [("topk", 1.0), ("topk", 0.1), ("int8", 0.0)])
def test_compressed_allreduce_parity_and_error_feedback(tmp_path, method, ratio):
    g, e = _shards(0)
    outs = spawn(compressed, 2, tmp_path, g, e, method, ratio)
    dense = (g + e).sum(axis=0)
    red = outs[0]["reduced"]
    assert np.array_equal(red, outs[1]["reduced"])  # the same sum on every rank
    if method == "topk" and ratio == 1.0:
        np.testing.assert_allclose(red, dense, rtol=1e-5, atol=1e-5)
        assert all(float(np.abs(o["err"]).max()) == 0.0 for o in outs)
    if method == "int8":
        scale = float(np.abs(g + e).max()) / 127.0
        assert float(np.abs(red - dense).max()) < 8 * scale + 1e-5
    # telescoping: reduced plus what every rank still carries is the sum
    carried = sum(o["err"] for o in outs)
    np.testing.assert_allclose(red + carried, dense, rtol=1e-4, atol=1e-4)
    # each rank sent what the reference's compress_grads sends of its leaf
    sent = 0.0
    for r, out in enumerate(outs):
        j_sent, j_err = j_compress_grads({"w": jnp.asarray(g[r])}, {"w": jnp.asarray(e[r])},
                                         method, ratio)
        np.testing.assert_allclose(out["err"], np.asarray(j_err["w"]), rtol=0, atol=1e-6)
        sent = sent + np.asarray(j_sent["w"])
    np.testing.assert_allclose(red, sent, rtol=0, atol=1e-5)
    # only compressed payloads crossed: gathers, no all_reduce
    wire = outs[0]["wire"]
    assert "all_reduce" not in wire["by_op"] and wire["by_op"]["all_gather"] > 0
    k = max(1, int(60 * ratio))
    expect = 60 + 4 if method == "int8" else 2 * 4 * k
    assert wire["total"] == expect, wire


def test_compressed_step_reduces_wire_bytes(tmp_path):
    jflow, jparams, flow, tree = _scanned_case()
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    tree_np = jax.tree_util.tree_map(np.asarray, tree)
    outs = spawn(step_wire_bytes, 2, tmp_path, dict(SMALL, grad_mode="coupled",
                                                    coupled_bwd="reversible"),
                 tree_np, x, ("none", "topk", "int8"))
    for out in outs:
        dense = out["none"]["wire"]
        assert dense["by_op"]["all_reduce"] > 10_000, dense
        for method in ("topk", "int8"):
            cb = out[method]["wire"]
            assert cb["total"] < dense["total"], (method, cb, dense)
            # no dense gradient all-reduce: the summed loss alone
            assert cb["by_op"].get("all_reduce", 0) <= 8, (method, cb)
            assert cb["host_staged_total"] == 0  # CPU tensors: nothing staged
    # the replicated update is the same on both ranks
    for method in ("none", "topk", "int8"):
        for k, v in outs[0][method]["params"].items():
            assert np.array_equal(v, outs[1][method]["params"][k]), (method, k)

"""The model-sharded meshes of the port on the LM side, each against the
reference's single-device result, in two-rank ``gloo`` worlds on a (1, 2)
mesh (``tests/torch_dist_workers.py::spawn``):

* the expert-parallel MoE (each model rank runs its half of the experts)
  forward and gradient against ``jax.vjp`` of the reference's ``moe_apply``;
* sequence-parallel attention (``seq_shard``): the prefill without a cache
  and its gradient, a cached prefill and a cached decode step, against the
  reference's ``attn_apply(seq_shard=False)``; the attention output is held
  to 1e-5 of its cancelling sum's size (the sum of |terms| of ``P V Wo``);
  ``impl="flash"`` with ``seq_shard`` still calls ``flash_sdpa``, once a
  rank on the whole query, against the reference's flash path;
* ``ServeEngine`` on granite-moe-1b-a400m ``REDUCED`` (f32, with
  ``attn_seq_shard``): greedy tokens equal to the reference's engine,
  logits within 1e-4 of their scale, 2 of 4 experts a rank;
* ``train_lm`` on the same model against the reference's loop;
* both launchers on ``--mesh 1,2``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import TrainConfig as JTrainConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models.lm import Model as JModel
from repro.nn import attention as jattn
from repro.nn.moe import moe_apply as j_moe_apply
from repro.nn.moe import moe_init as j_moe_init
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.loop import train_lm as j_train_lm
from repro_torch.bridge import params_from_numpy, tree_paths
from repro_torch.config import AttentionConfig, MoEConfig
from repro_torch.models import Model
from torch_dist_workers import (
    attention_mesh,
    launchers_mesh,
    moe_mesh,
    serve_lm_mesh,
    spawn,
    train_lm_mesh,
)
from torch_lm_parity import configs

TOL = 1e-4


def _leaf_close(v, r, tol=TOL):
    r = np.asarray(r, np.float32)
    scale = max(float(np.abs(r).max()), 1.0)
    return float(np.abs(v - r).max()) <= tol * scale


def test_expert_parallel_moe_matches_the_reference_and_its_gradient(tmp_path):
    kw = dict(n_experts=4, top_k=2, d_ff_expert=32)
    jcfg_mod, _ = configs("granite-moe-1b-a400m")
    jcfg = type(jcfg_mod.REDUCED.moe)(**kw)
    d, kind = 32, "swiglu"
    jp = j_moe_init(jax.random.PRNGKey(3), d, jcfg, kind)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    gy = rng.standard_normal((2, 16, d)).astype(np.float32)
    jy, jaux = j_moe_apply(jp, jnp.asarray(x), jcfg, kind)
    (jgp, jgx) = jax.vjp(lambda p, x_: j_moe_apply(p, x_, jcfg, kind)[0], jp,
                         jnp.asarray(x))[1](jnp.asarray(gy))
    flat = {"router": np.asarray(jp["router"]),
            **{f"experts.{k}": np.asarray(v) for k, v in jp["experts"].items()}}
    ref_g = {"x": np.asarray(jgx), "router": np.asarray(jgp["router"]),
             **{f"experts.{k}": np.asarray(v) for k, v in jgp["experts"].items()}}
    outs = spawn(moe_mesh, 2, tmp_path / "run", (1, 2), MoEConfig(**kw), kind, flat, x, gy)
    for out in outs:
        assert _leaf_close(out["y"], jy) and _leaf_close(out["aux"], jaux)
        for name, g in out["grads"].items():
            assert _leaf_close(g, ref_g[name]), name
    for name, g in outs[0]["grads"].items():
        assert np.array_equal(g, outs[1]["grads"][name]), name  # the same on each rank


def _attn_scale(jp, x, cfg, q_pos, kv_pos, k=None, v=None):
    """Each output entry's sum of |terms| of ``P V Wo`` (f64, from the
    reference's projections)."""
    q, k0, v0 = jattn._project_qkv(jp, jnp.asarray(x), cfg, jnp.asarray(q_pos))
    k = k0 if k is None else k
    v = v0 if v is None else v
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    s = np.einsum("bqhgd,bkhd->bhgqk", qg, k) * dh**-0.5
    mask = np.asarray(q_pos)[:, None] >= np.asarray(kv_pos)[None, :]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    pv = np.einsum("bhgqk,bkhd->bqhgd", p, np.abs(v)).reshape(b, sq, hq * dh)
    return pv @ np.abs(np.asarray(jp["wo"], np.float64))


def test_sequence_parallel_attention_matches_the_unsharded_reference(tmp_path):
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16)
    jcfg, cfg = jattn.AttentionConfig(**kw), AttentionConfig(**kw)
    rng = np.random.default_rng(12)
    d, s, pos0, cache_len = 64, 16, 12, 16
    params = {k: (d**-0.5 * rng.standard_normal(sh)).astype(np.float32)
              for k, sh in (("wq", (d, 64)), ("wk", (d, 32)), ("wv", (d, 32)), ("wo", (64, d)))}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    gy = rng.standard_normal((2, s, d)).astype(np.float32)
    pos = np.arange(s)
    fwd = lambda p_, x_: jattn.attn_apply(p_, x_, jcfg, jnp.asarray(pos))[0]  # noqa: E731
    jout, vjp = jax.vjp(fwd, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(gy))
    cache = jattn.make_cache(jcfg, 2, cache_len, jnp.float32)
    jpre, cache = jattn.attn_apply(jp, jnp.asarray(x[:, :pos0]), jcfg, jnp.asarray(pos[:pos0]),
                                   cache=cache, cache_pos=0)
    jdec, cache = jattn.attn_apply(jp, jnp.asarray(x[:, pos0:pos0 + 1]), jcfg,
                                   jnp.asarray(pos[pos0:pos0 + 1]), cache=cache,
                                   cache_pos=pos0)
    scale_out = _attn_scale(jp, x, jcfg, pos, pos)
    scale_dec = _attn_scale(jp, x[:, pos0:pos0 + 1], jcfg, pos[pos0:pos0 + 1],
                            np.arange(cache_len), cache["k"], cache["v"])
    # impl="flash" keeps the kernel under seq_shard: one call on the whole
    # query a rank, against the reference's flash path
    x_flash = rng.standard_normal((2, 128, d)).astype(np.float32)
    jflash, _ = jattn.attn_apply(jp, jnp.asarray(x_flash), jcfg, jnp.arange(128), impl="flash")
    outs = spawn(attention_mesh, 2, tmp_path / "run", (1, 2), cfg, params, x, gy, cache_len,
                 pos0, x_flash)
    ref_g = [np.asarray(jgx)] + [np.asarray(jgp[k]) for k in params]
    for out in outs:
        assert np.all(np.abs(out["out"] - np.asarray(jout)) <= 1e-5 * scale_out + 1e-7)
        assert np.all(np.abs(out["decode"] - np.asarray(jdec)) <= 1e-5 * scale_dec + 1e-7)
        assert _leaf_close(out["cached_prefill"], jpre, 1e-5)
        assert out["flash_calls"] == [(2, 4, 128, 16)]
        np.testing.assert_allclose(out["flash"], np.asarray(jflash), rtol=0, atol=1e-5)
        for g, r in zip(out["grads"], ref_g):
            assert _leaf_close(g, r)
    for a, b in zip(outs[0]["grads"], outs[1]["grads"]):
        assert np.array_equal(a, b)


def _granite():
    jmod, pmod = configs("granite-moe-1b-a400m")
    jcfg = jmod.REDUCED.replace(dtype="float32")
    pcfg = pmod.REDUCED.replace(dtype="float32", attn_seq_shard=True)
    jm = JModel(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    return jm, jcfg, pcfg, tree


def test_serve_engine_on_a_model_sharded_mesh_matches_the_reference(tmp_path):
    jm, jcfg, pcfg, tree = _granite()
    rng = np.random.default_rng(13)
    prompt = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)}
    max_new, max_len = 6, 24
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jtok, jlog = JServeEngine(jm, jp, max_len).generate(
        {"tokens": jnp.asarray(prompt["tokens"])}, max_new)
    _, jfirst = JServeEngine(jm, jp, max_len).generate(
        {"tokens": jnp.asarray(prompt["tokens"])}, 1)
    outs = spawn(serve_lm_mesh, 2, tmp_path / "run", (1, 2), pcfg, tree, prompt, max_new,
                 max_len)
    n_params = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(tree))
    for out in outs:
        np.testing.assert_array_equal(out["tokens"], np.asarray(jtok))
        assert _leaf_close(out["logits"], jlog) and _leaf_close(out["first_logits"], jfirst)
        assert set(out["experts_run"]) == {2}  # 4 experts over 2 model ranks
        assert out["stored"] < 0.6 * n_params


def test_train_lm_on_a_model_sharded_mesh_matches_the_reference(tmp_path):
    jm, jcfg, pcfg, tree = _granite()
    cfg = dict(steps=2, lr=1e-3, warmup_steps=1)
    data_kw = dict(vocab=jcfg.vocab_size, seq_len=16, batch=4, seed=1)
    jres = j_train_lm(jm, JSyntheticTokens(**data_kw),
                      JTrainConfig(**cfg, prefetch=0, checkpoint_dir=str(tmp_path / "jck")),
                      rng=jax.random.PRNGKey(3))
    batches = [{k: np.asarray(v) for k, v in JSyntheticTokens(**data_kw).batch_at(s).items()}
               for s in range(cfg["steps"])]
    outs = spawn(train_lm_mesh, 2, tmp_path / "run", (1, 2), pcfg, tree, cfg, batches)
    ref = tree_paths(params_from_numpy(Model(pcfg, device="cpu"), tree),
                     jax.tree_util.tree_map(np.asarray, jres.params))
    for out in outs:
        np.testing.assert_allclose(out["losses"], jres.losses, rtol=TOL)
        for key, v in out["params"].items():
            assert _leaf_close(v, ref[key]), key
        assert out["shard_bytes"]["params"] < 0.6 * out["shard_bytes"]["params_whole"]


def test_launchers_on_a_model_sharded_mesh(tmp_path):
    outs = spawn(launchers_mesh, 2, tmp_path / "run", "1,2")
    for r, out in enumerate(outs):
        assert f"mesh=1x2 backend=gloo rank={r}/2" in out
        assert "arch=granite-moe-1b-a400m-reduced" in out and "done at step 1" in out
        assert "mesh=1x2: generated (2, 4) tokens" in out
        assert "scenario=images-prior-scanned" in out
    assert outs[0].splitlines()[-5:] != []

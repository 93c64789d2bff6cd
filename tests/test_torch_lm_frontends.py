"""whisper-small (encoder-decoder: the audio front end, the encoder, cross
attention) and llava-next-34b (the vision front end: projected patches
before the text) from the port against the JAX reference on the CPU, at the
reference's ``REDUCED`` widths: ``frontend_apply`` and ``cross_kv`` alone,
serving (``prefill``, ``decode_step``, ``ServeEngine.generate``) and
``train_loss`` with every gradient leaf, the encoder's and the front end's
included; the ported ``input_specs`` / ``batch_like`` against the
reference's; the configurations and the launchers.  Parameters are the
reference's ``init`` with its constant leaves perturbed
(``torch_lm_parity.perturbed``), carried across by
``bridge.params_from_numpy``.

Tolerances, as ``max |a - b| <= tol * max |b|``:

* ``frontend_apply``, ``cross_kv`` and cross attention alone: 1e-6 in f32
  (measured up to ~3e-7), 2e-2 in bf16 (a bf16 ulp of the largest entry);
* serving: 1e-5 in f32 (measured up to ~1.1e-6) and 3e-2 at the default
  bf16 activations, as ``test_torch_lm.py`` holds yi-6b; greedy tokens
  equal in f32;
* training, in f32: the loss at 1e-5 (measured 0), each gradient leaf at
  1e-4 of its largest entry (measured, against the reference in the same
  mode: ``invertible`` up to 1.1e-5, ``autodiff`` up to 2.0e-6); whisper's
  cross-attention biases, which neither package reads, are zero in both;
  ``coupled`` and ``remat`` are held to the port's own ``autodiff``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttentionConfig
from repro.config import ShapeSpec as JShapeSpec
from repro.models.frontends import frontend_apply as j_frontend_apply
from repro.models.frontends import frontend_init as j_frontend_init
from repro.models.registry import input_specs as j_input_specs
from repro.nn.attention import attn_apply as j_attn_apply
from repro.nn.attention import attn_init as j_attn_init
from repro.nn.attention import cross_kv as j_cross_kv
from repro.nn.norm import rmsnorm as j_rmsnorm
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import tree_to_numpy
from repro_torch.config import AttentionConfig, ShapeSpec, get_arch, list_archs
from repro_torch.configs import UNPORTED_ARCHS
from repro_torch.models import build_model
from repro_torch.models.frontends import VISION_EMBED_DIM, frontend_apply
from repro_torch.models.registry import SpecBatches, batch_like, input_specs
from repro_torch.nn.attention import attn_apply, cross_kv
from repro_torch.serve.engine import ServeEngine
from torch_lm_parity import (SEED, configs, leaf_errors, make_pair, port_loss_grad,
                             ref_loss_grad, token_batch)

torch.set_num_threads(4)
ARCHS = ("whisper-small", "llava-next-34b")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_OP = {"float32": 1e-6, "bfloat16": 2e-2}
TOL_LOSS, TOL_LEAF = 1e-5, 1e-4
PROMPT, NEW = 12, 6
SOURCES = {"whisper-small": "arXiv:2212.04356",
           "llava-next-34b": "hf:llava-hf/llava-v1.6-mistral-7b-hf"}
CROSS_BIASES = ("blocks.cross_attn.attn.bq", "blocks.cross_attn.attn.bk",
                "blocks.cross_attn.attn.bv")


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _n_prefix(cfg) -> int:
    return cfg.frontend.n_patches if cfg.frontend.kind == "vision" else 0


def _features(cfg, batch: int, seed: int) -> dict:
    """The model's modality features, f32 numpy, standard normal."""
    rng = np.random.default_rng(seed)
    if cfg.frontend.kind == "vision":
        shape = (batch, cfg.frontend.n_patches, VISION_EMBED_DIM)
        return {"patches": rng.standard_normal(shape).astype(np.float32)}
    shape = (batch, cfg.frontend.n_frames, cfg.d_model)
    return {"frames": rng.standard_normal(shape).astype(np.float32)}


def _prompt(cfg, seed: int) -> dict:
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, PROMPT))
    return {"tokens": tokens.astype(np.int32), **_features(cfg, 2, seed + 1)}


def _train_batch(cfg, seed=SEED) -> dict:
    return {**token_batch(cfg.vocab_size, 2, 16, seed), **_features(cfg, 2, seed + 7)}


def _ref_enc(jm, jp, frames):
    """The reference engine's encoder pass for decode
    (``src/repro/serve/engine.py:72-84``)."""
    cfg = jm.cfg
    h = j_frontend_apply(jp["frontend"], frames, cfg)
    enc, _ = jm._stack_nocache(jm.enc_layout.main, jp["encoder"], h, None, h.shape[1], "autodiff")
    return j_rmsnorm(enc, jp["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# the front ends and cross attention alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_apply_matches_the_reference(arch, dtype):
    jmod, pmod = configs(arch)
    jcfg, cfg = jmod.REDUCED.replace(dtype=dtype), pmod.REDUCED.replace(dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray, j_frontend_init(jax.random.PRNGKey(3), jcfg))
    jp["norm"] = jp["norm"] + 0.1 * np.random.default_rng(4).standard_normal(
        jp["norm"].shape).astype(np.float32)
    feats = next(iter(_features(cfg, 2, 5).values()))
    ref = j_frontend_apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(feats), jcfg)
    out = frontend_apply({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                         torch.from_numpy(feats), cfg)
    assert out.dtype == getattr(torch, dtype) and out.shape == (*feats.shape[:2], cfg.d_model)
    assert _rel(out, ref) <= TOL_OP[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cross_kv_and_cross_attention_match_the_reference(dtype, causal):
    """``cross_kv`` (no bias, keys turned at frame positions) and
    ``attn_apply(kv_override=)`` (the query unbiased, turned at the decoder's
    positions; a causal config masks ``q_pos >= kv_pos``), with ``qkv_bias``
    biases drawn nonzero so that their absence shows."""
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True, causal=causal)
    jcfg, cfg = JAttentionConfig(**kw), AttentionConfig(**kw)
    rng = np.random.default_rng(SEED)
    jp = jax.tree_util.tree_map(np.asarray, j_attn_init(jax.random.PRNGKey(1), 64, jcfg))
    for k in ("bq", "bk", "bv"):
        jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    enc = rng.standard_normal((2, 10, 64)).astype(np.float32)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    jdt, dt = jnp.dtype(dtype), getattr(torch, dtype)
    jkv = j_cross_kv(jp, jnp.asarray(enc, jdt), jcfg)
    kv = cross_kv(p, torch.from_numpy(enc).to(dt), cfg)
    for a, b in zip(kv, jkv):
        assert (a.dtype == torch.int64 or a.dtype == dt) and _rel(a, b) <= TOL_OP[dtype]
    pos = np.arange(3, 9)  # decoder positions past the first frames
    jout, _ = j_attn_apply(jp, jnp.asarray(x, jdt), jcfg, jnp.asarray(pos), kv_override=jkv)
    out, cache = attn_apply(p, torch.from_numpy(x).to(dt), cfg, torch.from_numpy(pos),
                            kv_override=kv)
    assert cache is None and _rel(out, jout) <= TOL_OP[dtype]


# ---------------------------------------------------------------------------
# the models served and trained
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,reversible", [("float32", True), ("float32", False),
                                              ("bfloat16", True)])
def test_prefill_and_decode_match_the_reference(arch, dtype, reversible):
    """Prefill, then three decode steps fed the reference's greedy tokens
    (whisper's with the encoder output each package computes for decode):
    logits and the self-attention caches agree at every step."""
    jm, jp, m, _ = make_pair(arch, dtype=dtype, reversible=reversible)
    cfg = m.cfg
    batch = _prompt(cfg, 1)
    max_len = _n_prefix(cfg) + PROMPT + 4
    jlog, jc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jm.make_caches(2, max_len))
    log, c = m.prefill({k: torch.from_numpy(v) for k, v in batch.items()},
                       m.make_caches(2, max_len))
    assert log.dtype == torch.float32 and log.shape == (2, cfg.vocab_size)
    assert _rel(log, jlog) <= TOL[dtype]
    jextra = extra = None
    if cfg.is_enc_dec:
        jextra = {"enc": _ref_enc(jm, jp, jnp.asarray(batch["frames"]))}
        with torch.inference_mode():
            extra = {"enc": m.encode(torch.from_numpy(batch["frames"]))}
        assert _rel(extra["enc"], jextra["enc"]) <= TOL[dtype]
    decode_step = jax.jit(jm.decode_step)
    pos0 = _n_prefix(cfg) + PROMPT
    for i in range(3):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jc = decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos0 + i, jnp.int32), jextra)
        log, c = m.decode_step(torch.from_numpy(nxt), c, pos0 + i, extra)
        assert _rel(log, jlog) <= TOL[dtype], f"decode step {i}"
    unit = "self_attn" if cfg.is_enc_dec else "attn"
    for key in ("k", "v"):
        assert _rel(c["blocks"][unit][key], jc["blocks"][unit][key]) <= TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference(arch):
    """``ServeEngine.generate`` computes whisper's encoder output once (the
    reference runs it again for decode) and starts llava's decode positions
    after the patches; caches sized for the prefix, the prompt and the new
    tokens."""
    jm, jp, m, _ = make_pair(arch, dtype="float32")
    batch = _prompt(m.cfg, 2)
    max_len = _n_prefix(m.cfg) + PROMPT + NEW
    jtok, jlog = JServeEngine(jm, jp, max_len).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, NEW)
    tok, log = ServeEngine(m, max_len, device="cpu").generate(batch, NEW)
    assert _rel(log, jlog) <= TOL["float32"]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["invertible", "autodiff"])
def test_train_loss_and_gradients_match_the_reference(arch, mode):
    """Every leaf, the front end's and (whisper) the encoder's included: the
    encoder output reaches every decoder layer's cross attention, and its
    cotangent is summed over them.  whisper's cross-attention biases are
    read by neither package: zero in both."""
    jm, jp, m, tree = make_pair(arch, dtype="float32")
    batch = _train_batch(m.cfg)
    ref_loss, ref_grads = ref_loss_grad(jm, jp, batch, mode)
    loss, grads = port_loss_grad(m, batch, mode)
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    errs = leaf_errors(m, tree, grads, ref_grads)
    assert max(errs.values()) <= TOL_LEAF, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert float(grads["frontend.proj"].abs().max()) > 0
    if arch == "whisper-small":
        enc = [k for k in grads if k.startswith("encoder.")]
        assert len(enc) == 13 and all(float(grads[k].abs().max()) > 0 for k in enc)
        for k in CROSS_BIASES:
            assert float(grads[k].abs().max()) == 0.0
            leaf = ref_grads["blocks"]["cross_attn"]["attn"][k.rsplit(".", 1)[1]]
            assert float(np.abs(leaf).max()) == 0.0
        others = [k for k in grads if k not in CROSS_BIASES]
        assert all(float(grads[k].abs().max()) > 0 for k in others)


@pytest.mark.parametrize("arch", ARCHS)
def test_coupled_and_remat_match_the_ports_autodiff(arch):
    _, _, m, tree = make_pair(arch, dtype="float32")
    batch = _train_batch(m.cfg, seed=3)
    ad_loss, ad_grads = port_loss_grad(m, batch, "autodiff")
    for mode in ("coupled", "remat"):
        loss, grads = port_loss_grad(m, batch, mode)
        assert abs(loss - ad_loss) <= TOL_LOSS * abs(ad_loss), mode
        errs = leaf_errors(m, tree, grads, ad_grads)
        assert max(errs.values()) <= TOL_LEAF, (mode, max(errs.items(), key=lambda kv: kv[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_exact(arch):
    _, _, m, tree = make_pair(arch)
    back = tree_to_numpy(m, like=tree)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                     jax.tree_util.tree_leaves(back)))


# ---------------------------------------------------------------------------
# inputs, configurations, launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ("yi-6b",))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(arch, kind):
    """The same keys, shapes and dtypes as the reference's
    ``ShapeDtypeStruct`` stand-ins (meta tensors here), full size and
    ``REDUCED``; ``batch_like`` draws them, seeded."""
    for which in ("config", "reduced"):
        jcfg, cfg = (getattr(mod, "CONFIG" if which == "config" else "REDUCED")
                     for mod in configs(arch))
        shape = (2048, 8, kind)
        jspecs = j_input_specs(jcfg, JShapeSpec("cell", *shape))
        specs = input_specs(cfg, ShapeSpec("cell", *shape))
        assert list(specs) == list(jspecs)
        for key, v in specs.items():
            assert v.device.type == "meta" and tuple(v.shape) == tuple(jspecs[key].shape)
            assert str(v.dtype).removeprefix("torch.") == str(jspecs[key].dtype)
    reduced = input_specs(cfg, ShapeSpec("cell", 24, 2, kind))
    a = batch_like(reduced, torch.Generator().manual_seed(1), cfg.vocab_size)
    b = batch_like(reduced, torch.Generator().manual_seed(1), cfg.vocab_size)
    for key, v in a.items():
        assert v.shape == reduced[key].shape and v.dtype == reduced[key].dtype
        assert torch.equal(v, b[key])
        if not v.is_floating_point():
            assert int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size


def test_input_specs_refuse_a_sequence_the_patches_fill():
    cfg = get_arch("llava-next-34b").config
    with pytest.raises(ValueError, match="no text"):
        input_specs(cfg, ShapeSpec("cell", 576, 1, "train"))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_registry_match_the_reference(arch):
    jmod, pmod = configs(arch)
    assert dataclasses.asdict(pmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(pmod.REDUCED) == dataclasses.asdict(jmod.REDUCED)
    assert pmod.CONFIG.param_count() == jmod.CONFIG.param_count()
    spec = get_arch(arch)
    assert spec.config == pmod.CONFIG and spec.reduced == pmod.REDUCED
    assert spec.source == SOURCES[arch] and arch in list_archs() and not UNPORTED_ARCHS
    model, cfg = build_model(spec.reduced, device="cpu")
    assert model.frontend.proj.shape[1] == cfg.d_model
    assert (model.enc_layout is not None) == (arch == "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_train_and_serve_reduced(arch, tmp_path, capsys):
    """``--arch`` training on ``SpecBatches`` (the reference's launcher
    builds tokens alone), then serving from its checkpoint with seeded
    features and caches sized for the prefix."""
    from repro_torch.launch import serve, train

    ckpt = str(tmp_path / "lm")
    train.main(["--arch", arch, "--reduced", "--steps", "2", "--seq", "24", "--batch", "2",
                "--device", "cpu", "--ckpt", ckpt])
    assert "done at step 1" in capsys.readouterr().out
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                "--max-new", "4", "--device", "cpu", "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "restored step 1" in out and "generated (2, 4) tokens" in out


def test_spec_batches_are_pure_functions_of_the_step():
    cfg = get_arch("whisper-small").reduced
    data = SpecBatches(cfg, ShapeSpec("t", 16, 2, "train"), seed=3)
    a, b, c = data.batch_at(4), data.batch_at(4), data.batch_at(5)
    assert list(a) == ["frames", "tokens", "labels"]
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["frames"], c["frames"])

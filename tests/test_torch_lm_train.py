"""LM training in the port against the JAX reference on the CPU: the SSM
families' ``train_loss`` (rwkv6-7b; zamba2-7b with its shared attention and
FFN, whose gradients are summed over the superblocks, and its tail), the
reversible engines against plain autograd for every ported architecture,
the chunked cross-entropy, saved-tensor bytes against depth (the paper's
claim), ``SyntheticTokens`` and ``train_lm`` (the loss falls; a restart
reproduces an uninterrupted run).  Models are the reference's ``REDUCED``
widths; parameters the reference's ``init`` with its constant leaves
perturbed (``torch_lm_parity.perturbed``).

Tolerances, in f32, as ``max |a - b| <= tol * max |b|``: the loss at 1e-5
(measured up to 1.5e-7), each gradient leaf at 1e-4 of its largest entry
(measured against the reference in the same mode: ``invertible`` up to
6.8e-5, rwkv6-7b's ``time_mix.norm``, rebuilt through its time mix's
inverse; ``autodiff`` up to 3.2e-5); ``coupled`` and ``remat`` against the
port's own ``autodiff`` (measured up to 6.9e-5 and 0).  The ports of the
reference's ``test_reversible_matches_standard_gradients`` and of its
memory test keep their own bounds (5e-3 absolute; saved bytes at depth 8
within 1.2x of depth 2 under ``invertible``, over 1.8x under
``autodiff``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models.losses import chunked_softmax_xent as j_xent
from repro_torch.config import ShapeSpec, TrainConfig, get_arch
from repro_torch.core.autodiff import make_chain_apply
from repro_torch.data import SyntheticTokens, make_dataset
from repro_torch.models import build_model
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.models.registry import SpecBatches
from repro_torch.train.fault import FailureInjector
from repro_torch.train.loop import train_lm
from torch_lm_parity import (MODULES, SEED, leaf_errors, make_pair, port_loss_grad,
                             ref_loss_grad, token_batch)

torch.set_num_threads(4)
SSM = ("rwkv6-7b", "zamba2-7b")
TOL_LOSS, TOL_LEAF = 1e-5, 1e-4


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("mode", ["invertible", "autodiff"])
def test_train_loss_and_gradients_match_the_reference(arch, mode):
    """zamba2's sequence is 16, a multiple of its scan's chunk."""
    jm, jp, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16)
    ref_loss, ref_grads = ref_loss_grad(jm, jp, batch, mode)
    loss, grads = port_loss_grad(m, batch, mode)
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    errs = leaf_errors(m, tree, grads, ref_grads)
    assert max(errs.values()) <= TOL_LEAF, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    if arch == "zamba2-7b":
        shared = [k for k in grads if k.startswith(("shared_attn.", "shared_ffn."))]
        assert len(shared) == 7 and all(float(grads[k].abs().max()) > 0 for k in shared)
        assert all(errs[k] <= TOL_LEAF for k in shared)
        assert float(grads["tail_blocks.mamba0.mamba.wx"].abs().max()) > 0


@pytest.mark.parametrize("arch", SSM)
def test_coupled_and_remat_match_the_ports_autodiff(arch):
    _, _, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 16, seed=3)
    ad_loss, ad_grads = port_loss_grad(m, batch, "autodiff")
    for mode in ("coupled", "remat"):
        loss, grads = port_loss_grad(m, batch, mode)
        assert abs(loss - ad_loss) <= TOL_LOSS * abs(ad_loss), mode
        errs = leaf_errors(m, tree, grads, ad_grads)
        assert max(errs.values()) <= TOL_LEAF, (mode, max(errs.items(), key=lambda kv: kv[1]))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_reversible_matches_standard_gradients(name):
    """The port of the reference's ``tests/test_arch_smoke.py`` case of this
    name, at its bound: the paper's engine gives the same gradients as plain
    autograd on the same reversible weights (``REDUCED``, f32)."""
    model, cfg = build_model(get_arch(name).reduced, device="cpu", dtype="float32",
                             residual_dtype="float32")
    if cfg.frontend is None:
        batch = SyntheticTokens(cfg.vocab_size, 16, 2, seed=SEED % 97).batch_at(0)
    else:  # the modality features too, as the reference's input_specs name them
        batch = SpecBatches(cfg, ShapeSpec("s", 16, 2, "train"), seed=SEED % 97).batch_at(0)
    params = list(model.parameters())

    def grads(mode):
        # whisper's cross-attention biases are unused: None, zero in the reference
        gs = torch.autograd.grad(model.train_loss(batch, grad_mode=mode)[0], params,
                                 allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]

    g_inv, g_ad = grads("invertible"), grads("autodiff")
    worst = max(float((a - b).abs().max()) for a, b in zip(g_inv, g_ad))
    assert worst < 5e-3, f"{name}: worst grad diff {worst}"


def _saved_bytes(arch: str, n_layers: int, mode: str) -> int:
    """Bytes of the tensors one ``train_loss`` forward saves for its
    backward (``saved_tensors_hooks``), batch 2 x 32."""
    model, cfg = build_model(get_arch(arch).reduced, device="cpu", n_layers=n_layers,
                             generator=torch.Generator().manual_seed(0))
    batch = SyntheticTokens(cfg.vocab_size, 32, 2, seed=1).batch_at(0)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.train_loss(batch, grad_mode=mode)
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    return total[0]


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_reversible_lm_memory_flat_in_depth(arch):
    """The port of the reference's ``tests/test_system.py``
    ``test_reversible_lm_memory_flat_in_depth`` (there: XLA's temporary
    bytes; here: the bytes autograd saves): flat in depth under
    ``invertible``, growing under ``autodiff``."""
    inv = [_saved_bytes(arch, n, "invertible") for n in (2, 8)]
    ad = [_saved_bytes(arch, n, "autodiff") for n in (2, 8)]
    assert inv[1] <= inv[0] * 1.2, f"reversible LM memory grew with depth: {inv}"
    assert ad[1] > ad[0] * 1.8, f"AD LM memory should grow with depth: {ad}"


@pytest.mark.parametrize("seq,chunk", [(16, 512), (20, 8), (24, 8)])
def test_chunked_softmax_xent_matches_the_reference(seq, chunk):
    """Value and gradients (of h and the head) against the reference, with a
    padded last chunk (20 over chunks of 8) and ignored labels (-1)."""
    rng = np.random.default_rng(SEED)
    h = rng.standard_normal((2, seq, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, seq)).astype(np.int32)
    labels[0, :3] = -1
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h_, w_: j_xent(h_, w_, jnp.asarray(labels), chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = chunked_softmax_xent(ht, wt, torch.from_numpy(labels), chunk=chunk)
    gh, gw = torch.autograd.grad(loss, [ht, wt])
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=0, atol=1e-6)
    with torch.no_grad():
        assert chunked_softmax_xent(ht, wt, torch.from_numpy(labels), chunk=chunk) == loss


def _follows_rule(tokens: np.ndarray, labels: np.ndarray, vocab: int) -> float:
    """The share of next tokens that follow each row's affine step (its most
    common difference, which must be one of the rule's 7..11; a reset breaks
    the rule for itself and the token after)."""
    seq = np.concatenate([tokens, labels[:, -1:]], axis=1).astype(np.int64)
    diffs = (seq[:, 1:] - seq[:, :-1]) % vocab
    steps = np.array([np.bincount(row).argmax() for row in diffs])
    assert set(steps) <= set(range(7, 12)), steps
    return float((diffs == steps[:, None]).mean())


def test_synthetic_tokens_follow_the_references_rule():
    """The same affine rule and noise as the reference (drawn from another
    generator), a pure function of (seed, step, shard); registered as
    ``"tokens"``."""
    data = SyntheticTokens(384, 64, 8, seed=3)
    b = data.batch_at(5)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (8, 64)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    again = make_dataset("tokens", vocab=384, seq_len=64, batch=8, seed=3).batch_at(5)
    assert torch.equal(b["tokens"], again["tokens"]) and torch.equal(b["labels"], again["labels"])
    assert not torch.equal(b["tokens"], data.batch_at(6)["tokens"])
    assert not torch.equal(b["tokens"], data.batch_at(5, shard=1, n_shards=2)["tokens"][:4])
    assert data.batch_at(5, shard=1, n_shards=2)["tokens"].shape == (4, 64)
    big = SyntheticTokens(384, 64, 64, seed=3).batch_at(5)
    jb = JSyntheticTokens(384, 64, 64, seed=3).batch_at(5)
    ours = _follows_rule(big["tokens"].numpy(), big["labels"].numpy(), 384)
    ref = _follows_rule(np.asarray(jb["tokens"]), np.asarray(jb["labels"]), 384)
    # noise 0.05: a pair follows the rule with probability about 0.95^2; the
    # shares of both streams vary by about 0.015 from draw to draw
    assert 0.85 < ours < 0.95 and 0.85 < ref < 0.95 and abs(ours - ref) < 0.05


def _tiny(tmp_path, steps=8, ckpt_every=3, arch="yi-6b", **cfg_kw):
    model, cfg = build_model(get_arch(arch).reduced, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    data = SyntheticTokens(cfg.vocab_size, seq_len=16, batch=4, seed=1)
    tcfg = TrainConfig(steps=steps, lr=1e-3, warmup_steps=2, checkpoint_every=ckpt_every,
                       checkpoint_dir=str(tmp_path / "ckpt"), **cfg_kw)
    return model, data, tcfg


def test_loss_decreases(tmp_path):
    """The reference's ``tests/test_train.py`` case: yi-6b ``REDUCED`` (bf16
    activations) over 30 steps of ``train_lm``."""
    model, data, tcfg = _tiny(tmp_path, steps=30, ckpt_every=100)
    res = train_lm(model, data, tcfg, device="cpu")
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.1, f"no learning: {first} -> {last}"


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_restart_reproduces_uninterrupted_run(tmp_path, arch):
    """Killed at step 5 and restarted from its step-4 checkpoint, the run
    ends bit for bit where the uninterrupted one does (the reference holds
    1e-5)."""
    model, data, tcfg = _tiny(tmp_path / "a", steps=10, ckpt_every=2, arch=arch)
    clean = train_lm(model, data, tcfg, device="cpu")
    model2, data2, tcfg2 = _tiny(tmp_path / "b", steps=10, ckpt_every=2, arch=arch, prefetch=0)
    res = train_lm(model2, data2, tcfg2, device="cpu", injector=FailureInjector(fail_at=(5,)))
    assert res.restarts == 1 and res.final_step == 9
    assert all(torch.equal(clean.params[k], res.params[k]) for k in clean.params)
    assert clean.losses[6:] == res.losses[-4:]


def test_ssm_trains_on_the_cpu_and_accumulation_matches(tmp_path):
    """rwkv6-7b trains through ``train_lm`` on the CPU (its plain scans);
    two microbatches give the whole batch's step within f32 round-off."""
    model, data, tcfg = _tiny(tmp_path / "a", steps=2, ckpt_every=100, arch="rwkv6-7b")
    whole = train_lm(model, data, tcfg, device="cpu")
    model2, data2, tcfg2 = _tiny(tmp_path / "b", steps=2, ckpt_every=100, arch="rwkv6-7b",
                                 accum_steps=2)
    halves = train_lm(model2, data2, tcfg2, device="cpu")
    assert np.isfinite(whole.losses).all() and abs(whole.losses[0] - halves.losses[0]) < 1e-2
    worst = max(float((whole.params[k].float() - halves.params[k].float()).abs().max())
                for k in whole.params)
    assert worst < 1e-3


def test_train_launcher_refuses_an_ssm_on_the_card_before_building_it(tmp_path, capsys):
    """The name is kept from when the launcher refused rwkv6-7b on the card.
    Now the SSMs train on either device through their plain scans, so the
    same path runs to the end: ``--arch rwkv6-7b --reduced --device cpu``
    trains, checkpoints, and a second call resumes at its final step."""
    from repro_torch.launch import train

    argv = ["--arch", "rwkv6-7b", "--reduced", "--steps", "3", "--seq", "16", "--batch", "2",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    train.main(argv)
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b-reduced" in out and "done at step 2" in out
    train.main(argv)
    assert "already at step 2" in capsys.readouterr().out


def test_scan_engine_modes():
    """``remat`` is a scan-engine mode only; the chain engine refuses it."""
    with pytest.raises(ValueError, match="grad_mode"):
        make_chain_apply([], "remat")
    model, cfg = build_model(get_arch("yi-6b").reduced, device="cpu")
    with pytest.raises(ValueError, match="grad_mode"):
        model.train_loss(SyntheticTokens(cfg.vocab_size, 8, 1).batch_at(0), grad_mode="nope")


def test_adamw_by_slices_gives_the_same_bits(monkeypatch):
    """AdamW updates a large leaf in slices of its leading axis (one row at
    a time, or several): the same parameters and moments, bit for bit, as
    the whole leaf."""
    from repro_torch.optim import adamw, adamw_init, adamw_update

    model, cfg = build_model(get_arch("granite-moe-1b-a400m").reduced, device="cpu")
    batch = SyntheticTokens(cfg.vocab_size, 16, 2, seed=4).batch_at(0)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(model.train_loss(batch)[0], list(named.values()))))
    results = []
    for limit in (1 << 30, 1, 100):
        monkeypatch.setattr(adamw, "_SLICE_ELEMS", limit)
        params = {n: p.detach().clone() for n, p in named.items()}
        opt = adamw_init(params)
        for _ in range(2):
            opt, _ = adamw_update(params, grads, opt, TrainConfig(), 1e-3)
        results.append((params, opt))
    (p1, o1), *others = results
    for p2, o2 in others:
        assert all(torch.equal(p1[n], p2[n]) and torch.equal(o1["mu"][n], o2["mu"][n])
                   and torch.equal(o1["nu"][n], o2["nu"][n]) for n in p1)

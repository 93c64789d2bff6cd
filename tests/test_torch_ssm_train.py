"""SSM training (rwkv6-7b, zamba2-7b) and the scans' route, on the CPU.

The route is one rule, ``nn/ssm.py::scan_on_kernel``: a mixer that carries a
recurrent state (serving) on a CUDA device launches the scan kernel; a mixer
without one (training) runs the plain scan, on either device, as the
reference trains through ``lax.scan``.  This host has no card, so the rule
is held as a pure function, and the models' use of it with a stand-in card:
the route is patched to read "cuda" and the kernel wrappers to count their
calls and run their plain versions.  Then: serving launches one scan per
layer and call, training (``invertible``, whose forward runs without grad
and whose rebuild runs under grad, and ``autodiff``) launches none, and a
kernel that fails is not caught.  The models train through ``train_lm`` on
the CPU against the reference (``REDUCED``, f32), a
restart reproduces the uninterrupted run bit for bit, and the bytes autograd
saves stay flat in depth under ``invertible``.

Tolerances, in f32, as ``max |a - b| <= tol * max |b|``: the loss at 1e-5 and
each gradient leaf at 1e-4 of its largest entry, against the reference in
the same engine (``test_torch_lm_train.py``'s gates); the stand-in card's
results equal the CPU's bit for bit (the same plain code runs).  Saved bytes:
depth 8 within 1.2x of depth 2 under ``invertible``, over 1.8x under
``autodiff`` (``test_torch_lm_train.py``'s bounds).
"""

import numpy as np
import pytest
import torch

from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.rwkv import ops as rwkv_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import build_model
from repro_torch.nn import ssm
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.fault import FailureInjector
from repro_torch.train.loop import train_lm
from torch_lm_parity import leaf_errors, make_pair, port_loss_grad, ref_loss_grad, token_batch

torch.set_num_threads(4)
SSM = ("rwkv6-7b", "zamba2-7b")
TOL_LOSS, TOL_LEAF = 1e-5, 1e-4
#: the scan each architecture's mixers launch on the card
SCAN = {"rwkv6-7b": (rwkv_ops, "rwkv6_wkv"), "zamba2-7b": (ssd_ops, "mamba2_ssd")}


@pytest.mark.parametrize("state,device,kernel", [
    ({"wkv": 0}, "cuda", True),
    ({"wkv": 0}, "cuda:1", True),
    (None, "cuda", False),
    ({"wkv": 0}, "cpu", False),
    (None, "cpu", False),
    ({}, "meta", True),
    (None, "meta", False),
])
def test_scan_route_is_a_pure_function(state, device, kernel):
    """A state on CUDA or on the meta device (the dry run reckons the card's
    route): the kernel; no state, or the CPU: the plain scan.  Whether a
    gradient is asked for does not enter."""
    assert ssm.scan_on_kernel(state, torch.device(device)) is kernel
    with torch.no_grad():
        assert ssm.scan_on_kernel(state, torch.device(device)) is kernel


def _stand_in_card(monkeypatch, arch):
    """Route as on a card and count the scan wrapper's calls; the wrapper
    still runs its plain version on these CPU tensors."""
    module, name = SCAN[arch]
    real, calls = getattr(module, name), []

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    monkeypatch.setattr(ssm, "scan_on_kernel", lambda state, device: state is not None)
    return calls


def _scans_per_call(cfg) -> int:
    """The scan launches of one prefill: one per RWKV time mix, one per
    Mamba2 block."""
    return cfg.n_layers


@pytest.mark.parametrize("arch", SSM)
def test_serving_takes_the_kernel_and_training_the_plain_scan(monkeypatch, arch):
    """With the stand-in card: a prefill launches one scan per layer, and
    each of ``generate``'s three decode steps one per RWKV layer (Mamba2's
    decode is the plain recurrence);
    a train step under ``invertible`` and ``autodiff`` launches none, and
    its loss and gradients are the CPU's bits."""
    model, cfg = build_model(get_arch(arch).reduced, device="cpu", dtype="float32",
                             generator=torch.Generator().manual_seed(0))
    batch = SyntheticTokens(cfg.vocab_size, 16, 2, seed=1).batch_at(0)
    params = list(model.parameters())
    ref = {mode: torch.autograd.grad(model.train_loss(batch, grad_mode=mode)[0], params)
           for mode in ("invertible", "autodiff")}
    tokens_ref, _ = ServeEngine(model, 20, device="cpu").generate({"tokens": batch["tokens"]}, 3)
    calls = _stand_in_card(monkeypatch, arch)
    for mode, grads in ref.items():
        got = torch.autograd.grad(model.train_loss(batch, grad_mode=mode)[0], params)
        assert calls == [], f"{mode}: a train step launched {len(calls)} scans"
        assert all(torch.equal(a, b) for a, b in zip(got, grads)), mode
    tokens, _ = ServeEngine(model, 20, device="cpu").generate({"tokens": batch["tokens"]}, 3)
    decode = _scans_per_call(cfg) if arch == "rwkv6-7b" else 0
    assert len(calls) == _scans_per_call(cfg) + 3 * decode and not any(calls)
    assert torch.equal(tokens, tokens_ref)


@pytest.mark.parametrize("arch", SSM)
def test_a_failing_scan_kernel_is_not_caught(monkeypatch, arch):
    """No fallback: a scan kernel that raises on the serving path fails the
    call; nothing carries on with the plain scan."""
    model, cfg = build_model(get_arch(arch).reduced, device="cpu")
    _stand_in_card(monkeypatch, arch)
    module, name = SCAN[arch]

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(module, name, broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        ServeEngine(model, 12, device="cpu").generate(
            {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, 2)
    loss, _ = model.train_loss(SyntheticTokens(cfg.vocab_size, 16, 1).batch_at(0))
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("mode", ["invertible", "autodiff"])
def test_train_loss_at_a_longer_sequence_matches_the_reference(arch, mode):
    """``REDUCED`` in f32 at 2 x 48 (zamba2: three chunks of its scan),
    the plain scans against the reference's ``lax.scan``."""
    jm, jp, m, tree = make_pair(arch, dtype="float32")
    batch = token_batch(m.cfg.vocab_size, 2, 48, seed=11)
    ref_loss, ref_grads = ref_loss_grad(jm, jp, batch, mode)
    loss, grads = port_loss_grad(m, batch, mode)
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    errs = leaf_errors(m, tree, grads, ref_grads)
    assert max(errs.values()) <= TOL_LEAF, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", SSM)
def test_train_lm_restart_is_bitwise(tmp_path, arch):
    """Killed at step 3 and restarted from its step-2 checkpoint, the run
    ends bit for bit where the uninterrupted one does."""
    runs = []
    for name, injector in (("clean", None), ("failed", FailureInjector(fail_at=(3,)))):
        model, cfg = build_model(get_arch(arch).reduced, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        data = SyntheticTokens(cfg.vocab_size, 16, 2, seed=2)
        tcfg = TrainConfig(steps=5, lr=1e-3, warmup_steps=2, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / name), prefetch=0)
        runs.append(train_lm(model, data, tcfg, device="cpu", injector=injector))
    clean, res = runs
    assert res.restarts == 1 and res.final_step == 4 and np.isfinite(clean.losses).all()
    assert all(torch.equal(clean.params[k], res.params[k]) for k in clean.params)
    assert clean.losses[2:] == res.losses[-3:]


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
    return total[0]


@pytest.mark.parametrize("arch,depths", [("rwkv6-7b", (2, 8)), ("zamba2-7b", (4, 16))])
def test_ssm_memory_flat_in_depth(arch, depths):
    """The paper's claim for the SSM families, whose plain scans save a state
    per token under autograd: flat in depth under ``invertible``, growing
    under ``autodiff`` (zamba2 from 2 to 8 superblocks, no tail)."""
    inv = [_saved_bytes(arch, n, "invertible") for n in depths]
    ad = [_saved_bytes(arch, n, "autodiff") for n in depths]
    assert inv[1] <= inv[0] * 1.2, f"reversible memory grew with depth: {inv}"
    assert ad[1] > ad[0] * 1.8, f"AD memory should grow with depth: {ad}"

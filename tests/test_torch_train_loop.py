"""The port's supervised training loop and its substrate on the CPU:
checkpoints, restarts, the straggler watchdog, the prefetcher, the
asynchronous checkpointer and gradient accumulation (the contracts the
reference pins in ``tests/test_train.py`` and
``tests/test_substrate_extras.py``).

The models are small: a cHINT ``ConditionalFlow`` (d_theta 4, depth 2,
hidden 8, a 4-wide summary) on ``SyntheticInverseProblem`` batches of 8 (64
where the loss must fall), and for ``train_flow`` the scanned GLOW of
``test_torch_train.py`` (2 scales x 2 steps, hidden 8) on 8x8 images.  A restarted run is held to the
uninterrupted one bit for bit (the port's contract on one device; the
reference holds its LM to 1e-5).  Accumulated gradients are held to the
full batch's at 1e-5 absolute and relative (the same f32 sums in another
order; the reference holds its LM at 5e-3).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.config import TrainConfig
from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint, build_glow_scanned
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import SyntheticImages, SyntheticInverseProblem
from repro_torch.optim.accum import accumulate_grads
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.async_ckpt import AsyncCheckpointer
from repro_torch.train.fault import FailureInjector, StragglerWatchdog
from repro_torch.train.loop import train_conditional_flow, train_flow

torch.set_num_threads(2)


def _model(seed=0):
    g = torch.Generator().manual_seed(seed)
    flow = build_chint(4, 4, depth=2, recursion=2, hidden=8, grad_mode="coupled", generator=g,
                       device="cpu")
    with torch.no_grad():  # the last layers start at zero: make every coupling live
        for p in flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return ConditionalFlow(flow, SummaryMLP(6, 4, 8, generator=g, device="cpu"), device="cpu")


def _data():
    return SyntheticInverseProblem(d_theta=4, d_y=6, sigma=0.3, batch=8, seed=1)


def _cfg(tmp_path, steps=10, every=2, **kw):
    return TrainConfig(steps=steps, lr=1e-2, warmup_steps=2, checkpoint_every=every,
                       checkpoint_dir=str(tmp_path), **kw)


def _assert_same_state(a, b):
    assert a.params.keys() == b.params.keys()
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key]), key
    for which in ("mu", "nu"):
        for key in a.opt_state[which]:
            assert torch.equal(a.opt_state[which][key], b.opt_state[which][key]), key
    assert a.opt_state["step"] == b.opt_state["step"]


def test_loop_trains_and_keeps_no_checkpoint_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = SyntheticInverseProblem(d_theta=4, d_y=6, sigma=0.3, batch=64, seed=1)
    res = train_conditional_flow(_model(), data, TrainConfig(steps=40, lr=1e-2, warmup_steps=2),
                                 device="cpu")
    assert len(res.losses) == 40 and res.final_step == 39 and res.opt_state["step"] == 40
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.1
    assert os.listdir(tmp_path) == []


def test_restart_reproduces_uninterrupted_run(tmp_path):
    clean = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "a"), device="cpu")
    inj = FailureInjector(fail_at=(5,))
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "b"), device="cpu",
                                 injector=inj)
    assert res.restarts == 1 and clean.restarts == 0
    assert res.final_step == clean.final_step == 9
    _assert_same_state(clean, res)
    # the resumed attempt ran steps 4..9 (the checkpoint of step 3, then on)
    assert res.losses == clean.losses[4:]


def test_restart_before_any_checkpoint_starts_from_the_model_as_it_came(tmp_path):
    clean = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "a", every=100),
                                   device="cpu")
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "b", every=100),
                                 device="cpu", injector=FailureInjector(fail_at=(6,)))
    assert res.restarts == 1
    _assert_same_state(clean, res)


def test_train_flow_restarts_on_the_same_loop(tmp_path):
    small = dict(n_scales=2, k_steps=2, hidden=8, grad_mode="coupled", coupled_bwd="reversible")

    def run(path, injector=None):
        flow = build_glow_scanned(**small, generator=torch.Generator().manual_seed(2),
                                  device="cpu")
        return train_flow(flow, SyntheticImages(8, batch=2), _cfg(path, steps=6, every=2),
                          device="cpu", injector=injector)

    clean = run(tmp_path / "a")
    res = run(tmp_path / "b", FailureInjector(fail_at=(3,)))
    assert res.restarts == 1
    _assert_same_state(clean, res)


def test_without_a_checkpoint_dir_a_failure_is_not_restarted():
    from repro_torch.train.fault import SimulatedFailure

    inj = FailureInjector(fail_at=(3,))
    with pytest.raises(SimulatedFailure):
        train_conditional_flow(_model(), _data(), TrainConfig(steps=6, lr=1e-2, warmup_steps=2),
                               device="cpu", injector=inj)


def test_sigterm_saves_and_reports_the_preemption(tmp_path):
    import signal

    class _Term(FailureInjector):
        def maybe_fail(self, step):
            if step == 4:  # the handler the loop installed, as the signal would run it
                handler = signal.getsignal(signal.SIGTERM)
                assert callable(handler), "the loop installed no SIGTERM handler"
                handler(signal.SIGTERM, None)

    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path, every=100), device="cpu",
                                 injector=_Term())
    assert res.preempted and res.final_step == 4 and len(res.losses) == 5
    assert ckpt.latest_step(str(tmp_path)) == 4
    clean = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "clean"), device="cpu")
    assert not clean.preempted


def test_too_many_failures_raises(tmp_path):
    with pytest.raises(RuntimeError):
        train_conditional_flow(_model(), _data(), _cfg(tmp_path, max_restarts=1), device="cpu",
                               injector=FailureInjector(fail_at=(3, 4, 5)))


def test_straggler_watchdog_flags_slow_steps(tmp_path):
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path, steps=3, every=100,
                                                         step_timeout_s=1e-4), device="cpu")
    assert len(res.flagged_steps) >= 1


def test_watchdog_not_tripped_by_failing_steps(tmp_path):
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path, steps=8, step_timeout_s=30.0),
                                 device="cpu", injector=FailureInjector(fail_at=(3, 4)))
    assert res.restarts == 2
    assert res.flagged_steps == ()


def test_watchdog_timer_dies_with_raising_step():
    wd = StragglerWatchdog(0.15)
    try:
        wd.start_step(0)
        try:
            raise RuntimeError("boom")
        finally:
            wd.end_step()
    except RuntimeError:
        pass
    time.sleep(0.4)
    assert wd.flagged_steps == []


def test_checkpoint_atomicity_and_retention(tmp_path):
    state = {"a": torch.arange(5), "b": {"c": torch.ones(2, 2)}, "step": 7}
    path = ckpt.save(state, str(tmp_path), 3)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    like = {"a": torch.zeros(5, dtype=torch.int64), "b": {"c": torch.zeros(2, 2)}, "step": 0}
    restored, step = ckpt.restore(like, str(tmp_path))
    assert step == 3 and restored["step"] == 7
    assert torch.equal(restored["a"], torch.arange(5))
    assert torch.equal(restored["b"]["c"], torch.ones(2, 2))
    for s in (4, 5, 6, 7):
        ckpt.save(state, str(tmp_path), s, keep=3)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_00000005", "step_00000006", "step_00000007"]
    assert ckpt.latest_step(str(tmp_path)) == 7
    with pytest.raises(ValueError):
        ckpt.restore({**like, "a": torch.zeros(4, dtype=torch.int64)}, str(tmp_path))
    with pytest.raises(KeyError):
        ckpt.restore({**like, "d": torch.zeros(1)}, str(tmp_path))


def test_no_duplicate_final_checkpoint(tmp_path, monkeypatch):
    calls = []
    real_save = ckpt.save

    def counting_save(state, ckpt_dir, step, keep=3):
        calls.append(step)
        return real_save(state, ckpt_dir, step, keep)

    monkeypatch.setattr(ckpt, "save", counting_save)
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "aligned", steps=6, every=3),
                                 device="cpu")
    assert res.final_step == 5 and calls == [2, 5]
    assert sorted(os.listdir(tmp_path / "aligned")) == ["step_00000002", "step_00000005"]
    calls.clear()
    train_conditional_flow(_model(), _data(), _cfg(tmp_path / "off", steps=7, every=3),
                           device="cpu")
    assert calls == [2, 5, 6]


def test_prefetched_loop_matches_synchronous_across_restart(tmp_path):
    sync = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "sync", prefetch=0),
                                  device="cpu")
    pf = train_conditional_flow(_model(), _data(), _cfg(tmp_path / "pf", prefetch=3),
                                device="cpu", injector=FailureInjector(fail_at=(5,)))
    assert pf.restarts == 1
    _assert_same_state(sync, pf)


def test_loop_leaves_no_thread_behind(tmp_path):
    before = threading.active_count()
    train_conditional_flow(_model(), _data(), _cfg(tmp_path, steps=4, prefetch=2), device="cpu",
                           injector=FailureInjector(fail_at=(2,)))
    assert threading.active_count() == before


def test_async_checkpointer_roundtrip(tmp_path):
    state = {"a": torch.arange(16.0), "b": {"c": torch.ones(4, 4)}}
    acp = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        acp.save({"a": state["a"] * step, "b": state["b"]}, step)
    acp.wait()
    assert acp.completed == [1, 2, 3]
    restored, step = ckpt.restore(state, str(tmp_path))
    assert step == 3
    assert torch.equal(restored["a"], torch.arange(16.0) * 3)


def test_async_checkpointer_snapshot_isolation(tmp_path):
    """The saved state is the value at ``save()``, not at write time, even
    when the caller's tensor is updated in place."""
    acp = AsyncCheckpointer(str(tmp_path))
    state = {"x": torch.zeros(4)}
    acp.save(state, 1)
    state["x"].add_(1.0)
    acp.wait()
    restored, _ = ckpt.restore(state, str(tmp_path))
    assert torch.equal(restored["x"], torch.zeros(4))


def test_prefetcher_matches_direct_and_is_ordered():
    data = _data()
    pf = Prefetcher(data.batch_at, start_step=5, lookahead=3)
    try:
        for expect in (5, 6, 7, 8):
            step, batch = pf.get()
            assert step == expect
            assert torch.equal(batch["y"], data.batch_at(step)["y"])
    finally:
        pf.close()


def test_prefetcher_close_is_prompt_and_joins_worker():
    pf = Prefetcher(_data().batch_at, start_step=0, lookahead=2)
    pf.get()
    time.sleep(0.1)  # let the worker fill the queue and block in put
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 2.0, "close() stalled on a blocked put"
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError):
        pf.get()
    pf.close()  # idempotent


def test_prefetcher_surfaces_worker_errors():
    def bad_batch(step):
        if step >= 2:
            raise ValueError("source exhausted")
        return step

    pf = Prefetcher(bad_batch, start_step=0, lookahead=1)
    try:
        assert pf.get() == (0, 0)
        assert pf.get() == (1, 1)
        with pytest.raises(ValueError, match="source exhausted"):
            pf.get()
    finally:
        pf.close()


def test_grad_accumulation_matches_full_batch():
    model = _model()
    named = dict(model.named_parameters())
    batch = _data().batch_at(0)

    def value_and_grad(b):
        loss, _ = model.train_loss(b)
        return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    loss_full, g_full = accumulate_grads(value_and_grad, batch, 1)
    loss_acc, g_acc = accumulate_grads(value_and_grad, batch, 4)
    np.testing.assert_allclose(loss_acc.item(), loss_full.item(), rtol=1e-5, atol=1e-5)
    for key, g in g_full.items():
        np.testing.assert_allclose(g_acc[key].numpy(), g.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    with pytest.raises(ValueError):
        accumulate_grads(value_and_grad, batch, 3)


def test_accumulated_loop_runs(tmp_path):
    res = train_conditional_flow(_model(), _data(), _cfg(tmp_path, steps=3, accum_steps=2),
                                 device="cpu")
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))


def test_grad_compression_waits_for_the_distribution_slice(tmp_path):
    """Gradient compression is ported: ``topk`` and ``int8`` build and train
    (one process: local error feedback, nothing on a wire), the residuals
    carried; any other method raises."""
    for method in ("topk", "int8"):
        res = train_conditional_flow(_model(), _data(), _cfg(tmp_path / method, steps=3,
                                                             grad_compression=method,
                                                             compression_ratio=0.1),
                                     device="cpu")
        assert len(res.losses) == 3 and all(np.isfinite(res.losses))
        assert res.err_state and any(float(e.abs().max()) > 0 for e in res.err_state.values())
    with pytest.raises(ValueError, match="grad_compression"):
        TrainConfig(grad_compression="fp8")

"""The port's five examples (``examples/torch_*.py``) run through their
``main`` on the CPU, with the reference examples' own gates:

* quickstart whole (400 steps): the final NLL below 1.2, and the round trip;
* train_glow at 16x16 for 10 steps, unrolled and scanned: the loss falls
  and the held-out bits/dim are finite;
* reversible_lm ``--smoke``: ``losses[-1] < losses[0]``, then
  ``ServeEngine.generate``;
* amortized_inference whole (600 steps, 20,000 draws): the posterior mean
  within 0.35 of the analytic one and the std ratio in (0.5, 2);
* seismic_uq at 20 steps: a finite posterior mean (the reference's gate);
  its 1000 steps run on the card only (``chip_smoke.py``'s ``[examples]``).

Without a device named, each ``main`` raises on a host without a card.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "train_glow", "reversible_lm", "amortized_inference", "seismic_uq")

torch.set_num_threads(2)


def _load(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_reaches_its_nll_gate():
    out = _load("quickstart").main(device="cpu")
    assert out["nll"] < 1.2
    assert out["round_trip_max_err"] < 1e-4
    assert all(math.isfinite(v) for v in out["sample_mean"] + out["sample_std"])


@pytest.mark.parametrize("scanned", [False, True], ids=["unrolled", "scanned"])
def test_train_glow_loss_falls(tmp_path, scanned):
    out = _load("train_glow").main(size=16, steps=10, scanned=scanned,
                                   ckpt=str(tmp_path / "ck"), device="cpu")
    assert out["final_step"] == 9
    assert out["last_loss"] < out["first_loss"] and math.isfinite(out["bits_per_dim"])
    assert out["sample_shape"] == (8, 16, 16, 3)
    assert (tmp_path / "ck" / "step_00000009").is_dir()


def test_reversible_lm_smoke_trains_and_serves(tmp_path):
    out = _load("reversible_lm").main(smoke=True, ckpt=str(tmp_path / "ck"), device="cpu")
    assert out["steps"] == 40 and out["final_step"] == 39
    assert out["last_loss"] < out["first_loss"]
    toks = out["tokens"]
    assert toks.shape == (2, 8) and int(toks.min()) >= 0 and int(toks.max()) < 512


def test_amortized_inference_matches_the_analytic_posterior():
    out = _load("amortized_inference").main(device="cpu")
    assert out["steps"] == 600 and out["draws"] == 20_000
    assert out["mu_err"] < 0.35
    assert all(0.5 < r < 2.0 for r in out["sd_ratio"])


def test_seismic_uq_posterior_is_finite(tmp_path):
    out = _load("seismic_uq").main(steps=20, device="cpu", ckpt_dir=str(tmp_path))
    assert out["steps"] == 20
    stats = out["stats"]
    assert stats.n == 20_000 and np.all(np.isfinite(stats.mean))
    assert np.all(np.isfinite(stats.std))
    assert (tmp_path / "step_00000019").is_dir()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_device_raises_on_a_host_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main()

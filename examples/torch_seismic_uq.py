"""Reliability-aware seismic-style inversion with an amortized flow
posterior, on the PyTorch/CUDA port.

The ``seismic-uq`` scenario (``repro_torch.uq`` registry): a reflectivity
trace is observed through a band-limited Ricker-wavelet convolution, the
textbook post-stack seismic forward model, the 1-D core of Siahkoohi &
Herrmann (2021, "Learning by example: fast reliability-aware seismic
imaging with normalizing flows").  Band-limitation destroys low and high
frequencies, so the posterior's uncertainty is strongly structured, which
the credible maps should show.

The port's counterpart of ``examples/seismic_uq.py``, the paper's
application loop end to end:

  1. train a conditional HINT flow on simulated (reflectivity, trace) pairs
     through the fused coupled backward;
  2. stream 20k posterior draws for a held-out trace through
     ``PosteriorEngine`` (the kernel-backed inverse, O(chunk) memory);
  3. print the uncertainty map (the 90% credible width per sample position)
     beside the analytic reference (the operator is linear-Gaussian);
  4. run the SBC/coverage calibration report.

    PYTHONPATH=src python examples/torch_seismic_uq.py [--steps 1000] [--device cpu]

It runs on the card unless ``--device`` names another device, and raises on
a host without one.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.uq import get_scenario, posterior_report, train_scenario


def ascii_map(values, width: int = 40) -> str:
    """One-line bar chart per entry: uncertainty maps without matplotlib."""
    v = np.asarray(values, np.float64)
    scale = width / max(float(v.max()), 1e-9)
    return "\n".join(
        f"  [{i:3d}] {'#' * max(int(x * scale), 1)} {x:.3f}"
        for i, x in enumerate(v)
    )


def main(steps: int | None = None, device=None, ckpt_dir: str | None = None) -> dict:
    """``ckpt_dir``: keep the training checkpoints there (by default a
    temporary directory, removed after training)."""
    dev = resolve_device(device)
    sc = get_scenario("seismic-uq")
    print(f"scenario: {sc.name} — {sc.note}")
    with tempfile.TemporaryDirectory() as tmp:
        run = train_scenario(sc, steps=steps, ckpt_dir=ckpt_dir or tmp, device=dev)
    problem = run.problem

    y_obs = problem.batch_at(10_000)["y"][:1]
    stats, report = posterior_report(run, y_obs=y_obs,
                                     generator=torch.Generator().manual_seed(0))

    # analytic reference: the operator is linear, so the exact posterior
    # std is available; the learned map should reproduce its structure
    _, cov = problem.posterior(y_obs[0])
    ana_sd = np.sqrt(np.diag(np.asarray(cov)))

    lo, hi = stats.intervals[0.9]
    print("\nposterior 90% credible width per reflectivity sample "
          "(flow, streamed):")
    print(ascii_map(hi - lo))
    print("\nanalytic posterior std (reference structure):")
    print(ascii_map(ana_sd))
    corr = float(np.corrcoef(hi - lo, ana_sd)[0, 1])
    print(f"\nwidth-vs-analytic-std correlation: {corr:.3f}")
    print(stats.summary())
    print(report.summary())
    assert np.all(np.isfinite(stats.mean))
    print("OK — seismic UQ pipeline complete")
    return {"run": run, "stats": stats, "report": report, "steps": len(run.result.losses),
            "width_vs_analytic_std_corr": corr}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=0,
                    help="override the scenario's training steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.steps or None, device=args.device)

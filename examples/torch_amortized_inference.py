"""Amortized Bayesian inference with a conditional flow (paper §4) on the
PyTorch/CUDA port.

Runs the ``lg-posterior`` scenario of the ``repro_torch.uq`` registry: a
conditional HINT flow and summary network trained on a linear-Gaussian
inverse problem whose posterior is known in closed form, so the learned
posterior can be checked, not just eyeballed:

    theta ~ N(0, I),  y = A theta + sigma eps
    =>  theta | y  ~  N(mu(y), Sigma)   (closed form)

The port's counterpart of ``examples/amortized_inference.py``: a thin layer
over the scenario registry (the recipe ``repro_torch.launch.train --scenario
lg-posterior`` runs).  Training goes through the fault-tolerant loop,
posterior statistics stream through ``PosteriorEngine`` without ever
materializing the draw cloud (on the card through the fused coupling
inverse kernel), and the SBC/coverage calibration report closes the loop.

    PYTHONPATH=src python examples/torch_amortized_inference.py [--steps N] [--device cpu]

It runs on the card unless ``--device`` names another device, and raises on
a host without one.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.uq import posterior_report, train_scenario


def main(steps: int | None = None, device=None) -> dict:
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run = train_scenario("lg-posterior", steps=steps, ckpt_dir=ckpt_dir, device=dev)
    problem = run.problem

    # --- validate against the analytic posterior on one observation -------
    y_obs = problem.batch_at(10_000)["y"][:1]
    mu, cov = problem.posterior(y_obs[0])
    stats, report = posterior_report(
        run, y_obs=y_obs, generator=torch.Generator().manual_seed(0),
        n_samples=20_000, chunk=4000,
    )
    ana_sd = np.sqrt(np.diag(np.asarray(cov)))
    mu_err = float(np.max(np.abs(stats.mean - np.asarray(mu))))
    sd_ratio = stats.std / ana_sd
    print(stats.summary())
    print("posterior mean abs err (max over dims):", round(mu_err, 3))
    print("posterior std ratio (flow/analytic):", np.round(sd_ratio, 2))
    print(report.summary())
    assert mu_err < 0.35, "amortized posterior mean should match analytic"
    assert np.all(sd_ratio > 0.5) and np.all(sd_ratio < 2.0)
    print("OK — amortized posterior matches the analytic linear-Gaussian "
          "posterior (streamed, never materialized)")
    return {"steps": len(run.result.losses), "losses": run.result.losses, "mu_err": mu_err,
            "sd_ratio": sd_ratio.tolist(), "draws": stats.n,
            "sbc_pvalue_min": float(np.min(report.pvalues)), "coverage": report.coverage}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=0,
                    help="override the scenario's training steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.steps or None, device=args.device)

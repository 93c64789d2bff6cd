"""Quickstart on the PyTorch/CUDA port: density estimation on 2-D two-moons
with RealNVP.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 400] [--device cpu]

The port's counterpart of ``examples/quickstart.py``: trains in invertible
(memory-frugal) mode, checks round-trip invertibility, and draws samples by
inverting the flow.  The couplings' forward runs through the fused coupling
kernels (``kernel_training``): on the card the hand-written CUDA kernels, on
the CPU their plain versions.  It runs on the card unless ``--device`` names
another device, and raises on a host without one.
"""

import argparse
import math

import torch

from repro_torch.config import TrainConfig
from repro_torch.core import build_realnvp, derive_key, value_and_grad_nll
from repro_torch.core.types import resolve_device
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup


def two_moons(generator: torch.Generator, n: int) -> torch.Tensor:
    theta = math.pi * torch.rand(n, generator=generator)
    flip = torch.rand(n, generator=generator) < 0.5
    x = torch.stack(
        [
            torch.where(flip, torch.cos(theta), 1 - torch.cos(theta)),
            torch.where(flip, torch.sin(theta) - 0.25, -torch.sin(theta) + 0.25),
        ],
        dim=1,
    )
    return x + 0.05 * torch.randn(n, 2, generator=generator)


def main(steps: int = 400, device=None) -> dict:
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(0)
    # invertible grad engine; the parameters drawn from the seed on the CPU
    flow = build_realnvp(2, depth=6, hidden=64, kernel_training=True,
                         generator=torch.Generator().manual_seed(0), device=dev)
    x0 = two_moons(torch.Generator().manual_seed(0), 512).to(dev)
    tcfg = TrainConfig(steps=steps, lr=2e-3, warmup_steps=20)
    params = dict(flow.named_parameters())
    opt = adamw_init(params)

    for i in range(steps):
        batch = two_moons(derive_key(rng, i), 512).to(dev)
        loss, grads = value_and_grad_nll(flow, batch)
        lr = cosine_warmup(i, tcfg.lr, tcfg.warmup_steps, tcfg.steps)
        opt, _ = adamw_update(params, grads, opt, tcfg, lr)
        if i % 100 == 0 or i == steps - 1:
            print(f"step {i:4d}  nll/dim {float(loss):.4f}")

    # invertibility check + sampling by inversion
    with torch.no_grad():
        z, logdet = flow(x0)
        x_rec = flow.inverse(z)
        round_trip = float(torch.max(torch.abs(x0 - x_rec)))
        print("round-trip max err:", round_trip)
        samples = flow.inverse(torch.randn(1000, 2, generator=torch.Generator().manual_seed(0))
                               .to(dev))
    mean, std = torch.mean(samples, 0), torch.std(samples, 0, correction=0)
    print("sample moments: mean", [round(float(v), 3) for v in mean],
          "std", [round(float(v), 3) for v in std])
    nll = float(loss)
    assert nll < 1.2, "two-moons NLL should drop well below the unit gaussian"
    print("OK")
    return {"nll": nll, "round_trip_max_err": round_trip,
            "sample_mean": mean.tolist(), "sample_std": std.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.steps, device=args.device)

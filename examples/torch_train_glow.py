"""Train GLOW on synthetic images with the port's full training substrate
(checkpointing, restart, cosine schedule) in memory-frugal mode.

    PYTHONPATH=src python examples/torch_train_glow.py [--size 32] [--steps 150] [--device cpu]

The port's counterpart of ``examples/train_glow.py``, the paper's flagship
workload (Figs. 1-2).  ``--scanned`` builds the scan-compiled GLOW, whose
steps run through the fused flow-step kernels; the unrolled build runs its
couplings through the fused coupling kernels under ``--grad-mode coupled``.
It runs on the card unless ``--device`` names another device, and raises on
a host without one.  The loss must fall and the held-out bits/dim must be
finite.
"""

import argparse
import math

import torch

from repro_torch.config import TrainConfig
from repro_torch.core import build_glow, build_glow_scanned, nll_bits_per_dim
from repro_torch.core.types import resolve_device
from repro_torch.data import SyntheticImages
from repro_torch.train import train_flow

LOG_EVERY = 25


def main(size: int = 32, steps: int = 150, batch: int = 8, grad_mode: str = "invertible",
         scanned: bool = False, ckpt: str = "checkpoints/glow", device=None) -> dict:
    dev = resolve_device(device)
    build = build_glow_scanned if scanned else build_glow
    flow = build(n_scales=2, k_steps=4, hidden=32, grad_mode=grad_mode,
                 generator=torch.Generator().manual_seed(0), device=dev)
    data = SyntheticImages(size=size, batch=batch, seed=0)
    tcfg = TrainConfig(
        steps=steps, lr=1e-3, warmup_steps=10,
        checkpoint_every=50, checkpoint_dir=ckpt,
    )
    res = train_flow(flow, data, tcfg, device=dev)
    for step in range(0, len(res.losses), LOG_EVERY):
        print(f"step {step:4d}  loss {res.losses[step]:.4f}")
    print(f"finished at step {res.final_step}; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")

    with torch.no_grad():
        bpd = float(nll_bits_per_dim(flow, data.batch_at(999).to(dev)))
        print(f"held-out bits/dim: {bpd:.3f}")
        # sample by inversion
        state, _ = flow(data.batch_at(0).to(dev))
        z = tuple(torch.randn(v.shape, dtype=v.dtype, generator=torch.Generator().manual_seed(1))
                  .to(dev) * 0.7 for v in state)
        imgs = flow.inverse(z)
    lo, hi = float(torch.min(imgs)), float(torch.max(imgs))
    print("sampled image tensor:", tuple(imgs.shape), "range", lo, hi)
    assert res.losses[-1] < res.losses[0], "training must reduce the loss"
    assert math.isfinite(bpd), "held-out bits/dim must be finite"
    return {"final_step": res.final_step, "first_loss": res.losses[0],
            "last_loss": res.losses[-1], "bits_per_dim": bpd,
            "sample_shape": tuple(imgs.shape), "sample_range": (lo, hi)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-mode", default="invertible",
                    choices=["invertible", "coupled", "autodiff"])
    ap.add_argument(
        "--scanned", action="store_true",
        help="scanned GLOW through the fused flow-step kernels (the coupled fast path)",
    )
    ap.add_argument("--ckpt", default="checkpoints/glow")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.size, args.steps, args.batch, args.grad_mode, args.scanned, args.ckpt,
         device=args.device)

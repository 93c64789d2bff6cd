"""End to end on the PyTorch/CUDA port: train a ~100M-parameter
reversible transformer LM with the full production substrate (the paper's
memory-frugal technique on the LM path, checkpoint/restart, schedule,
clipping) and serve it at the end.

    PYTHONPATH=src python examples/torch_reversible_lm.py                  # ~160M params
    PYTHONPATH=src python examples/torch_reversible_lm.py --smoke --device cpu

The port's counterpart of ``examples/reversible_lm.py``.  The default config
is ~113M non-embedding (~160M total) parameters and runs a few hundred
steps on the card; ``--smoke`` is the same code path at reduced widths.  It
runs on the card unless ``--device`` names another device, and raises on a
host without one; ``--ckpt`` names the checkpoint directory.
"""

import argparse
import math

import torch

from repro_torch.config import AttentionConfig, ModelConfig, TrainConfig
from repro_torch.core.types import resolve_device
from repro_torch.data import SyntheticTokens
from repro_torch.models.lm import Model
from repro_torch.serve import ServeEngine
from repro_torch.train import train_lm


def lm_100m(smoke: bool) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="revlm-smoke", family="dense", n_layers=4, d_model=128,
            d_ff=384, vocab_size=512,
            attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32),
            reversible=True,
        )
    return ModelConfig(
        name="revlm-100m", family="dense", n_layers=12, d_model=768,
        d_ff=3072, vocab_size=32_000,
        attention=AttentionConfig(n_heads=12, n_kv_heads=4, head_dim=64),
        reversible=True,
    )


def main(smoke: bool = False, steps: int = 0, seq: int = 0, batch: int = 0,
         grad_mode: str | None = None, ckpt: str = "checkpoints/revlm", device=None) -> dict:
    dev = resolve_device(device)
    cfg = lm_100m(smoke)
    seq = seq or (64 if smoke else 512)
    batch = batch or (8 if smoke else 16)
    steps = steps or (40 if smoke else 300)

    model = Model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, reversible={cfg.reversible}, "
          f"seq={seq} batch={batch} steps={steps}")

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    tcfg = TrainConfig(
        steps=steps, lr=3e-4 if not smoke else 1e-3, warmup_steps=max(steps // 20, 5),
        checkpoint_every=max(steps // 3, 10), checkpoint_dir=ckpt,
    )
    res = train_lm(model, data, tcfg, grad_mode=grad_mode, device=dev)
    for step in range(0, len(res.losses), max(steps // 10, 1)):
        print(f"step {step:4d}  loss {res.losses[step]:.4f}")
    print(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"(log-vocab {math.log(cfg.vocab_size):.2f})")
    assert res.losses[-1] < res.losses[0], "training must reduce loss"

    # serve a few tokens from the trained model
    engine = ServeEngine(model, max_len=seq + 16, device=dev)
    prompt = data.batch_at(999)["tokens"][:2, : seq // 2]
    toks, _ = engine.generate({"tokens": prompt}, max_new=8)
    print("generated continuation tokens:\n", toks)
    print("OK")
    return {"n_params": n_params, "steps": steps, "first_loss": res.losses[0],
            "last_loss": res.losses[-1], "final_step": res.final_step,
            "tokens": toks.cpu()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--grad-mode", default=None,
                    choices=[None, "invertible", "coupled", "remat", "autodiff"])
    ap.add_argument("--ckpt", default="checkpoints/revlm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args()
    main(args.smoke, args.steps, args.seq, args.batch, args.grad_mode, args.ckpt,
         device=args.device)

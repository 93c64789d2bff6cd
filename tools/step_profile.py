#!/usr/bin/env python3
"""Device busy time and launches of GLOW's calls on one NVIDIA GPU, for one
checkout's ``src``.

    python3 tools/step_profile.py [--src DIR] [--label NAME] [--reps N]

Builds ``GLOW_SCANNED`` and ``GLOW_COUPLED`` as ``chip_smoke.py`` serves and
trains them (256x256x3, batch 8, f32, TF32 off, weights from its seed,
perturbed), and for each model's ``log_prob``, ``sample`` and train step
(``value_and_grad_nll`` through the ``coupled`` reversible backward, then
AdamW) prints one JSON line: the median wall time of ``--reps`` calls, and
of ``--reps`` profiled calls (``torch.profiler``) the device busy ms of
each (every CUDA kernel's duration summed) with their median, the
``aten::cat`` launches of a call, and each hand-written kernel's launches
by path in one call.  ``--src`` names the ``src`` directory whose
``repro_torch`` runs (default: this checkout's), so that two checkouts can
be compared on one card, each process one checkout: run parent, change,
change, parent, ... in one command.  Then the card's name and power limit.
Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the models, seeds and profile reading as the smoke run's)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to run")
    ap.add_argument("--label", default="this checkout", help="names the version in each line")
    ap.add_argument("--reps", type=int, default=5, help="calls timed and calls profiled")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import share_parameters, value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.serve.engine import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = (*fk.KERNELS, *ck.KERNELS, *c1k.KERNELS)
    x = SyntheticImages(cs.HW, channels=3, batch=cs.BATCH, seed=cs.SEED).batch_at(0).to(dev)

    def scanned():
        flow = build_flow(GLOW_SCANNED, channels=3,
                          generator=torch.Generator().manual_seed(cs.SEED), device=dev)
        cs.perturb(flow, cs.SEED + 1)
        return flow

    coupled = cs.build_coupled(dev)
    # the unrolled model samples through its kernel_inverse twin, as served
    models = {"GLOW_SCANNED": (scanned(), None),
              "GLOW_COUPLED": (coupled, share_parameters(cs.build_coupled(dev, kernel_inverse=True),
                                                         coupled))}
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    for model, (flow, twin) in models.items():
        engine = FlowServeEngine(flow, device=dev, sample_flow=twin)
        with torch.inference_mode():
            z, _ = engine.flow(x)
        like = tuple(torch.empty_like(v, device="meta") for v in z)
        params = dict(flow.named_parameters())
        opt = adamw_init(params)

        def train_step():
            loss, grads = value_and_grad_nll(flow, x)
            adamw_update(params, grads, opt, TrainConfig(), 1e-5)
            return loss

        for what, fn in (("log_prob", lambda: engine.log_prob(x)),
                         ("sample", lambda: engine.sample(gen, like)),
                         ("train_step", train_step)):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            busy, cats = [], []
            for _ in range(args.reps):
                cs.reset(kernels)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                busy.append(sum(e.device_time_total for e in events if cs._is_device_event(e)) / 1e3)
                cats.append(sum(e.count for e in events if e.key == "aten::cat"))
            launches = {k.name: dict(getattr(k, "launches_by_path", {"all": k.launches}))
                        for k in kernels if k.launches}
            print(json.dumps({"label": args.label, "model": model, "call": what,
                              "median_wall_ms": sorted(walls)[len(walls) // 2],
                              "device_busy_ms": busy, "median_busy_ms": sorted(busy)[len(busy) // 2],
                              "aten_cat_launches": cats[0], "launches_by_path": launches}),
                  flush=True)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

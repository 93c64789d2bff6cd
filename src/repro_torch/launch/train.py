"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --reduced --steps 50 --seq 128 --batch 8 [--grad-mode coupled] [--device cuda]

    PYTHONPATH=src python -m repro_torch.launch.train --scenario lg-smoke \
        --ckpt checkpoints/uq [--steps 50] [--device cuda] [--mesh auto]

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --scenario lg-smoke --ckpt ckpt/uq --mesh 2,1

``--arch`` trains a language model (any architecture: yi-6b, glm4-9b,
granite-34b, command-r-plus-104b, granite-moe-1b-a400m,
llama4-maverick-400b-a17b, rwkv6-7b, zamba2-7b, whisper-small,
llava-next-34b; ``--reduced`` for its smoke-scale config) through
``train_lm``, weights from seed 0, with checkpoints in ``--ckpt``: a
text-only model on ``SyntheticTokens``; a model with a front end
(whisper-small's frames, llava-next-34b's patches, whose 576 positions come
out of ``--seq``) on ``SpecBatches``, its ``input_specs`` drawn by
``batch_like``.  There the port goes past the reference's launcher, which
builds ``SyntheticTokens`` alone and so cannot train those two.  rwkv6-7b
and zamba2-7b train through their plain scans on either device.  ``--scenario`` trains a named
``repro_torch.uq`` scenario (an amortized posterior or an image-prior flow)
through the supervised loop; serve the result with
``repro_torch.launch.serve --scenario``.  It runs on ``cuda`` unless
``--device`` names another.  ``--mesh`` (``""`` none, ``auto``, ``d,m`` or
``p,d,m`` whose product is the world size; ``launch/mesh.py``) trains
over the processes ``torch.distributed.run`` starts (alone, a world of 1 and
a (1, 1) mesh): one process per rank, ``nccl`` when each has a card of its
own, ``gloo`` when they share one or run on the CPU.  A ``model`` axis > 1
stores each parameter and AdamW moment as each rank's block
(``train/loop.py``); ``p,d,m`` is the multi-pod layout.
"""

from __future__ import annotations

import argparse


def _train_arch(args, mesh):
    from repro_torch.config import ShapeSpec, TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.models.lm import default_grad_mode
    from repro_torch.models.registry import SpecBatches
    from repro_torch.train.loop import train_lm

    spec = get_arch(args.arch)
    model, cfg = build_model(spec.reduced if args.reduced else spec.config, device=args.device)
    from repro_torch.launch.mesh import describe

    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M reversible={cfg.reversible} "
          f"grad_mode={args.grad_mode or default_grad_mode(cfg)} device={args.device} "
          f"mesh={describe(mesh)}", flush=True)
    steps = args.steps or 100
    if cfg.frontend is None:
        data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch, seed=0)
    else:
        data = SpecBatches(cfg, ShapeSpec("train", args.seq, args.batch, "train"), seed=0)
    tcfg = TrainConfig(steps=steps, lr=args.lr, warmup_steps=max(steps // 20, 2),
                       checkpoint_every=max(steps // 4, 10), checkpoint_dir=args.ckpt,
                       step_timeout_s=args.step_timeout, accum_steps=args.accum,
                       prefetch=args.prefetch)
    res = train_lm(model, data, tcfg, grad_mode=args.grad_mode, device=args.device, mesh=mesh)
    if res.losses:
        print(f"done at step {res.final_step}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
              f"restarts={res.restarts}; straggler flags={len(res.flagged_steps)}; "
              f"checkpoints in {args.ckpt}")
    else:  # resumed a checkpoint already at the final step
        print(f"nothing to do: checkpoint in {args.ckpt} already at step {res.final_step}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--arch", help="LM architecture id (LM training through train_lm)")
    group.add_argument("--scenario", help="repro_torch.uq scenario name (amortized posterior / "
                                          "image-prior flow training)")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale config of the architecture's family")
    ap.add_argument("--steps", type=int, default=0,
                    help="override the step count (0 = arch default 100 / the scenario's recipe)")
    ap.add_argument("--seq", type=int, default=128, help="--arch: tokens per sequence")
    ap.add_argument("--batch", type=int, default=8, help="--arch: sequences per step")
    ap.add_argument("--lr", type=float, default=1e-3, help="--arch: peak learning rate")
    ap.add_argument("--grad-mode", default=None,
                    choices=[None, "invertible", "coupled", "remat", "autodiff"],
                    help="--arch: the stack's gradient engine (default: invertible for a "
                         "reversible stack)")
    ap.add_argument("--accum", type=int, default=1,
                    help="--arch: gradient-accumulation microbatches per step (1 = off)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="--arch: batches built ahead of the running step (0 = none)")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="--arch: the straggler watchdog's deadline in seconds (0 = off)")
    ap.add_argument("--ckpt", default="checkpoints/train")
    ap.add_argument("--mesh", default="",
                    help="'' (none), 'auto', 'd,m' or 'p,d,m' over the torch.distributed world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import launcher_mesh

    mesh = launcher_mesh(args.mesh, args.device)
    if args.arch:
        _train_arch(args, mesh)
        return

    from repro_torch.uq.scenarios import get_scenario, train_scenario

    sc = get_scenario(args.scenario)
    kind = "amortized posterior" if sc.conditional else "image prior"
    print(f"scenario={sc.name} ({kind}) flow={sc.flow.name} steps={args.steps or sc.steps} "
          f"device={args.device}", flush=True)
    res = train_scenario(sc, steps=args.steps or None, ckpt_dir=args.ckpt,
                         device=args.device, mesh=mesh).result
    if res.losses:
        print(f"done at step {res.final_step}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
              f"restarts={res.restarts}; checkpoints in {args.ckpt}")
    else:  # resumed a checkpoint already at the final step
        print(f"nothing to do: checkpoint in {args.ckpt} already at step {res.final_step}")


if __name__ == "__main__":
    main()

"""Serving launcher of the port: a language model's batched generation, or a
trained ``repro_torch.uq`` scenario's posterior service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \
        --batch 4 --prompt-len 16 --max-new 32

    PYTHONPATH=src python -m repro_torch.launch.serve --scenario lg-smoke \
        --ckpt checkpoints/uq [--samples 20000] [--no-calibration]

``--arch`` generates through ``ServeEngine`` (prefill, then cached decode
steps) for every architecture (yi-6b, glm4-9b, granite-34b,
command-r-plus-104b, granite-moe-1b-a400m, llama4-maverick-400b-a17b,
rwkv6-7b, zamba2-7b, whisper-small, llava-next-34b) with weights from seed 0
or from ``--ckpt`` (written by ``repro_torch.launch.train --arch``).  A
vision model's prompt carries seeded patch embeddings and an
encoder-decoder's seeded frames, as the reference's launcher feeds them; the
caches hold ``n_patches + prompt_len + max_new`` positions (the reference
sizes them ``prompt_len + max_new``, which a vision prefix overruns).
``--scenario`` restores the scenario's checkpoint: a conditional scenario
streams posterior statistics for a held-out observation through
``PosteriorEngine`` and prints the SBC/coverage calibration report
(``posterior_report``); a prior scenario streams sample statistics through
``PosteriorEngine`` over a ``FlowServeEngine`` (``prior_report``).  It runs
on ``cuda`` unless ``--device`` names another.  ``--mesh`` (``auto``,
``d,m`` or ``p,d,m``, ``launch/mesh.py``) runs over the processes
``torch.distributed.run`` starts (alone, a world of 1): a scenario's
sampled chunks split over the data axes; an LM's ``ServeEngine`` stores its
parameters split over the ``model`` axis and runs its rows of the batch
(``serve/engine.py``), and the launcher prints the whole batch's tokens on
every rank.
"""

from __future__ import annotations

import argparse
import time

import torch



def _serve_prior(run, args, mesh):
    from repro_torch.uq.scenarios import prior_report

    t0 = time.perf_counter()
    stats = prior_report(run, n_samples=args.samples or 2048, chunk=args.chunk or None,
                         mesh=mesh)
    dt = time.perf_counter() - t0
    print(stats.summary())
    print(f"streamed {stats.n} samples in {dt:.2f}s ({stats.n / dt:.0f} samples/s)")


def _serve_scenario(args):
    from repro_torch.launch.mesh import launcher_mesh
    from repro_torch.uq.scenarios import posterior_report, restore_scenario

    mesh = launcher_mesh(args.mesh, args.device)
    run = restore_scenario(args.scenario, args.ckpt, device=args.device, mesh=mesh)
    if not run.scenario.conditional:
        _serve_prior(run, args, mesh)
        return
    t0 = time.perf_counter()
    stats, report = posterior_report(run, n_samples=args.samples or None,
                                     chunk=args.chunk or None,
                                     calibration=not args.no_calibration)
    dt = time.perf_counter() - t0
    print(stats.summary())
    print(f"streamed {stats.n} draws in {dt:.2f}s ({stats.n / dt:.0f} draws/s incl. calibration)")
    if report is not None:
        print(report.summary())


def _serve_arch(args):
    from repro_torch.config import ShapeSpec, get_arch
    from repro_torch.launch.mesh import describe, launcher_mesh
    from repro_torch.models import build_model
    from repro_torch.models.registry import batch_like, input_specs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint as ckpt

    mesh = launcher_mesh(args.mesh, args.device)
    spec = get_arch(args.arch)
    model, cfg = build_model(spec.reduced if args.reduced else spec.config, device=args.device)
    if args.ckpt:
        state, step = ckpt.restore({"params": model.state_dict()}, args.ckpt)
        model.load_state_dict(state["params"])
        print(f"restored step {step} from {args.ckpt}")
    n_prefix = (cfg.frontend.n_patches
                if cfg.frontend is not None and cfg.frontend.kind == "vision" else 0)
    engine = ServeEngine(model, max_len=n_prefix + args.prompt_len + args.max_new,
                         temperature=args.temperature, device=args.device, mesh=mesh)
    shape = ShapeSpec("serve", n_prefix + args.prompt_len, args.batch, "prefill")
    prompt = batch_like(input_specs(cfg, shape), torch.Generator().manual_seed(0),
                        cfg.vocab_size)
    t0 = time.perf_counter()
    toks, logits = engine.generate(prompt, max_new=args.max_new)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("generate: the last step's logits are not finite")
    print(toks[:, :16])
    on_mesh = "" if mesh is None else f" mesh={describe(mesh)}"
    print(f"arch={cfg.name} device={args.device}{on_mesh}: generated {tuple(toks.shape)} "
          f"tokens in {dt:.2f}s ({toks.numel() / dt:.1f} tok/s)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--arch", help="LM architecture id (yi-6b, glm4-9b, granite-34b, "
                                      "command-r-plus-104b, granite-moe-1b-a400m, "
                                      "llama4-maverick-400b-a17b, rwkv6-7b, zamba2-7b, "
                                      "whisper-small, llava-next-34b)")
    group.add_argument("--scenario", help="repro_torch.uq scenario to serve (posterior "
                                          "statistics + calibration from --ckpt)")
    ap.add_argument("--samples", type=int, default=0,
                    help="draws to stream (0 = the scenario's default)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="streaming chunk size (0 = the scenario's default)")
    ap.add_argument("--no-calibration", action="store_true",
                    help="skip the SBC/coverage calibration pass")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale config of the architecture's family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt", default="", help="the checkpoint directory to restore")
    ap.add_argument("--mesh", default="",
                    help="'' (none), 'auto', 'd,m' or 'p,d,m' over the torch.distributed "
                         "world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.scenario:
        if not args.ckpt:
            ap.error("--scenario serving needs --ckpt (a directory written by "
                     "repro_torch.launch.train --scenario)")
        _serve_scenario(args)
    else:
        _serve_arch(args)


if __name__ == "__main__":
    main()

"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --scenario lg-smoke \
        --ckpt checkpoints/uq [--steps 50] [--device cuda]

``--scenario`` trains a named ``repro_torch.uq`` scenario (an amortized
posterior or an image-prior flow) through the supervised loop, with
checkpoints in ``--ckpt``; serve the result with ``repro_torch.launch.serve
--scenario``.  It runs on one device, ``cuda`` unless ``--device`` names
another.  LM training (``--arch``) and a device mesh (``--mesh``) are not
ported yet and raise, naming their place in ``ROADMAP.md``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--arch", help="LM architecture id (not ported: raises)")
    group.add_argument("--scenario", help="repro_torch.uq scenario name (amortized posterior / "
                                          "image-prior flow training)")
    ap.add_argument("--steps", type=int, default=0,
                    help="override the step count (0 = the scenario's recipe)")
    ap.add_argument("--ckpt", default="checkpoints/train")
    ap.add_argument("--mesh", default="", help="a device mesh (not ported: raises unless empty)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError("--mesh: a device mesh is not ported yet "
                                  "(ROADMAP.md queue 1, item 7); leave it empty")
    if args.arch:
        raise NotImplementedError("--arch: LM training (train_lm) is not ported yet "
                                  "(ROADMAP.md queue 1, item 6.3); train a --scenario")

    from repro_torch.uq.scenarios import get_scenario, train_scenario

    sc = get_scenario(args.scenario)
    kind = "amortized posterior" if sc.conditional else "image prior"
    print(f"scenario={sc.name} ({kind}) flow={sc.flow.name} steps={args.steps or sc.steps} "
          f"device={args.device}", flush=True)
    res = train_scenario(sc, steps=args.steps or None, ckpt_dir=args.ckpt,
                         device=args.device).result
    if res.losses:
        print(f"done at step {res.final_step}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
              f"restarts={res.restarts}; checkpoints in {args.ckpt}")
    else:  # resumed a checkpoint already at the final step
        print(f"nothing to do: checkpoint in {args.ckpt} already at step {res.final_step}")


if __name__ == "__main__":
    main()

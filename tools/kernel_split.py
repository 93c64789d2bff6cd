#!/usr/bin/env python3
"""Device time of ``flowstep_fwd``, ``flowstep_inv``, ``spine_bwd`` and
``wkv_scan`` on one NVIDIA GPU, split by the CUDA kernels each call launches.

    python3 tools/kernel_split.py [--src DIR] [--label NAME] [--only KERNEL ...]

``flowstep_fwd``, ``flowstep_inv`` and ``spine_bwd`` at the scanned GLOW's
three (B, M, C) in f32 and bf16, and ``wkv_scan`` at rwkv6-7b's prefill
(8, 64, 2048, 64) and its decode step (8, 64, 1, 64, cycling through 32
layers' states so that each call reads its state cold from HBM), f32 with an
initial state, on the inputs ``chip_smoke.py`` times (the flow step's raw
and t the halves of one conditioner output, as the model passes them).
Each point: the summed device time of one call and its split by kernel name
(``torch.profiler``, 20 calls), the call's wall time between CUDA events,
and the path the call took where the kernel has two.  ``--only`` times the
named kernels alone.  ``--src`` names the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so that two versions
of the kernels can be timed in one run, each built from its own sources
into its own checkout's ``build/``.  Prints one JSON line per point, then
the card's name and power limit.  With ``--spine-plans`` it times instead
``spine_bwd``'s cluster kernel at the same points under candidate launch
plans (blocks a cluster, blocks in all) beside the plan ``spine_plan``
picks, each held against ``spine_bwd_ref`` at ``chip_smoke.py``'s
``TOL_SUM``.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (timing, inputs and tolerances as the smoke run's)

SPINE_SHAPES = cs.SHAPES[:3]
KERNELS = ("flowstep_fwd", "flowstep_inv", "spine_bwd", "wkv_scan")


def spine_inputs(shape, dtype, dev):
    """x2, gx2, W, W^-1, an_log_s, an_b as ``chip_smoke.py``'s ``[times]``
    pass them to ``spine_bwd``."""
    import torch

    x2, ls, ab, w, _, _ = cs.step_inputs(shape, dtype, dev, cs.SEED)
    gx2 = torch.randn(shape, generator=torch.Generator().manual_seed(cs.SEED + 7)).to(dev, dtype)
    return x2, gx2, w, torch.linalg.inv(w), ls, ab


def flow_inputs(shape, dtype, dev):
    """x, an_log_s, an_b, W, raw, t, and the forward's y and W^-1, as
    ``chip_smoke.py``'s ``[times]`` pass them to the flow-step kernels."""
    import torch

    from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref

    x, ls, ab, w, raw, t = cs.step_inputs(shape, dtype, dev, cs.SEED)
    return x, ls, ab, w, raw, t, flowstep_fwd_ref(x, ls, ab, w, raw, t)[0], torch.linalg.inv(w)


def report(label, kernel, shape, dtype, fn, **extra):
    ms, src, split = cs.device_ms(fn)
    print(json.dumps({"label": label, "kernel": kernel, "shape": list(shape), "dtype": dtype,
                      "device_us": 1e3 * ms, "device_us_from": src,
                      "device_us_by_kernel": None if split is None else
                      {k: 1e3 * v for k, v in split.items()},
                      "call_us": 1e3 * cs.call_ms(fn), **extra}), flush=True)


def spine_plans(dev) -> None:
    """One line per (shape, dtype): the cluster kernel's device time (µs)
    under each candidate plan and under ``spine_plan``'s."""
    import torch
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.kernels.flowstep.ref import spine_bwd_ref

    fn = fk._fn("spine_bwd_cluster")
    for shape in SPINE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x2, gx2, w, w_inv, ls, ab = spine_inputs(shape, dtype, dev)
            b, m, c = shape
            rows, e = b * m, c * c + 2 * c
            ref = spine_bwd_ref(x2, gx2, w, w_inv, ls, ab)
            x, gx = torch.empty_like(x2), torch.empty_like(x2)
            sums = torch.empty(e, device=dev)
            partial = torch.empty(264 * e, device=dev)
            strides = (ctypes.c_longlong * 4)(*w.stride(), *w_inv.stride())
            chosen = fk.spine_plan(rows, c, fk.spine_max_clusters(dev, dtype, c))
            times = {}
            for cl, blocks in [(1, 128), (2, 128), (4, 128), (8, 128), (1, 256), (2, 256),
                               (8, 240), (chosen["cluster_size"],
                                         chosen["clusters"] * chosen["cluster_size"])]:
                round8 = lambda v: -(-v // 8) * 8  # noqa: E731
                cta = round8(-(-rows // blocks))
                slab = round8(-(-cta // -(-cta // fk.spine_slab_rows(c))))

                def call():
                    return fn(KERNEL_DTYPES[dtype], x2.data_ptr(), gx2.data_ptr(), w.data_ptr(),
                              w_inv.data_ptr(), strides, ls.data_ptr(), ab.data_ptr(),
                              x.data_ptr(), gx.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                              rows, c, cta, slab, blocks // cl, cl, torch.cuda.current_device(),
                              torch.cuda.current_stream().cuda_stream)

                if call() != 0:
                    times[f"{blocks // cl}x{cl}"] = "refused"
                    continue
                gw = sums[: c * c].view(c, c)
                tol = cs.TOL_SUM[str(dtype).removeprefix("torch.")]
                ok = (gw - ref[2]).abs().max().item() <= tol * ref[2].abs().max().item()
                times[f"{blocks // cl}x{cl}"] = 1e3 * cs.device_ms(call)[0] if ok else "wrong"
            print(json.dumps({"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
                              "plan": chosen, "device_us_by_plan": times}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to time")
    ap.add_argument("--label", default="this checkout", help="names the version in each line")
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time these kernels alone")
    ap.add_argument("--spine-plans", action="store_true",
                    help="time spine_bwd's cluster kernel under candidate plans instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.kernels.rwkv import rwkv as rk

    dev = torch.device("cuda")
    if args.spine_plans:
        spine_plans(dev)
        print(cs.smi())
        return 0
    for shape in SPINE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x, ls, ab, w, raw, t, y, w_inv = flow_inputs(shape, dtype, dev)
            # flow-step kernels of one path have no flowstep_path
            path = ({"path": fk.flowstep_path(x, raw, t)} if hasattr(fk, "flowstep_path")
                    else {})
            if "flowstep_fwd" in args.only:
                report(args.label, "flowstep_fwd", shape, dname,
                       lambda: fk.flowstep_fwd(x, ls, ab, w, raw, t), **path)
            if "flowstep_inv" in args.only:
                report(args.label, "flowstep_inv", shape, dname,
                       lambda: fk.flowstep_inv(y, ls, ab, w_inv, raw, t), **path)
            if "spine_bwd" in args.only:
                x2, gx2, w2, w2_inv, ls2, ab2 = spine_inputs(shape, dtype, dev)
                report(args.label, "spine_bwd", shape, dname,
                       lambda: fk.spine_bwd(x2, gx2, w2, w2_inv, ls2, ab2))
    if "wkv_scan" not in args.only:
        print(cs.smi())
        return 0
    prefill, decode = cs.WKV_SHAPES[-1], cs.WKV_DECODE_SHAPE
    r, k, v, w, u, s0 = cs.wkv_inputs(prefill, torch.float32, dev, cs.SEED + 25, model_like=True)
    report(args.label, "wkv_scan", prefill, "float32",
           lambda: rk.wkv_scan(r, k, v, w, u, state0=s0))
    del r, k, v, w, u, s0
    calls = itertools.cycle([cs.wkv_inputs(decode, torch.float32, dev, cs.SEED + 60 + i,
                                           model_like=True)
                             for i in range(cs.WKV_DECODE_LAYERS)])

    def decode_step():
        r, k, v, w, u, s0 = next(calls)
        return rk.wkv_scan(r, k, v, w, u, state0=s0)

    report(args.label, "wkv_scan", decode, "float32", decode_step)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

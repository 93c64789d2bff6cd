#!/usr/bin/env python3
"""Sweep the lane plans of the flow-step streams, or of the coupling row
stream, on one NVIDIA GPU.

    python3 tools/flow_plan_sweep.py [--coupling]

``flowstep_fwd`` and ``flowstep_inv`` at the GLOW widths run as a persistent
stream (``csrc/flowstep.cu``, ``flow_stream``) whose lane layout at each
width, ``(OUT, RPL, WARPS)``, is a template argument set by the macros
``FLOW_PLAN_12``, ``FLOW_PLAN_24`` and ``FLOW_PLAN_48`` (each
``OUT * 10000 + RPL * 100 + WARPS``).  This tool builds
``flowstep.cu`` once per row of ``CANDIDATES`` (each row sets all three
macros; all builds started together, with ``common.NVCC_FLAGS``) into
``build/flow_plans/``, and at the scanned GLOW's three (B, M, C) in f32 and
bf16 times both kernels under each plan, each call held against the plain
versions (``chip_smoke.py``'s tolerances; ld at ``TOL_LD_REL``).  One JSON
line per (kernel, shape, dtype): the device time of each plan
(``torch.profiler``, every kernel of the call summed) and which plan
``FLOW_PLAN`` picks; then the card's name and power limit.  ``FLOW_PLAN`` in
``kernels/flowstep/flowstep.py`` is the fastest of each width.

With ``--coupling`` it does the same for the coupling row stream
(``csrc/coupling.cu``, ``coupling_rows_kernel``), whose lane layout at
every width, ``(K, RPL, WARPS)`` (coupled columns and rows a lane computes,
warps a block), is set by the macro ``COUPLING_PLAN``, and whose forward
launches its ld reduce as a programmatic dependent of the stream unless
``COUPLING_PDL`` is 0: one build per row of ``COUPLING_CANDIDATES`` into
``build/coupling_plans/``; the forward and the inverse on whole rows at the
unrolled GLOW's three (B, M, C), f32 and bf16, held against
``coupling_fwd_rows_ref`` / ``coupling_inv_rows_ref`` (ld at ``TOL_LD_REL``
of sum |log_s|).  Each is read twice: the summed device time, and the
events' span of many calls queued back to back (``chip_smoke.queued_ms``),
which alone shows what the dependent launch overlaps.  ``COUPLING_PLAN``
in ``kernels/coupling/coupling.py`` is the fastest at every width.  Exits
2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (inputs, timing and tolerances as the smoke run's)

#: each row: the (OUT, RPL, WARPS) plan at C = 12, 24, 48
CANDIDATES = [
    ((12, 1, 8), (12, 2, 4), (6, 2, 8)),
    ((12, 1, 4), (12, 1, 8), (12, 1, 8)),
    ((6, 1, 8), (12, 2, 8), (6, 1, 8)),
    ((12, 2, 8), (6, 2, 8), (12, 2, 4)),
    ((6, 2, 8), (24, 1, 8), (24, 1, 8)),
]
#: each row: the coupling row stream's (K, RPL, WARPS) at every width, and
#: whether the forward's reduce is a programmatic dependent launch
COUPLING_CANDIDATES = [
    ((6, 1, 8), True),
    ((6, 1, 8), False),
    ((6, 1, 4), True),
    ((6, 1, 16), True),
    ((6, 2, 8), True),
    ((6, 2, 4), True),
]


def _code(plan) -> int:
    o, r, w = plan
    return o * 10000 + r * 100 + w


def flow_defs(row) -> list[str]:
    return [f"-DFLOW_PLAN_{c}={_code(plan)}" for c, plan in zip((12, 24, 48), row)]


def coupling_defs(row) -> list[str]:
    plan, pdl = row
    return [f"-DCOUPLING_PLAN={_code(plan)}", f"-DCOUPLING_PDL={int(pdl)}"]


def build_all(source: str = "flowstep.cu", defs_of=flow_defs,
              candidates=CANDIDATES) -> list[Path]:
    """One library of ``source`` per row of ``candidates``, built with the
    macros ``defs_of(row)``, all ``nvcc`` processes started together."""
    from repro_torch.kernels import common

    stem = source.removesuffix(".cu")
    out = ROOT / "build" / f"{stem.replace('flowstep', 'flow')}_plans"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, row in enumerate(candidates):
        defs = defs_of(row)
        lib = out / f"lib{stem}-plan{k}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS, *defs, "-o", str(lib),
               str(common.CSRC / source)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
    return [lib for lib, _ in procs]


def coupling_sweep(dev) -> None:
    """``--coupling``: one line per (kernel, shape, dtype), the row stream's
    device time, summed and queued, under each row of
    ``COUPLING_CANDIDATES``."""
    import torch
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling.ref import coupling_fwd_rows_ref, coupling_inv_rows_ref

    fns = []
    for lib in build_all("coupling.cu", coupling_defs, COUPLING_CANDIDATES):
        f = ctypes.CDLL(str(lib)).coupling_rows
        f.argtypes, f.restype = ck._SIGNATURES["coupling_rows"], ctypes.c_int
        fns.append(f)
    index, stream = torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream
    for shape in cs.SHAPES[:3]:
        b, m, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(cs.SEED + 13)
            x = torch.randn(shape, generator=g).to(dev, dtype)
            h = torch.randn(shape, generator=g).to(dev, dtype)
            y_r, ld_r = coupling_fwd_rows_ref(x, h)
            x_r = coupling_inv_rows_ref(y_r, h)
            scale = (2.0 * torch.tanh(h[..., : c // 2].float() / 2.0)).abs().sum(dim=(1, 2))
            y, xb, ld = torch.empty_like(x), torch.empty_like(x), torch.empty(b, device=dev)
            times = {"coupling_fwd": {}, "coupling_inv": {}}
            for row, f in zip(COUPLING_CANDIDATES, fns):
                (k, rpl, _), pdl = row
                key = f"{row[0]}{'' if pdl else ' no pdl'}"
                partial = torch.empty(b, -(-m // (rpl * 32 // (c // 2 // k))), device=dev)

                def fwd(f=f, partial=partial):
                    return f(KERNEL_DTYPES[dtype], 0, x.data_ptr(), h.data_ptr(), y.data_ptr(),
                             partial.data_ptr(), ld.data_ptr(), b, m, c, 2.0, index, stream)

                def inv(f=f):
                    return f(KERNEL_DTYPES[dtype], 1, y_r.data_ptr(), h.data_ptr(),
                             xb.data_ptr(), None, None, b, m, c, 2.0, index, stream)

                if fwd() != 0 or inv() != 0:
                    times["coupling_fwd"][key] = times["coupling_inv"][key] = "refused"
                    continue
                torch.cuda.synchronize()
                ok = {}
                for name, a, r in (("coupling_fwd", y, y_r), ("coupling_inv", xb, x_r)):
                    d = (a.float() - r.float()).abs()
                    ok[name] = (d.max().item() <= cs.TOL_F32 if dtype == torch.float32 else
                                not (d > cs.TOL_BF16 + cs.TOL_BF16 * r.float().abs()).any().item())
                ld_err = ((ld - ld_r).abs() / scale.clamp_min(1.0)).max().item()
                ok["coupling_fwd"] &= ld_err <= cs.TOL_LD_REL
                for name, fn in (("coupling_fwd", fwd), ("coupling_inv", inv)):
                    times[name][key] = ({"summed": 1e3 * cs.device_ms(fn)[0],
                                         "queued": 1e3 * cs.queued_ms(fn)} if ok[name]
                                        else "wrong")
            for name, by_plan in times.items():
                print(json.dumps({"kernel": name, "shape": list(shape),
                                  "dtype": str(dtype).removeprefix("torch."),
                                  "device_us_by_plan": by_plan,
                                  "coupling_plan": str(ck.COUPLING_PLAN)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coupling", action="store_true",
                    help="sweep the coupling row stream's plans instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flow_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.coupling:
        coupling_sweep(torch.device("cuda"))
        print(cs.smi())
        return 0
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fns = []
    for lib in build_all():
        f = ctypes.CDLL(str(lib)).flowstep_stream
        f.argtypes, f.restype = fk._SIGNATURES["flowstep_stream"], ctypes.c_int
        fns.append(f)
    index, stream = torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream
    for shape in cs.SHAPES[:3]:
        b, m, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x, ls, ab, w, raw, t = cs.step_inputs(shape, dtype, dev, cs.SEED)
            y_r, ld_r = flowstep_fwd_ref(x, ls, ab, w, raw, t)
            w_inv = torch.linalg.inv(w)
            x_r = flowstep_inv_ref(y_r, ls, ab, w_inv, raw, t)
            y, xb, ld = torch.empty_like(x), torch.empty_like(x), torch.empty(b, device=dev)
            times = {"flowstep_fwd": {}, "flowstep_inv": {}}
            for row, f in zip(CANDIDATES, fns):
                plan = row[(12, 24, 48).index(c)]
                partial = torch.empty(b, -(-m // fk.stream_rows(c, {c: plan})), device=dev)

                def fwd(f=f, partial=partial):
                    return f(KERNEL_DTYPES[dtype], 0, x.data_ptr(), ls.data_ptr(), ab.data_ptr(),
                             w.data_ptr(), *w.stride(), raw.data_ptr(), y.data_ptr(),
                             partial.data_ptr(), ld.data_ptr(), b, m, c, 2.0, index, stream)

                def inv(f=f):
                    return f(KERNEL_DTYPES[dtype], 1, y_r.data_ptr(), ls.data_ptr(),
                             ab.data_ptr(), w_inv.data_ptr(), *w_inv.stride(), raw.data_ptr(),
                             xb.data_ptr(), None, None, b, m, c, 2.0, index, stream)

                if fwd() != 0 or inv() != 0:
                    times["flowstep_fwd"][str(plan)] = times["flowstep_inv"][str(plan)] = "refused"
                    continue
                torch.cuda.synchronize()
                ok = {}
                for name, a, r in (("flowstep_fwd", y, y_r), ("flowstep_inv", xb, x_r)):
                    d = (a.float() - r.float()).abs()
                    ok[name] = (d.max().item() <= cs.TOL_F32 if dtype == torch.float32 else
                                not (d > cs.TOL_BF16 + cs.TOL_BF16 * r.float().abs()).any().item())
                ld_err = ((ld - ld_r).abs() / ld_r.abs().clamp_min(1.0)).max().item()
                ok["flowstep_fwd"] &= ld_err <= cs.TOL_LD_REL
                for name, fn in (("flowstep_fwd", fwd), ("flowstep_inv", inv)):
                    times[name][str(plan)] = (1e3 * cs.device_ms(fn)[0] if ok[name]
                                              else "wrong")
            for name, by_plan in times.items():
                print(json.dumps({"kernel": name, "shape": list(shape), "dtype": dname,
                                  "device_us_by_plan": by_plan,
                                  "flow_plan": str(fk.FLOW_PLAN[c])}), flush=True)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

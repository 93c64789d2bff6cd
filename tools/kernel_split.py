#!/usr/bin/env python3
"""Device time of ``flowstep_fwd``, ``flowstep_inv``, ``spine_bwd``, the
coupling layer's op (``coupling_fwd``, ``coupling_inv``) and its backward
(``coupling_bwd``), ``wkv_scan`` and ``flash_attention`` on one NVIDIA GPU,
split by the CUDA kernels each call launches.

    python3 tools/kernel_split.py [--src DIR] [--label NAME] [--only KERNEL ...]
    python3 tools/kernel_split.py --chint

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
into its own checkout's ``build/``.

``coupling_fwd`` / ``coupling_inv`` time the unrolled GLOW layer's coupling
op at its three (B, M, C) = (8, 16384, 12), (8, 4096, 24), (8, 1024, 48),
f32 and bf16, from the layer's input (or output) row and its conditioner
output h to the merged (B, M, C) row (and ld), as the checkout's layer does
it under ``no_grad``: where the checkout has the row op
(``fused_coupling_fwd_rows``), that op; else the half kernel on the first
half and ``torch.cat`` with the second.  ``coupling_bwd`` times the
backward as its callers run it, from the layer's output row y, h and the
row cotangent gy to x, gx and gh = (graw | gt), each a whole (B, M, C) row:
where the checkout has the backward's row op (``fused_coupling_bwd_rows``),
that op; else the half kernel on the first half and the callers' three
``torch.cat`` (x, gx and gh).  Each point is read
twice, "warm" (the same inputs call after call, as far as they fit in the
50 MB L2) and "flushed" (a 64 MB buffer read, by a sum, before each call, so
that the call's inputs come from HBM and the lines left in L2 are clean),
each as the summed device time of the call's kernels (the flush's left out)
and as the events' span of many calls queued back to back behind a spin
kernel (``chip_smoke.queued_ms``; flushed: the span of flush-and-call
pairs less that of the flushes alone, the median of three), which counts
the gaps between a call's kernels.

``flash_attention`` times the causal f32 kernel at yi-6b's prefill (8, 32,
4, 2048, 128), whatever path the checkout gives it, beside
``F.scaled_dot_product_attention`` on the same inputs (302 MB, more than
the L2), by the summed device time of each (5 calls), and by
``--flash-readings`` flushed readings of one call each, the kernel's and
SDPA's taken in turn: each call's span between CUDA events after a 64 MB L2
flush, with the SM clock just before and just after it, read as the cycles
of a ``torch.cuda._sleep`` spin on the same stream over its events' span.
The line gives each reading with its two clocks, and the median, least and
greatest reading of each.

``conv1x1_mm`` times the kernel at ``chip_smoke.py``'s three (B, M, C),
f32 and bf16, beside ``torch.matmul`` of the same x and W (W cast to x's
dtype, as ``[times]`` calls it), each warm and after the 64 MB flush, by the
summed device time of their kernels.

With ``--chint`` it times instead the cHINT path's cross couplings (HINT's
half contract, h = (raw | t) twice the half's width, M = 1; the tile path):
``coupling_bwd`` at a train step's (256, 1, 16) and (256, 1, 8) and
``coupling_inv`` at a sample's (20000, 1, 16 / 8) and a draw's (2048, 1, 16
/ 8), f32, each as HINT calls it (the row op: for the backward the half
kernel and the join of gh) and as the half kernel alone, warm and flushed,
summed and as the span, beside the plain version's summed time and the
bound.

Prints one JSON line per point, then the card's name and power limit.  With
``--spine-plans`` it times instead ``spine_bwd``'s cluster kernel at the
same points under candidate launch plans (blocks a cluster, blocks in all)
beside the plan ``spine_plan`` picks, each held against ``spine_bwd_ref``
at ``chip_smoke.py``'s ``TOL_SUM``.  Exits 2 without a CUDA device.
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
KERNELS = ("flowstep_fwd", "flowstep_inv", "spine_bwd", "coupling_fwd", "coupling_inv",
           "coupling_bwd", "conv1x1_mm", "wkv_scan", "flash_attention")
COUPLING_KERNELS = ("coupling_fwd", "coupling_inv", "coupling_bwd")
#: bytes read before each call of a "flushed" reading: more than the L2;
#: and the names of the kernels the flush's sum launches (its reduction and
#: the memset of its output), which the summed reading leaves out
FLUSH_BYTES = 64 << 20
FLUSH_KERNELS = ("ReduceOp", "Memset")
#: cycles of the spin that reads the SM clock beside a flushed reading
#: (about 1 ms at the H100's 1980 MHz)
PROBE_CYCLES = 2_000_000


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


def summed_us(fn, flush=None, reps: int = 20, attempts: int = 10):
    """The summed device time (µs) of one call's kernels and its split by
    kernel name (``torch.profiler``), each call after ``flush`` where given,
    whose reduction kernels are left out of the sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if cs._is_device_event(e)
                   and (flush is None or not any(k in e.key for k in FLUSH_KERNELS))]
        if sum(e.device_time_total for e in kernels) > 0 and sum(e.count for e in kernels) >= reps:
            split: dict[str, float] = {}
            for e in kernels:
                name = cs._kernel_name(e.key)
                split[name] = split.get(name, 0.0) + e.device_time_total / reps
            return sum(split.values()), split
    return None, None


def coupling_points(label, names, dev) -> None:
    """The coupling op's lines (module docstring): each kernel in ``names``
    at each (shape, dtype), warm and flushed, by both readings."""
    import torch

    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling import ops as cops

    rows = hasattr(cops, "fused_coupling_fwd_rows")
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)

    def flush():  # read, so the lines it leaves in L2 are clean
        return flush_buf.sum()

    def flushed():
        flush()
        return fn()

    for shape in SPINE_SHAPES:
        b, m, c = shape
        ca = c // 2
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(cs.SEED + 13)
            x = torch.randn(shape, generator=g).to(dev, dtype)
            h = torch.randn(shape, generator=g).to(dev, dtype)
            raw, t = h[..., :ca], h[..., ca:]
            gy = torch.randn(shape, generator=g).to(dev, dtype)
            gld = torch.randn(b, generator=g).to(dev)
            if rows:
                ops = {"coupling_fwd": lambda: cops.fused_coupling_fwd_rows(x, h),
                       "coupling_inv": lambda: cops.fused_coupling_inv_rows(y, h)}
            else:  # the half kernel, then the layer's join
                ops = {"coupling_fwd": lambda: torch.cat(
                           [cops.fused_coupling_fwd(x[..., :ca], raw, t)[0], x[..., ca:]], dim=-1),
                       "coupling_inv": lambda: torch.cat(
                           [cops.fused_coupling_inv(y[..., :ca], raw, t), y[..., ca:]], dim=-1)}
            if hasattr(cops, "fused_coupling_bwd_rows"):
                ops["coupling_bwd"] = lambda: cops.fused_coupling_bwd_rows(y, h, gy, gld)
            else:  # the half kernel, then its callers' joins of x, gx and gh

                def half_and_joins():
                    xa, gxa, graw, gt = ck.coupling_bwd(y[..., :ca], raw, t, gy[..., :ca], gld)
                    return (torch.cat([xa, y[..., ca:]], dim=-1),
                            torch.cat([gxa, gy[..., ca:]], dim=-1),
                            torch.cat([graw, gt], dim=-1))

                ops["coupling_bwd"] = half_and_joins
            bwd_rows = hasattr(cops, "fused_coupling_bwd_rows")
            with torch.no_grad():
                y = ops["coupling_fwd"]()
                y = y[0] if rows else y
            for name in names:
                kernel = getattr(ck, name)
                before = dict(getattr(kernel, "launches_by_path", {}))
                with torch.no_grad():
                    fn = ops[name]
                    fn()
                    torch.cuda.synchronize()
                    path = [p for p, n in getattr(kernel, "launches_by_path", {}).items()
                            if n != before[p]]
                    readings = {}
                    for reading, fl in (("warm", None), ("flushed", flush)):
                        total, split = summed_us(fn, fl)
                        # the events' span of many queued calls, less that
                        # of as many flushes alone (the median of three
                        # such differences)
                        span = (1e3 * cs.queued_ms(fn) if fl is None else 1e3 * sorted(
                            cs.queued_ms(flushed) - cs.queued_ms(flush) for _ in range(3))[1])
                        readings[reading] = {"summed_us": total, "span_us": span,
                                             "summed_us_by_kernel": split}
                if name == "coupling_bwd":
                    op = "row op" if bwd_rows else "half kernel + 3 torch.cat"
                else:
                    op = "row op" if rows else "half kernel + torch.cat"
                print(json.dumps({
                    "label": label, "kernel": name, "op": op, "shape": list(shape),
                    "dtype": str(dtype).removeprefix("torch."),
                    "path": path[0] if len(path) == 1 else None,
                    "bound_us": 1e3 * cs.bound_ms(f"{name}_rows", shape, dtype),
                    **readings}), flush=True)


def conv1x1_points(label, dev) -> None:
    """``conv1x1_mm`` beside ``torch.matmul`` (module docstring)."""
    import torch

    from repro_torch.kernels.conv1x1 import conv1x1 as c1k

    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)

    def flush():
        return flush_buf.sum()

    for shape in cs.CONV1X1_SHAPES[:3]:
        for dtype in (torch.float32, torch.bfloat16):
            xm, _gm, wm = cs.conv1x1_inputs(shape, dtype, dev, cs.SEED + 14)
            wd = wm.to(dtype)
            readings = {}
            for reading, fl in (("warm", None), ("flushed", flush)):
                kernel, split = summed_us(lambda: c1k.conv1x1_mm(xm, wm), fl)
                library, lib_split = summed_us(lambda: torch.matmul(xm, wd), fl)
                readings[reading] = {"summed_us": kernel, "summed_us_by_kernel": split,
                                     "matmul_summed_us": library,
                                     "matmul_summed_us_by_kernel": lib_split}
            print(json.dumps({
                "label": label, "kernel": "conv1x1_mm", "shape": list(shape),
                "dtype": str(dtype).removeprefix("torch."), "path": c1k.mm_path(xm),
                "bound_us": 1e3 * cs.bound_ms("conv1x1_mm", shape, dtype), **readings}),
                flush=True)


def chint_points(label, dev) -> None:
    """``--chint`` (module docstring): the cross couplings at M = 1."""
    import torch

    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling.ref import (coupling_bwd_ref, coupling_bwd_rows_ref,
                                                  coupling_inv_ref, coupling_inv_rows_ref)

    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)

    def flush():
        return flush_buf.sum()

    points = [("coupling_bwd", (cs.CHINT_BATCH, 1, cb)) for cb in (16, 8)] + [
        ("coupling_inv", (n, 1, cb)) for n in (cs.CHINT_SAMPLE, cs.CHINT_DRAW) for cb in (16, 8)]
    for name, shape in points:
        b, m, cb = shape
        g = torch.Generator().manual_seed(cs.SEED + 45)
        state = torch.randn(b, 2 * cb, generator=g).to(dev)
        h = torch.randn(b, m, 2 * cb, generator=g).to(dev)
        v = state[:, cb:].reshape(shape)  # a strided half, as a node passes it
        raw, t = h[..., :cb], h[..., cb:]
        if name == "coupling_bwd":
            gy = torch.randn(shape, generator=g).to(dev)
            gld = torch.randn(b, generator=g).to(dev)
            calls = {"row op": lambda: ck.coupling_bwd.rows(v, h, gy, gld),
                     "half kernel": lambda: ck.coupling_bwd(v, raw, t, gy, gld),
                     "plain": lambda: coupling_bwd_rows_ref(v, h, gy, gld),
                     "plain half": lambda: coupling_bwd_ref(v, raw, t, gy, gld)}
            cost = "coupling_bwd_half"
        else:
            calls = {"row op": lambda: ck.coupling_inv.rows(v, h),
                     "half kernel": lambda: ck.coupling_inv(v, raw, t),
                     "plain": lambda: coupling_inv_rows_ref(v, h),
                     "plain half": lambda: coupling_inv_ref(v, raw, t)}
            cost = "coupling_inv"
        readings = {}
        for what, fn in calls.items():
            for reading, fl in (("warm", None), ("flushed", flush)):
                total, split = summed_us(fn, fl)
                readings[f"{what}, {reading}"] = {"summed_us": total,
                                                  "summed_us_by_kernel": split}
            readings[f"{what}, warm"]["span_us"] = 1e3 * cs.queued_ms(fn)
        print(json.dumps({"label": label, "kernel": name, "path": ck.coupling_path(v, raw, t),
                          "shape": list(shape), "dtype": "float32",
                          "bound_us": 1e3 * cs.bound_ms(cost, shape, torch.float32),
                          **readings}), flush=True)


def clocked_reading(fn, flush) -> tuple[float, float, float]:
    """One call of ``fn`` after ``flush``: its span (µs) between CUDA events,
    and the SM clock (MHz) just before and just after it, each from the
    events' span of a ``PROBE_CYCLES`` spin on the same stream."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    flush()
    ev[0].record()
    torch.cuda._sleep(PROBE_CYCLES)
    ev[1].record()
    fn()
    ev[2].record()
    torch.cuda._sleep(PROBE_CYCLES)
    ev[3].record()
    torch.cuda.synchronize()
    return (1e3 * ev[1].elapsed_time(ev[2]), PROBE_CYCLES / (1e3 * ev[0].elapsed_time(ev[1])),
            PROBE_CYCLES / (1e3 * ev[2].elapsed_time(ev[3])))


def reading_stats(readings) -> dict:
    """Median, least and greatest of ``clocked_reading`` results, and each
    reading as [µs, MHz before, MHz after]."""
    us = sorted(r[0] for r in readings)
    n = len(us)
    return {"median_us": (us[(n - 1) // 2] + us[n // 2]) / 2, "min_us": us[0], "max_us": us[-1],
            "readings_us_mhz_before_after": [list(r) for r in readings]}


def attention_point(label, dev, n_readings: int) -> None:
    """The causal f32 ``flash_attention`` at yi-6b's prefill beside SDPA: the
    summed device time of each, ``n_readings`` clocked flushed readings of
    each taken in turn, the path the kernel took, both bounds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention as ak

    shape = cs.ATTN_SHAPES[3]
    q, k, v = cs.attention_inputs(shape, torch.float32, dev, cs.SEED + 22)
    before = dict(ak.flash_attention.launches_by_path)
    ak.flash_attention(q, k, v)
    torch.cuda.synchronize()
    path = [p for p, n in ak.flash_attention.launches_by_path.items() if n != before.get(p, 0)]
    kernel_us, split = summed_us(lambda: ak.flash_attention(q, k, v), reps=5)
    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    sdpa_us, _ = summed_us(sdpa, reps=5)
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    readings = {"kernel": [], "sdpa": []}
    for _ in range(n_readings):
        readings["kernel"].append(clocked_reading(lambda: ak.flash_attention(q, k, v), buf.sum))
        readings["sdpa"].append(clocked_reading(sdpa, buf.sum))
    nbytes, flops = cs.cost("flash_attention", shape, torch.float32)
    print(json.dumps({"label": label, "kernel": "flash_attention", "shape": list(shape),
                      "dtype": "float32", "causal": True, "path": path[0] if path else None,
                      "summed_us": kernel_us, "summed_us_by_kernel": split,
                      "sdpa_summed_us": sdpa_us,
                      "flushed": {k: reading_stats(v) for k, v in readings.items()},
                      "bound_us_tf32_rate": 1e3 * cs.bound_ms("flash_attention", shape,
                                                              torch.float32),
                      "bound_us_f32_rate": 1e6 * max(nbytes / cs.H100_BYTES_PER_S,
                                                     flops / cs.H100_F32_FLOPS)}), flush=True)


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
    ap.add_argument("--flash-readings", type=int, default=15,
                    help="clocked flushed readings of flash_attention and of SDPA")
    ap.add_argument("--spine-plans", action="store_true",
                    help="time spine_bwd's cluster kernel under candidate plans instead")
    ap.add_argument("--chint", action="store_true",
                    help="time the cHINT path's cross couplings at M = 1 instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.kernels.rwkv import rwkv as rk

    dev = torch.device("cuda")
    if args.spine_plans or args.chint:
        if args.spine_plans:
            spine_plans(dev)
        else:
            chint_points(args.label, dev)
        print(cs.smi())
        return 0
    coupling = [k for k in args.only if k in COUPLING_KERNELS]
    if coupling:
        coupling_points(args.label, coupling, dev)
    if "flash_attention" in args.only:
        attention_point(args.label, dev, args.flash_readings)
    if "conv1x1_mm" in args.only:
        conv1x1_points(args.label, dev)
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

#!/usr/bin/env python3
"""Sweep the launch plans of ``conv1x1_gw``'s cluster kernel on one NVIDIA GPU.

    python3 tools/gw_plan_sweep.py

For the unrolled GLOW's three (B, M, C) in f32 and bf16 it times the cluster
kernel (``csrc/conv1x1.cu``) under each candidate plan: the columns of x a
slice takes (``xw``), the clusters of each slice and the blocks of a cluster,
with ``gw_plan``'s slab sizes.  Each plan's result is held against
``conv1x1_gw_ref`` (the ``TOL_SUM`` of ``chip_smoke.py``) and a second call
(bitwise).  One JSON line per (shape, dtype): the device time of each plan
(``torch.profiler``, every kernel of the call summed), ``x.T @ gy``'s in the
same run, and the plan ``GW_PLAN`` picks; then the card's name and power
limit.  ``GW_PLAN`` in ``kernels/conv1x1/conv1x1.py`` is the fastest row of
each line.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48)]
TOL_SUM = {"float32": 1e-4, "bfloat16": 5e-2}


def device_us(fn, reps: int = 20) -> float | None:
    """Summed device time of the kernels of one call, in µs (None if the
    profiler lost the window ten times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
        if sum(e.count for e in kernels) >= reps:
            return sum(e.device_time_total for e in kernels) / reps
    return None


def candidates(c: int) -> list[tuple[int, int, int]]:
    """(xw, clusters a slice, blocks a cluster) at the slice width the kernel
    is built for (``launch_gw_cluster_c``: whole rows at C = 12 and 24, 16
    columns of x at C = 48); one block to 16 a cluster."""
    xw = 16 if c == 48 else c
    return [(xw, 128 // (c // xw), 1), (xw, 40, 1), (xw, 16, 8), (xw, 8, 8), (xw, 8, 4),
            (xw, 4, 16), (xw, 4, 8), (xw, 2, 16), (xw, 1, 16)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gw_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.conv1x1 import conv1x1 as ck
    from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = ck._fn("conv1x1_gw_cluster")
    for shape in SHAPES:
        n, c = shape[0] * shape[1], shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            g = torch.Generator().manual_seed(7)
            x = torch.randn(shape, generator=g).to(dev, dtype)
            gy = torch.randn(shape, generator=g).to(dev, dtype)
            ref = conv1x1_gw_ref(x, gy)
            es = x.element_size()
            rows = []
            for xw, clusters, cl in candidates(c):
                cta, slab = ck.gw_rows(n, c, es, xw, clusters * cl)
                partial = torch.empty((clusters, c * c), device=dev)
                gw = torch.empty((c, c), device=dev)

                def call():
                    return launch(ck.KERNEL_DTYPES[dtype], x.data_ptr(), gy.data_ptr(),
                                  partial.data_ptr(), gw.data_ptr(), n, c, xw, cta, slab,
                                  clusters, cl, dev.index or 0,
                                  torch.cuda.current_stream().cuda_stream)

                err = call()
                torch.cuda.synchronize()
                if err:
                    rows.append({"xw": xw, "clusters": clusters, "cluster_size": cl,
                                 "cuda_error": err})
                    continue
                first = gw.clone()
                call()
                torch.cuda.synchronize()
                rel = ((gw - ref).abs().max() / ref.abs().max()).item()
                rows.append({"xw": xw, "clusters": clusters, "cluster_size": cl,
                             "us": device_us(call), "max_rel_err": rel,
                             "ok": rel <= TOL_SUM[dname] and torch.equal(gw, first)})
            picked = ck.gw_plan(n, c, es, n_sm)
            print(json.dumps({
                "shape": list(shape), "dtype": dname, "plans": rows,
                "library_us": device_us(lambda: x.reshape(-1, c).T @ gy.reshape(-1, c)),
                "gw_plan": picked}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

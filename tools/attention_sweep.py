#!/usr/bin/env python3
"""Sweep the plans of the f32 flash-attention TF32 kernel on one NVIDIA GPU.

    python3 tools/attention_sweep.py

``flash_attention`` in f32 with a head dim that is a multiple of 8 runs on
the TF32 tensor cores (``csrc/attention.cu``, ``flash_attention_tf32_kernel``)
under a plan set by the macro ``TF32_PLAN``: key rows of a K/V tile,
stages of the ``cp.async`` ring and warps of a block, as ``KEYS * 10000 +
STAGES * 100 + WARPS``.  This tool builds
``attention.cu`` once per row of ``CANDIDATES`` (all builds started
together, with ``common.NVCC_FLAGS``) into ``build/attention_plans/``, reads
each build's registers and spills of the TF32 kernel from ``ptxas``, holds
each candidate against ``attention_ref`` at the reference's f32 gate (rtol =
atol = 2e-5) at ``chip_smoke.py``'s ``ATTN_SHAPES`` whose head dim is a
multiple of 8, causal or not, and times it causal at yi-6b's prefill (8, 32,
4, 2048, 128) and at (2, 8, 2, 256, 64) (``torch.profiler``, the summed
device time of a call).  One JSON line per candidate, then the card's name
and power limit.  ``TF32_PLAN`` in ``kernels/attention/attention.py`` names
the fastest at yi-6b's prefill.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (inputs, timing and tolerances as the smoke run's)

#: each row: (keys, stages, warps)
CANDIDATES = [(32, 3, 4), (64, 2, 8), (32, 3, 8)]


def build_all() -> list[tuple[Path, str]]:
    """One library of ``attention.cu`` per candidate, with its ``ptxas``
    report; all ``nvcc`` processes started together."""
    from repro_torch.kernels import common

    out = ROOT / "build" / "attention_plans"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, (keys, stages, warps) in enumerate(CANDIDATES):
        lib = out / f"libattention-plan{k}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS,
               f"-DTF32_PLAN={keys * 10000 + stages * 100 + warps}", "-o", str(lib),
               str(common.CSRC / "attention.cu")]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
        built.append((lib, log))
    return built


def tf32_registers(log: str) -> dict:
    """``{padded head dim: (registers, spill store bytes)}`` of the TF32
    kernel's instantiations in a ``ptxas -v`` report."""
    out, dp = {}, None
    for ln in log.splitlines():
        m = re.search(r"flash_attention_tf32_kernelILi(\d+)E", ln)
        if "Compiling entry function" in ln:
            dp = int(m.group(1)) if m else None
        elif dp is not None and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            out[dp] = [None, spill]
        elif dp is not None and "registers" in ln:
            out[dp][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.attention.ref import attention_ref

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    index, stream = torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream
    shapes = [s for s in cs.ATTN_SHAPES if s[-1] % ak.TF32_HEAD_DIM_STEP == 0]
    inputs = {s: cs.attention_inputs(s, torch.float32, dev, cs.SEED + 15) for s in shapes}
    refs = {(s, c): attention_ref(*inputs[s], c).float() for s in shapes for c in (True, False)}
    tol = cs.TOL_ATTN["float32"]
    for (keys, stages, warps), (lib, log) in zip(CANDIDATES, build_all()):
        fn = ctypes.CDLL(str(lib)).flash_attention_tf32
        fn.argtypes, fn.restype = ak._TC_SIGNATURE, ctypes.c_int

        def call(q, k, v, causal=True):
            o = torch.empty_like(q)
            b, hq, sq, d = q.shape
            st = [x for t in (q, k, v, o) for x in t.stride()[:3]]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, k.shape[1],
                     sq, k.shape[2], d, (ctypes.c_longlong * 12)(*st), int(causal), d**-0.5,
                     index, stream)
            if err != 0:
                raise RuntimeError(f"flash_attention_tf32 launch failed: {err}")
            return o

        worst, ok = 0.0, True
        for (shape, causal), r in refs.items():
            o = call(*inputs[shape], causal)
            d = (o - r).abs()
            worst = max(worst, d.max().item())
            ok = ok and bool((d <= tol + tol * r.abs()).all())
            ok = ok and torch.equal(o, call(*inputs[shape], causal))
        times = {str(s): 1e3 * cs.device_ms(lambda s=s: call(*inputs[s]), reps=5)[0]
                 for s in (cs.ATTN_SHAPES[3], cs.ATTN_SHAPES[1])}
        print(json.dumps({"plan": [keys, stages, warps],
                          "registers_and_spill_bytes": tf32_registers(log),
                          "within_2e-5_and_repeatable": ok, "max_abs_err": worst,
                          "causal_us": times}), flush=True)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It serves and trains scanned GLOW (``GLOW_SCANNED``: 3 scales x 8 steps,
hidden 64, Haar squeeze) at full width on 256x256x3 images, batch 8, with
random weights from a seed, and holds every hand-written kernel on those
paths against its plain PyTorch version.  Phases, one line each:

1. build   - compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
             sm_90a, one process per source, all started together);
2. kernels - each kernel against its plain version at the model's shapes and
             a ragged one, in f32 and bf16; the logdet and the backward's sums
             over (b, m) are bitwise repeatable;
3. serve   - ``FlowServeEngine`` on cuda: ``log_prob`` against the same model
             on the CPU, ``sample`` then ``log_prob`` of the samples, the round
             trip ``forward(inverse(z)) == z``, and 24 + 24 kernel launches;
4. train   - ``grad_mode="coupled"`` with ``coupled_bwd="auto"`` (which must
             resolve to the reversible backward on cuda): one
             ``value_and_grad_nll`` against the same model on the CPU and
             against the ``stored`` backward on the card, 24 launches each of
             ``flowstep_fwd``, ``coupling_bwd`` and ``spine_bwd`` and none of
             ``flowstep_inv`` per train step, then ``train_flow`` for 5 steps;
5. memory  - peak device memory of one train step at 4 and 8 steps a scale,
             ``coupled`` (reversible) and ``autodiff``: the coupled peak must
             grow by less than a quarter of the autodiff peak's growth;
6. times   - each kernel's device time (profiler) and per-call wall time (CUDA
             events) beside its bound and its plain version's; end-to-end
             ``log_prob``, ``sample`` and the train step; one profiled call of
             each, with device time by op and the device's idle share (tables
             written to ``chiprun_out/chip_smoke/``).

Any failure exits non-zero.  Without a CUDA device it exits 2 and prints no
result.  The last lines are the card's name and power limit, one JSON object
of per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
SEED = 20261017
BATCH, HW = 8, 256
# the served shapes of flowstep_fwd / flowstep_inv, (B, M, C), plus a ragged M
SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (8, 300, 12)]
#: one NVIDIA H100 SXM (data sheet): HBM bytes/s and non-tensor-core f32 FLOP/s
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

# tolerances, with their reasons
TOL_F32 = 1e-4        # per element in f32: the reference's own kernel bound
TOL_BF16 = 2e-2       # rtol = atol on f32-upcast bf16 values (one bf16 ulp apart)
TOL_LD_REL = 1e-5     # ld sums B*M*ca terms in another order
TOL_LOG_PROB = 1e-5   # relative: log_prob scales with D = 196,608
TOL_ROUND_TRIP = 1e-4  # per element in f32, as TOL_F32
# the backward's sums over (b, m) (gW, g_log_s, g_b): max |a - r| <= TOL_SUM *
# max |r| per tensor.  Each is a sum of B*M terms (up to 131,072) in another
# order than the plain version's, so an entry that cancels to near zero keeps
# the round-off of the large partial sums (7.5e-4 absolute at (8, 4096, 24)
# in f32): the bound scales with the tensor, not with each entry.
TOL_SUM = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_LOSS_REL = 1e-5   # the train loss on the card against the CPU
# each gradient leaf: max |g - g_ref| <= TOL_GRAD_REL * max |g_ref|; the
# reversible backward rebuilds each step's input through up to 24 inversions
TOL_GRAD_REL = 1e-4
TRAIN_STEPS = 5


def line(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv, sort_keys=False), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def perturb(module, seed: int, scale: float = 0.05):
    """Add noise of std ``scale / sqrt(fan_in)`` to every float parameter of
    the stacked flow (as ``tests/test_torch_glow.py`` does): ``init`` zeroes
    actnorm and each conditioner's last conv, which would make every coupling
    the identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = scale / math.sqrt(math.prod(p.shape[1:-1]))
            p.add_(std * torch.randn(p.shape, generator=g).to(p.device))


def step_inputs(shape, dtype, dev, seed):
    """x, an_log_s, an_b, W, raw, t of one flow step; raw and t are the two
    halves of one conditioner output, as the served path passes them."""
    import torch

    b, m, c = shape
    ca = c // 2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, m, c, generator=g).to(dev, dtype)
    ls, ab = 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w = torch.randn(c, c, generator=g) / math.sqrt(c) + torch.eye(c)
    h = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    return x, ls.to(dev), ab.to(dev), w.to(dev), h[..., :ca], h[..., ca:]


def cost(name: str, shape, dtype):
    """(bytes, flops) the function needs at the flow step's (B, M, C): each
    input read once, each output written once; a C-long product at 2 flops a
    term, the elementwise work at one flop per operation (tanh and exp
    counted as one).  ``coupling_bwd`` works on the C/2 transformed
    channels."""
    import torch

    b, m, c = shape
    ca = c // 2
    es = torch.tensor([], dtype=dtype).element_size()
    if name == "spine_bwd":
        # x2, gx2 in; x, gx out; W, W^-1, an_log_s, an_b in; gW, g_ls, g_b out
        nbytes = 4 * es * b * m * c + 4 * (2 * c * c + 2 * c) + 4 * (c * c + 2 * c)
        # x1, gx1 and gW: three C-long products an element; x, gx, g_ls, g_b: 6
        return nbytes, b * m * c * (6 * c + 6)
    if name == "coupling_bwd":
        # y, raw, t, gy in; x, gx, graw, gt out; gld in
        return 8 * es * b * m * ca + 4 * b, 15 * b * m * ca
    big = es * (b * m * c + 2 * b * m * ca + b * m * c)  # x|y, raw, t, y|x
    small = 4 * (c * c + 2 * c)                           # W, an_log_s, an_b
    if name == "flowstep_fwd":
        return big + small + 4 * b, b * m * c * (2 * c + 2) + b * m * ca * 7
    return big + small, b * m * c * (2 * c + 2) + b * m * ca * 6


def bound_ms(name, shape, dtype) -> float:
    nbytes, flops = cost(name, shape, dtype)
    return 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS)


def bound_by(name, shape, dtype) -> str:
    nbytes, flops = cost(name, shape, dtype)
    return "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_F32_FLOPS else "operations"


def call_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Wall time of one call, launches back to back between CUDA events: the
    caller's view, which includes the host work of each call."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _is_device_event(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_ms(fn, reps: int = 20, attempts: int = 3) -> float:
    """Device time of one call: the summed durations of every kernel the call
    launches, from the profiler (host work and gaps between launches are not
    counted).  The profiler now and then returns a window of a few-µs
    kernels with no device events at all; such a window is taken again, up
    to ``attempts`` times, and the run fails if none has any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages() if _is_device_event(e))
        if total_us > 0:
            return total_us / reps / 1e3
    raise SystemExit("chip_smoke: FAILED: the profiler recorded no device time")


def check_bwd_kernels(dev) -> dict:
    """Phase 2, the backward kernels: ``spine_bwd`` and ``coupling_bwd``
    against their plain versions at the trained shapes and a ragged one, in
    f32 and bf16, on strided halves as the flow step passes them; the sums
    over (b, m) bitwise repeatable.  Returns each kernel's largest
    per-element f32 error."""
    import torch
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.coupling.ref import coupling_bwd_ref
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ref import spine_bwd_ref

    max_err = {"spine_bwd": 0.0, "coupling_bwd": 0.0}
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x2, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED + 5)
            g = torch.Generator().manual_seed(SEED + 6)
            gx2 = torch.randn(shape, generator=g).to(dev, dtype)
            gld = torch.randn(shape[0], generator=g).to(dev)
            w_inv = torch.linalg.inv(w)
            ca = shape[-1] // 2
            got = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
            again = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
            ref = spine_bwd_ref(x2, gx2, w, w_inv, ls, ab)
            c_got = ckern.coupling_bwd(x2[..., :ca], raw, t, gx2[..., :ca], gld)
            c_ref = coupling_bwd_ref(x2[..., :ca], raw, t, gx2[..., :ca], gld)
            torch.cuda.synchronize()
            errs = {}
            for name, pairs in (("spine_bwd", zip(got[:2], ref[:2])), ("coupling_bwd", zip(c_got, c_ref))):
                for a, r in pairs:
                    d = (a.float() - r.float()).abs()
                    errs[name] = max(errs.get(name, 0.0), d.max().item())
                    if dtype == torch.float32:
                        check(d.max().item() <= TOL_F32, f"{name} f32 {shape}: {d.max().item()}")
                    else:
                        bad = d > TOL_BF16 + TOL_BF16 * r.float().abs()
                        check(not bad.any().item(), f"{name} bf16 {shape}")
            tol = TOL_SUM[dname]
            sum_err = 0.0
            for what, a, r, b in zip(("gW", "g_log_s", "g_b"), got[2:], ref[2:], again[2:]):
                check(torch.equal(a, b), f"spine_bwd {what} not bitwise repeatable at {shape} {dname}")
                rel = (a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                sum_err = max(sum_err, rel)
                check(rel <= tol, f"spine_bwd {what} {shape} {dname}: {rel} of its scale")
            if dtype == torch.float32:
                for name in max_err:
                    max_err[name] = max(max_err[name], errs[name])
            line("kernels", shape=list(shape), dtype=dname, spine_bwd_max_abs_err=errs["spine_bwd"],
                 spine_bwd_sums_max_rel_err=sum_err, coupling_bwd_max_abs_err=errs["coupling_bwd"],
                 sums_bitwise_repeatable=True)
    return max_err


def max_rel_leaf_err(grads, ref) -> tuple[float, str]:
    """max over leaves of max|g - g_ref| / max|g_ref|, and the worst leaf."""
    worst, where = 0.0, ""
    for name, r in ref.items():
        r = r.float().cpu()
        err = (grads[name].float().cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        if err > worst:
            worst, where = err, name
    return worst, where


def train_phase(dev, card) -> dict:
    """Phase 4: ``GLOW_SCANNED`` training at 256x256x3, batch 8, on the card.
    Returns the launches of one train step, the model and its batch."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.train.loop import train_flow

    def make(device, coupled_bwd="auto"):
        flow = build_flow(GLOW_SCANNED, coupled_bwd=coupled_bwd, channels=3,
                          generator=torch.Generator().manual_seed(SEED), device=device)
        perturb(flow, SEED + 1)
        return flow

    data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED)
    x_cpu = data.batch_at(0)
    x = x_cpu.to(dev)
    flow = make(dev)
    stacks = [layer.layer for layer in flow.layers if hasattr(layer, "layer")
              and hasattr(layer.layer, "coupled_bwd")]
    check(flow.engine == "coupled" and len(stacks) == 3
          and all(s.coupled_bwd == "reversible" for s in stacks),
          "coupled_bwd='auto' did not resolve to 'reversible' on cuda")

    kernels = (*kern.KERNELS, *ckern.KERNELS)
    for k in kernels:
        k.launches = 0
    loss, grads = value_and_grad_nll(flow, x)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(launches == {"flowstep_fwd": 24, "flowstep_inv": 0, "spine_bwd": 24, "coupling_bwd": 24},
          f"train-step launches: {launches}")

    t0 = time.perf_counter()
    flow_cpu = make("cpu")
    check(flow_cpu.engine == "autodiff", "coupled_bwd='auto' did not resolve to 'stored' on the CPU")
    loss_cpu, grads_cpu = value_and_grad_nll(flow_cpu, x_cpu)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    grad_rel, grad_worst = max_rel_leaf_err(grads, grads_cpu)
    check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL, f"train loss vs cpu: {loss_rel}")
    check(all(torch.isfinite(g).all().item() for g in grads.values()), "gradients not finite")
    check(grad_rel <= TOL_GRAD_REL, f"gradient vs cpu: {grad_rel} at {grad_worst}")
    del flow_cpu, grads_cpu

    flow_st = make(dev, "stored")
    loss_st, grads_st = value_and_grad_nll(flow_st, x)
    st_rel, st_worst = max_rel_leaf_err(grads, grads_st)
    st_loss_rel = abs(loss.item() - loss_st.item()) / abs(loss_st.item())
    check(st_loss_rel <= TOL_LOSS_REL and st_rel <= TOL_GRAD_REL,
          f"reversible vs stored on the card: loss {st_loss_rel}, grad {st_rel} at {st_worst}")
    del flow_st, grads_st

    res = train_flow(make(dev), data, TrainConfig(steps=TRAIN_STEPS), device=dev)
    first_rel = abs(res.losses[0] - loss.item()) / abs(loss.item())
    check(len(res.losses) == TRAIN_STEPS and all(math.isfinite(v) for v in res.losses),
          f"train_flow losses: {res.losses}")
    check(first_rel <= 1e-6, f"train_flow step 0 loss {res.losses[0]} vs {loss.item()}")
    line("train", image=[BATCH, HW, HW, 3], loss=loss.item(), loss_rel_err_vs_cpu=loss_rel,
         grad_max_rel_err_vs_cpu=grad_rel, grad_worst_leaf_vs_cpu=grad_worst,
         cpu_reference_s=cpu_s, loss_rel_err_vs_stored=st_loss_rel,
         grad_max_rel_err_vs_stored=st_rel, launches_per_train_step=launches,
         train_flow_losses=res.losses, step0_loss_bitwise_equal=res.losses[0] == loss.item(),
         n_params=sum(p.numel() for p in flow.parameters()), card=card)
    return {"launches": launches, "flow": flow, "x": x}


def memory_phase(dev, card) -> dict:
    """Phase 5: peak device memory of one train step (value and gradient,
    then the AdamW update) at 4 and 8 steps a scale."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import build_glow_scanned, value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.optim import adamw_init, adamw_update

    x = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED).batch_at(0).to(dev)
    peaks = {}
    for mode in ("coupled", "autodiff"):
        for k in (4, 8):
            flow = build_glow_scanned(n_scales=3, k_steps=k, hidden=64, grad_mode=mode,
                                      coupled_bwd="reversible", channels=3,
                                      generator=torch.Generator().manual_seed(SEED), device=dev)
            perturb(flow, SEED + 1)
            params = dict(flow.named_parameters())
            opt = adamw_init(params)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            loss, grads = value_and_grad_nll(flow, x)
            adamw_update(params, grads, opt, TrainConfig(), 1e-4)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            peaks[f"{mode}_k{k}"] = {"peak_bytes": peak, "above_start_bytes": peak - start}
            del flow, params, opt, loss, grads
    growth = {m: peaks[f"{m}_k8"]["peak_bytes"] - peaks[f"{m}_k4"]["peak_bytes"]
              for m in ("coupled", "autodiff")}
    line("memory", image=[BATCH, HW, HW, 3], peaks=peaks, growth_k4_to_k8_bytes=growth, card=card)
    check(growth["coupled"] < 0.25 * growth["autodiff"],
          f"coupled peak grew {growth['coupled']} B from k=4 to 8, autodiff {growth['autodiff']} B")
    return peaks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import derive_key, std_normal_sample, value_and_grad_nll
    from repro_torch.kernels import common
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.coupling.ref import coupling_bwd_ref
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref, spine_bwd_ref
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.serve.engine import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = smi()
    line("setup", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         card=card, allow_tf32={"matmul": False, "cudnn": False})

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = common.build()
    build_s = time.perf_counter() - t0
    logs = [path.with_suffix(".log") for path in built.values()]
    ptxas = [ln.strip() for log in logs if log.exists()
             for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
    line("build", seconds=round(build_s, 3), libraries=[str(p) for p in built.values()],
         ptxas=ptxas, card=card)

    # 2. kernels against their plain versions --------------------------------
    max_err = {"flowstep_fwd": 0.0, "flowstep_inv": 0.0}
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED)
            y, ld = kern.flowstep_fwd(x, ls, ab, w, raw, t)
            y_r, ld_r = flowstep_fwd_ref(x, ls, ab, w, raw, t)
            _, ld_again = kern.flowstep_fwd(x, ls, ab, w, raw, t)
            w_inv = torch.linalg.inv(w)
            xb = kern.flowstep_inv(y_r, ls, ab, w_inv, raw, t)
            xb_r = flowstep_inv_ref(y_r, ls, ab, w_inv, raw, t)
            torch.cuda.synchronize()
            err_y = (y.float() - y_r.float()).abs().max().item()
            err_x = (xb.float() - xb_r.float()).abs().max().item()
            err_ld = ((ld - ld_r).abs() / ld_r.abs().clamp_min(1.0)).max().item()
            if dtype == torch.float32:
                check(err_y <= TOL_F32 and err_x <= TOL_F32, f"f32 {shape}: y {err_y}, x {err_x}")
                max_err["flowstep_fwd"] = max(max_err["flowstep_fwd"], err_y)
                max_err["flowstep_inv"] = max(max_err["flowstep_inv"], err_x)
            else:
                for a, r, what in ((y, y_r, "y"), (xb, xb_r, "x")):
                    bad = (a.float() - r.float()).abs() > TOL_BF16 + TOL_BF16 * r.float().abs()
                    check(not bad.any().item(), f"bf16 {shape}: {what}")
            check(err_ld <= TOL_LD_REL, f"ld {shape} {dtype}: {err_ld}")
            check(torch.equal(ld, ld_again), f"ld not bitwise repeatable at {shape} {dtype}")
            line("kernels", shape=list(shape), dtype=str(dtype).removeprefix("torch."),
                 fwd_max_abs_err=err_y, inv_max_abs_err=err_x, ld_max_rel_err=err_ld,
                 ld_bitwise_repeatable=True)
    max_err.update(check_bwd_kernels(dev))

    # 3. serve the model on the card ------------------------------------------
    flow_cpu = build_flow(GLOW_SCANNED, channels=3, generator=torch.Generator().manual_seed(SEED),
                          device="cpu")
    perturb(flow_cpu, SEED + 1)
    engine = FlowServeEngine(copy.deepcopy(flow_cpu), device="cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    x_cpu = torch.rand((BATCH, HW, HW, 3), generator=g) - 0.5  # images scaled to [-0.5, 0.5)
    x = x_cpu.to(dev)

    for k in kern.KERNELS:
        k.launches = 0
    lp = engine.log_prob(x)
    torch.cuda.synchronize()
    launches = {"flowstep_fwd": kern.flowstep_fwd.launches}
    check(kern.flowstep_fwd.launches == 24 and kern.flowstep_inv.launches == 0,
          f"log_prob launches: {kern.KERNELS}")

    lp_cpu = FlowServeEngine(flow_cpu, device="cpu").log_prob(x_cpu)
    rel = ((lp.cpu() - lp_cpu).abs() / lp_cpu.abs()).max().item()
    check(torch.isfinite(lp).all().item() and rel <= TOL_LOG_PROB, f"log_prob vs cpu: {rel}")

    with torch.inference_mode():
        z_data, _ = engine.flow(x)
    like = tuple(torch.empty_like(v, device="meta") for v in z_data)
    for k in kern.KERNELS:
        k.launches = 0
    samples = engine.sample(torch.Generator().manual_seed(SEED + 3), like)
    torch.cuda.synchronize()
    launches["flowstep_inv"] = kern.flowstep_inv.launches
    check(kern.flowstep_inv.launches == 24 and kern.flowstep_fwd.launches == 0,
          f"sample launches: {kern.KERNELS}")

    lp_s = engine.log_prob(samples)
    z = std_normal_sample(derive_key(torch.Generator().manual_seed(SEED + 3), 0, dev), like)
    with torch.inference_mode():
        z_back, _ = engine.flow(samples)
    rt = max((a - b).abs().max().item() for a, b in zip(z_back, z))
    check(torch.isfinite(samples).all().item() and torch.isfinite(lp_s).all().item(),
          "samples or their log_prob not finite")
    check(rt <= TOL_ROUND_TRIP, f"forward(inverse(z)) vs z: {rt}")
    line("serve", image=[BATCH, HW, HW, 3], log_prob_mean=lp.mean().item(),
         log_prob_rel_err_vs_cpu=rel, sample_shape=list(samples.shape),
         sample_log_prob_mean=lp_s.mean().item(), round_trip_max_abs_err=rt,
         launches={"log_prob": {"flowstep_fwd": launches["flowstep_fwd"]},
                   "sample": {"flowstep_inv": launches["flowstep_inv"]}})

    # 4. train and 5. memory ---------------------------------------------------
    train = train_phase(dev, card)
    launches.update({k: train["launches"][k] for k in ("spine_bwd", "coupling_bwd")})
    memory_phase(dev, card)

    # 6. times -----------------------------------------------------------------
    per_shape = {"flowstep_fwd": [], "flowstep_inv": [], "spine_bwd": [], "coupling_bwd": []}
    for shape in SHAPES[:3]:
        for dtype in (torch.float32, torch.bfloat16):
            x_, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED)
            y_ = flowstep_fwd_ref(x_, ls, ab, w, raw, t)[0]
            w_inv = torch.linalg.inv(w)
            g_ = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 7)).to(dev, dtype)
            gld = torch.randn(shape[0], generator=torch.Generator().manual_seed(SEED + 8)).to(dev)
            ca = shape[-1] // 2
            runs = {
                "flowstep_fwd": (lambda: kern.flowstep_fwd(x_, ls, ab, w, raw, t),
                                 lambda: flowstep_fwd_ref(x_, ls, ab, w, raw, t)),
                "flowstep_inv": (lambda: kern.flowstep_inv(y_, ls, ab, w_inv, raw, t),
                                 lambda: flowstep_inv_ref(y_, ls, ab, w_inv, raw, t)),
                "spine_bwd": (lambda: kern.spine_bwd(x_, g_, w, w_inv, ls, ab),
                              lambda: spine_bwd_ref(x_, g_, w, w_inv, ls, ab)),
                "coupling_bwd": (lambda: ckern.coupling_bwd(y_[..., :ca], raw, t, g_[..., :ca], gld),
                                 lambda: coupling_bwd_ref(y_[..., :ca], raw, t, g_[..., :ca], gld)),
            }
            for name, (k_fn, p_fn) in runs.items():
                ms = device_ms(k_fn)
                nbytes, flops = cost(name, shape, dtype)
                row = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
                       "ms": ms, "plain_ms": device_ms(p_fn),
                       "bound_ms": bound_ms(name, shape, dtype),
                       "call_ms": call_ms(k_fn), "plain_call_ms": call_ms(p_fn),
                       "bytes": nbytes, "flops": flops,
                       "achieved_GBps": nbytes / (ms * 1e-3) / 1e9}
                per_shape[name].append(row)
                line("times", kernel=name, **row)

    def wall_ms(fn, reps=15):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return sorted(out)[len(out) // 2], out

    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 4)
    t_params = dict(train["flow"].named_parameters())
    t_opt = adamw_init(t_params)

    def train_step():
        loss, grads = value_and_grad_nll(train["flow"], train["x"])
        adamw_update(t_params, grads, t_opt, TrainConfig(), 1e-5)
        return loss

    for what, fn in (("log_prob", lambda: engine.log_prob(x)),
                     ("sample", lambda: engine.sample(gen, like)),
                     ("train_step", train_step)):
        median, runs_ms = wall_ms(fn)
        q = sorted(runs_ms)
        line("times", e2e=what, batch=BATCH, median_ms=median, q1_ms=q[len(q) // 4],
             q3_ms=q[(3 * len(q)) // 4], runs_ms=runs_ms,
             images_per_s=BATCH / (median * 1e-3), card=card)
        # one profiled call: device time by the PyTorch op (or kernel wrapper)
        # that launched it; the idle share is against the unprofiled median
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        (OUT / f"profile_{what}.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=60, max_name_column_width=100))
        busy_ms = sum(e.device_time_total for e in events if _is_device_event(e)) / 1e3
        by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                        if not _is_device_event(e) and e.self_device_time_total > 0),
                       key=lambda r: -r[1])
        line("profile", call=what, device_busy_ms=busy_ms, unprofiled_median_ms=median,
             device_idle_share=max(0.0, 1 - busy_ms / median),
             device_ms_by_op=[[k, round(v, 4), n] for k, v, n in by_op[:12]])

    kernels = []
    sources = {
        "flowstep_fwd": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:121"),
        "flowstep_inv": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:150"),
        "spine_bwd": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:171"),
        "coupling_bwd": ("coupling.cu", "src/repro/kernels/coupling/coupling.py:120"),
    }
    for name, (source, replaces) in sources.items():
        main = per_shape[name][0]  # (8, 16384, 12) float32: the model's largest shape
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": max_err[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": bound_by(name, tuple(main["shape"]), torch.float32), "library_ms": None,
            "shape": main["shape"], "dtype": main["dtype"],
        })
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s ``[lm-train]`` (b) peak memory comes from, on one
NVIDIA GPU: granite-moe-1b-a400m at ``LM_TRAIN_DEPTH`` layers, 8 x 2048, bf16
activations.

    python3 tools/peak_split.py

(1) ``train_lm`` for 3 steps: the bytes allocated at each step's start (what
the loop holds beside the step's arguments) and the peak of each step.
(2) one step of ``launch/dryrun.py::make_train_step`` on the card under
``utils/cost.py``'s counter, the allocator read around every operation: the
largest allocations inside an operation that no dispatched operation shows
(its peak above both the bytes before it and after it), and the largest
gaps between the allocator's bytes and the counter's live bytes plus the
step's base.  (3) the same step reckoned on the meta device, its live bytes
at the peak by the operation that made them.  Prints one JSON line each,
then the card's name and power limit.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (the cell's constants, as the smoke run's)


def _top(counter, n=12):
    return sorted(counter.items(), key=lambda kv: -kv[1])[:n]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("peak_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import ShapeSpec, TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.dryrun import make_train_step, meta_model
    from repro_torch.models import Model
    from repro_torch.models.registry import input_specs
    from repro_torch.train.loop import train_lm
    from repro_torch.utils import cost

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(cs.LM_TRAIN_ARCH).config.replace(n_layers=cs.LM_TRAIN_DEPTH)
    data = SyntheticTokens(cfg.vocab_size, cs.LM_TRAIN_SEQ, cs.LM_TRAIN_BATCH, seed=11)
    tcfg = TrainConfig(steps=3, lr=3e-4, warmup_steps=2)

    class Probe:  # a FailureInjector stand-in that reads the allocator
        def __init__(self):
            self.at = []

        def maybe_fail(self, step):
            torch.cuda.synchronize()
            self.at.append((step, torch.cuda.memory_allocated(),
                            torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

    model = Model(cfg, generator=torch.Generator(dev).manual_seed(cs.SEED + 72), device=dev)
    torch.cuda.reset_peak_memory_stats()
    probe = Probe()
    train_lm(model, data, tcfg, grad_mode="invertible", device=dev, injector=probe)
    torch.cuda.synchronize()
    print(json.dumps({"train_lm_step_starts": probe.at, "after": torch.cuda.memory_allocated(),
                      "max_since_last": torch.cuda.max_memory_allocated()}), flush=True)
    del model
    torch.cuda.empty_cache()

    class Reads(cost.CostCounter):
        """The counter, with the allocator read around each operation."""

        def __init__(self, base):
            super().__init__()
            self.base, self.inside, self.gaps = base, [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
            node = torch._C._current_autograd_node()
            where = (str(func), type(node).__name__ if node is not None else None)
            self.inside = sorted(self.inside + [(peak - max(before, after), peak, where)],
                                 key=lambda r: -r[0])[:12]
            self.gaps = sorted(self.gaps + [(after - self.base - self._live, after, where)],
                               key=lambda r: -r[0])[:12]
            return out

    model = Model(cfg, generator=torch.Generator(dev).manual_seed(cs.SEED + 72), device=dev)
    step = make_train_step(model, tcfg)
    state = step.init_state()
    batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(0).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    with Reads(base) as c:
        step(state, batch)
    torch.cuda.synchronize()
    print(json.dumps({"step_seconds": time.perf_counter() - t0, "base": base,
                      "counter_temp": c.cost.temp_bytes, "inside_an_op": c.inside,
                      "allocated_over_counter": c.gaps}), flush=True)
    del model, step, state
    torch.cuda.empty_cache()

    mstep = make_train_step(meta_model(cfg), tcfg)
    mstate = mstep.init_state()  # the step's arguments, made before it
    specs = input_specs(cfg, ShapeSpec("b", cs.LM_TRAIN_SEQ, cs.LM_TRAIN_BATCH, "train"))
    with cost.CostCounter(peak_by_op=True) as m:
        mstep(mstate, specs)
    print(json.dumps({"meta_temp": m.cost.temp_bytes, "meta_peak_by_op": _top(m.peak_by_op)}),
          flush=True)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

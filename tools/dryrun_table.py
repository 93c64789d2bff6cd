#!/usr/bin/env python3
"""Print the dry run's reckonings (``repro_torch.launch.dryrun``'s
artifacts) of one mesh as a markdown table, a row per architecture, each
figure a rank's: train_4k's argument and peak GB, TFLOP and wire GB by
kind (all-gather / all-reduce / reduce-scatter), the default "→" the
variant where they differ; prefill_32k's and decode_32k's argument and
peak GB, TFLOP and all-gather GB (the serving cells take no variant's
option, and move no all-reduce or reduce-scatter bytes but where shown);
long_500k's argument and peak GB where the shape applies.

    python3 tools/dryrun_table.py [--dir artifacts/dryrun_torch] [--mesh single]
        [--variant zero1-fsdp]

The figures are reckonings on the meta device, not measurements."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def _cells(root: Path, mesh: str, variant: str) -> dict:
    suffix = f"__{variant}" if variant else ""
    out = {}
    for path in sorted(root.glob(f"*__{mesh}{suffix}.json")):
        art = json.loads(path.read_text())
        if art.get("ok") and not art.get("skipped"):
            out[(art["arch"], art["shape"])] = art
    return out


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f}"


def _pair(a: float, b: float) -> str:
    return _gb(a) if _gb(a) == _gb(b) else f"{_gb(a)} → {_gb(b)}"


def _serve(art) -> str:
    if art is None:
        return "skipped"
    m, c = art["memory"], art["collectives"]
    extra = "".join(f", {k} {_gb(c[k])}" for k in KINDS[1:] if c[k])
    return (f"{_gb(m['argument_bytes'])} / {_gb(m['peak_bytes'])}, "
            f"{art['cost']['flops'] / 1e12:.1f}, {_gb(c['all-gather'])}{extra}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="zero1-fsdp")
    args = ap.parse_args()
    base = _cells(Path(args.dir), args.mesh, "")
    var = _cells(Path(args.dir), args.mesh, args.variant)
    print("| arch | train_4k args GB | peak GB | TFLOP | wire GB (AG / AR / RS) "
          "| prefill_32k args / peak GB, TFLOP, AG GB | decode_32k (the same) "
          "| long_500k args / peak GB |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in sorted({a for a, _ in base}):
        t, tv = base[(arch, "train_4k")], var.get((arch, "train_4k"), base[(arch, "train_4k")])
        long = base.get((arch, "long_500k"))
        wire = " / ".join(_pair(t["collectives"][k], tv["collectives"][k]) for k in KINDS)
        print(f"| {arch} | {_pair(t['memory']['argument_bytes'], tv['memory']['argument_bytes'])}"
              f" | {_pair(t['memory']['peak_bytes'], tv['memory']['peak_bytes'])}"
              f" | {t['cost']['flops'] / 1e12:.1f} | {wire}"
              f" | {_serve(base.get((arch, 'prefill_32k')))}"
              f" | {_serve(base.get((arch, 'decode_32k')))}"
              f" | {'—' if long is None else _gb(long['memory']['argument_bytes']) + ' / ' + _gb(long['memory']['peak_bytes'])} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

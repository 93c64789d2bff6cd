#!/usr/bin/env python3
"""Compare the machine code (SASS) of the CUDA kernels of two checkouts.

    python3 tools/sass_diff.py --parent DIR [--sources flowstep coupling ...]

Builds each named source of ``src/repro_torch/csrc`` (``kernels/common.py``'s
``SOURCES``) from this checkout and from the checkout at ``DIR`` with the
port's own ``nvcc`` flags (``common.NVCC_FLAGS``), all builds started
together, dumps each library with ``cuobjdump -sass`` and compares the
kernels function by function: the same SASS (every instruction and its
encoding), changed (with both instruction counts), or present in one
checkout only.  Prints one JSON line per kernel and a summary line per
source; the dumps go to ``chiprun_out/sass/``.  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``); exits 2 without it.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "sass"


def tool(name: str) -> str | None:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return found if Path(found).exists() else None


#: the anonymous namespace's name in a demangled kernel name, which carries
#: a hash of the source's path: the two checkouts' differ
_ANON = re.compile(r"_INTERNAL_\w+?::")


def functions(sass: str, cufilt: str | None) -> dict[str, list[str]]:
    """``{kernel name: its instruction lines}`` of a ``cuobjdump -sass``
    dump (the lines that carry an address comment, with their encodings);
    names demangled by ``cu++filt`` where the toolkit has it, without the
    anonymous namespace's name."""
    out: dict[str, list[str]] = {}
    name = None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and ("/*" in ln):
            out[name].append(ln.strip())
    if cufilt is None:
        return out
    names = list(out)
    plain = subprocess.run([cufilt], input="\n".join(names), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {_ANON.sub("", p): out[n] for n, p in zip(names, plain)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--sources", nargs="+", default=["flowstep", "coupling"])
    args = ap.parse_args()
    nvcc, cuobjdump, cufilt = tool("nvcc"), tool("cuobjdump"), tool("cu++filt")
    if nvcc is None or cuobjdump is None:
        print("sass_diff: needs nvcc and cuobjdump", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.common import NVCC_FLAGS, SOURCES

    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"change": ROOT, "parent": Path(args.parent).resolve()}
    procs = {}
    for label, tree in trees.items():
        for name in args.sources:
            lib = OUT / f"{label}_{name}.so"
            src = tree / "src" / "repro_torch" / "csrc" / SOURCES[name]
            procs[label, name] = (lib, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    dumps = {}
    for (label, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"sass_diff: nvcc failed for {label} {name}:\n{log}", file=sys.stderr)
            return 1
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        (OUT / f"{label}_{name}.sass").write_text(sass)
        dumps[label, name] = functions(sass, cufilt)
    for name in args.sources:
        new, old = dumps["change", name], dumps["parent", name]
        counts = {"same": 0, "changed": 0, "change_only": 0, "parent_only": 0}
        for fn in sorted(set(new) | set(old)):
            if fn not in old:
                state = "change_only"
            elif fn not in new:
                state = "parent_only"
            else:
                state = "same" if new[fn] == old[fn] else "changed"
            counts[state] += 1
            print(json.dumps({"source": name, "kernel": fn, "sass": state,
                              "instructions": {"parent": len(old.get(fn, [])),
                                               "change": len(new.get(fn, []))}}), flush=True)
        print(json.dumps({"source": name, "summary": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

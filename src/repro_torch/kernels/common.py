"""Shared kernel utilities: the (B, M, C) view, dispatch by tensor device, and
the build of the hand-written CUDA kernels.

Dispatch has one rule and no switch: a wrapper given CPU tensors runs its
kernel's plain PyTorch version; given CUDA tensors it launches the kernel, or
raises.  Nothing falls back from the card to the plain version.  A kernel
with no backward kernel is called through :func:`forward_only`, so a gradient
through it raises instead of silently vanishing.

Build: each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
The library's name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a stale
library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel library name -> its source under ``csrc/``
SOURCES = {"flowstep": "flowstep.cu", "coupling": "coupling.cu", "conv1x1": "conv1x1.cu",
           "attention": "attention.cu", "rwkv": "rwkv.cu", "ssd": "ssd.cu"}
#: storage types the kernels take, as the code each C entry point reads
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the persistent stream kernels' widths (a template parameter each) and
#: ``conv1x1_mm``'s lane layout at each (``launch_stream_c`` in
#: ``conv1x1.cu``): (output columns, rows) a lane computes, warps a block;
#: the flow-step streams start from it (``FLOW_PLAN`` in
#: ``kernels/flowstep/flowstep.py``)
STREAM_PLAN = {12: (12, 1, 8), 24: (12, 2, 4), 48: (6, 2, 8)}
STREAM_WIDTHS = tuple(STREAM_PLAN)

_libs: dict[str, ctypes.CDLL] = {}


def stream_rows(c: int, plan=STREAM_PLAN) -> int:
    """Rows of a stream tile under ``plan`` (``STREAM_PLAN``'s layout): each
    lane takes ``out`` columns of ``rpl`` rows, so ``c // out`` lanes share a
    group of ``rpl`` rows."""
    out, rpl, _ = plan[c]
    return rpl * 32 // (c // out)


def stream_tiles(n_tiles: int, c: int, grid: int, plan=STREAM_PLAN) -> list[list[int]]:
    """The tiles each warp of a ``grid``-block stream launch takes, in its
    order: warp g (block g // warps) takes tiles g, g + grid * warps, ...
    (the stream kernels' loop)."""
    step = grid * plan[c][2]
    return [list(range(g, n_tiles, step)) for g in range(step)]


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one term after another from 0, as a loop in a
    kernel adds them."""
    s = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        s = s + v[..., k]
    return s


def _shfl_down_tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum of 32 lanes (last axis) after ``v += shfl_down(v, o)``
    for o = 16, 8, 4, 2, 1."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def stream_ld(log_s: torch.Tensor, rows: int, rpl: int, cols: int, g: int) -> torch.Tensor:
    """The row streams' ld (``RowWalk`` in ``csrc/row_stream.cuh``) in their
    order, from the f32 log_s (B, M, ca) of the coupled columns: a tile is
    ``rows`` rows of one batch; lane l takes rows (l // g) rpl + u and
    coupled columns (l % g) cols + j (lanes whose columns lie past ca take
    none) and adds its terms over u and then j; the tile's 32 lanes by the
    kernels' shuffle tree; then per batch the tiles' sums as
    ``ld_reduce_kernel`` adds them (lane l takes tiles l, l + 32, ..., then
    the tree).  Returns (B,) f32."""
    b, m, ca = log_s.shape
    per = -(-m // rows)
    # rows past a batch's end add nothing (0 here)
    log_s = torch.nn.functional.pad(log_s, (0, 0, 0, per * rows - m))
    # (b, tile, row group, u, column group, j) -> each lane's terms in order
    lanes = log_s.reshape(b, per, rows // rpl, rpl, ca // cols, cols).permute(0, 1, 2, 4, 3, 5)
    sums = _seq_sum(lanes.reshape(b, per, rows // rpl, ca // cols, rpl * cols))
    by_lane = torch.zeros(b, per, rows // rpl, g, device=log_s.device)
    by_lane[..., : ca // cols] = sums
    partial = _shfl_down_tree(by_lane.reshape(b, per, 32))
    partial = torch.nn.functional.pad(partial, (0, -per % 32))
    return _shfl_down_tree(_seq_sum(partial.reshape(b, -1, 32).transpose(1, 2)))


def spatial_size(shape) -> int:
    """Flattened spatial extent M of a (B, ..., C) shape."""
    m = 1
    for d in shape[1:-1]:
        m *= d
    return max(m, 1)


def flatten_bmc(v: torch.Tensor) -> torch.Tensor:
    """Collapse a (B, ..., C) tensor to the kernels' (B, M, C) view."""
    return v.reshape(v.shape[0], spatial_size(v.shape), v.shape[-1])


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 as the kernels' ``cvt.rna.tf32.f32``: the low 13 mantissa
    bits rounded off to nearest, ties away from zero (plain PyTorch, for the
    plain versions that mirror a tensor-core kernel's rounding)."""
    return ((v.float().contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor, split_b: bool = True) -> torch.Tensor:
    """``a @ b`` as the kernels' 3xTF32 tensor-core products: each operand
    split into a TF32 hi and lo, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, each
    product exact (float64 here); without ``split_b`` (b is exact in TF32,
    as bf16 values are) ``a_lo b + a_hi b``.  Returns f32."""
    ah, bh = tf32_round(a), tf32_round(b) if split_b else b.float()
    al = tf32_round(a.float() - ah)
    d = lambda u, v: torch.matmul(u.double(), v.double())  # noqa: E731
    out = d(al, bh)
    if split_b:
        out = out + d(ah, tf32_round(b.float() - bh))
    return (out + d(ah, bh)).float()


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the meta device: a wrapper then takes
    its kernel's meta route (the outputs' shapes and dtypes, one launch
    recorded in ``utils/cost.py``, nothing computed)."""
    return all(t.device.type == "meta" for t in tensors)


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when every tensor lies on one CUDA device (launch the kernel); raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


class _ForwardOnly(torch.autograd.Function):
    """A kernel call whose outputs carry no gradient: backward raises."""

    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward on the card: its CUDA kernel computes the forward only. "
            "No training path launches it (the SSM mixers train through their plain scans, "
            "nn/ssm.py::scan_on_kernel; no model selects flash_attention); differentiate "
            "through the plain version instead")


def forward_only(fn, name: str):
    """``fn`` (a kernel's launch) behind an ``autograd.Function`` whose
    backward raises ``NotImplementedError`` naming ``name``.  Every argument,
    keyword ones included, is an input of the Function, so any tensor that
    requires grad makes the outputs require grad, and a backward through them
    raises.  The forward, its results and its launches are ``fn``'s."""

    def call(*args, **kwargs):
        keys, n = tuple(kwargs), len(args)

        def run(*flat):
            return fn(*flat[:n], **dict(zip(keys, flat[n:])))

        return _ForwardOnly.apply(name, run, *args, *kwargs.values())

    return call


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    and the flags."""
    text = b"".join(p.read_bytes() for p in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named kernel libraries (all by default) that are not built
    yet, one ``nvcc`` process per source, all started together.  Returns each
    library's path; ``nvcc``'s report (registers, shared memory, spills) is
    kept beside it as ``<library>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return _libs[name]


def bind(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """Entry point ``name`` of kernel library ``lib`` with its C signature."""
    f = getattr(library(lib), name)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def stream(v: torch.Tensor) -> int:
    """PyTorch's current stream on ``v``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(v.device).cuda_stream


def raise_on(err: int, name: str):
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class Kernel:
    """A CUDA entry point with its count of launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"<kernel {self.name}: {self.launches} launches>"


class PathKernel(Kernel):
    """A CUDA entry point with several kernels, chosen by a shape rule; each
    launch is counted in ``launches`` and by its path in ``launches_by_path``."""

    def __init__(self, name: str, paths: tuple[str, ...]):
        super().__init__(name)
        self.launches_by_path = dict.fromkeys(paths, 0)

    def count(self, err: int, path: str):
        """Raise if the launch on ``path`` failed (:func:`raise_on`), else
        count it."""
        raise_on(err, self.name)
        self.launches += 1
        self.launches_by_path[path] += 1

"""Binding of the hand-written CUDA Mamba2 SSD scan (``csrc/ssd.cu``).

``ssd_scan`` replaces the Pallas kernel of the same name in
``repro/kernels/ssd/ssd.py``, keeping its contract (the chunk is
``min(chunk, S)`` and must divide S; y in x's dtype, the state in f32) with
one more input: an optional initial state (absent means zeros, the TPU
kernel's case), which the model's chunk scan needs.  Its products run on
the TF32 tensor cores in 3xTF32; the source note in ``ssd.cu`` gives the
design, SSD's chunked decomposition as five kernels that are parallel over
chunks (``KERNELS_PER_CALL``).  The wrapper checks what the kernel takes,
allocates y with x's strides (so a (B, H, S, P) view of a (B, S, H, P)
tensor comes back in the same layout), the final state and the passes'
scratch (:func:`ssd_scratch`: the chunk states, C B^T per (batch, chunk),
f32 copies of B and C), launches on PyTorch's current stream, raises if a
launch was refused, and adds one to its ``launches`` count per call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: the largest head dim P and state size N (one 64-wide tile each)
MAX_WIDTH = 64
#: the longest chunk (its 64-row tiles form at most 2,080 causal tile pairs)
MAX_CHUNK = 4096
#: rows and columns of the kernels' tiles (``kL`` in ``ssd.cu``)
TILE = 64
#: CUDA kernels one ``ssd_scan`` call runs: prep, C B^T, chunk states, carry,
#: output
KERNELS_PER_CALL = 5
#: the largest grid dimension y or z (the prep and C B^T grids' chunk and
#: batch axes)
MAX_GRID_YZ = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              ctypes.POINTER(ctypes.c_longlong), _I, _I, _P]


def check_chunk(s: int, chunk: int) -> int:
    """The chunk the scan takes, ``min(chunk, s)``; raises unless it divides
    ``s``, where the reference's kernel asserts."""
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"sequence {s} is not divisible by chunk {c}")
    return c


def tiles_of(chunk: int) -> int:
    """64-row tiles of a chunk: its rows padded to a multiple of ``TILE``."""
    return -(-chunk // TILE)


def ssd_scratch(b: int, h: int, s: int, chunk: int) -> dict[str, tuple[int, int]]:
    """(offset, length) in floats of each scratch array of one call, in the
    order ``launch`` in ``ssd.cu`` lays them out, each a multiple of 64
    floats (so every array starts 256-byte aligned): cum (as an f32 high and
    low part) and dt per (batch, head) time-contiguous; B, B^T and C^T per (batch, chunk), zero-padded to
    (cp, 64) / (64, cp); C B^T's causal 64 x 64 tile pairs per (batch,
    chunk); one 64 x 64 state per (batch, head, chunk); one flag per (batch,
    head, chunk) that no da of the chunk is positive."""
    k, tiles = s // chunk, tiles_of(chunk)
    cp = tiles * TILE
    pairs = tiles * (tiles + 1) // 2
    up = lambda n: -(-n // 64) * 64  # noqa: E731
    sizes = {"cum": up(b * h * s), "cuml": up(b * h * s), "dts": up(b * h * s),
             "bp": b * k * cp * TILE,
             "bt": b * k * cp * TILE, "ct": b * k * cp * TILE,
             "g0t": b * k * pairs * TILE * TILE, "states": b * h * k * TILE * TILE,
             "falls": up(b * h * k)}
    out, off = {}, 0
    for name, n in sizes.items():
        out[name] = (off, n)
        off += n
    return out


def ssd_smem_bytes(elem_size: int) -> dict[str, int]:
    """Dynamic shared memory of the two product kernels (``state_smem_bytes``
    and ``out_smem_bytes`` in ``ssd.cu``): two stages of an A and a B tile and
    three row vectors, the output pass two more row vectors, and for bf16 x
    two staging tiles."""
    stage = 2 * TILE * (TILE + 8) + 3 * TILE  # shared tiles' rows are 72 floats apart
    staging = 2 * TILE * TILE * 2 if elem_size == 2 else 0
    return {"state": 4 * 2 * stage + staging, "out": 4 * (2 * stage + 2 * TILE) + staging}


def out_blocks(h: int, k: int, b: int, chunk: int) -> list[tuple[int, int, int, int]]:
    """The output pass's blocks in launch order, as (batch, head, chunk,
    row tile) (``ssd_out_kernel``'s decoding of ``blockIdx.x``): row tiles
    fastest, heaviest first, then heads, chunks, batches."""
    tiles = tiles_of(chunk)
    blocks = []
    for i in range(b * k * h * tiles):
        r = tiles - 1 - i % tiles
        j = i // tiles
        blocks.append((j // (h * k), j % h, (j // h) % k, r))
    return blocks


def out_rows(chunk: int, k: int, r: int) -> tuple[range, list[range]]:
    """Block (k, r) of the output pass: the time steps it writes, and the
    source rows of each stage after the carried state (tiles 0..r of its
    chunk, each the rows it sums over)."""
    t0 = k * chunk
    rows = range(t0 + r * TILE, t0 + min(r * TILE + TILE, chunk))
    return rows, [range(t0 + q * TILE, t0 + min(q * TILE + TILE, chunk)) for q in range(r + 1)]


def x_vec16(x) -> bool:
    """Whether the kernels copy x in 16-byte pieces: its base, its (batch,
    head, time) strides and its P values are whole pieces; otherwise one
    element at a time."""
    per = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and x.shape[-1] % per == 0
            and all(st % per == 0 for st in x.stride()[:3]))


class _SsdScan(Kernel):
    def __call__(self, x, da, dt, b_in, c_in, chunk: int = 128, state0=None):
        """x: (B, H, S, P); da, dt: (B, H, S) f32; b_in, c_in: (B, S, N) in
        x's dtype (f32 or bf16), last axes contiguous; state0: (B, H, P, N) or
        None (zeros) -> (y (B, H, S, P) in x's dtype, state (B, H, P, N) f32)."""
        if x.dtype not in KERNEL_DTYPES or b_in.dtype != x.dtype or c_in.dtype != x.dtype:
            raise TypeError(f"{self.name} takes float32 or bfloat16 x, b_in, c_in of one dtype, "
                            f"got {x.dtype}, {b_in.dtype}, {c_in.dtype}")
        if da.dtype != torch.float32 or dt.dtype != torch.float32:
            raise TypeError(f"{self.name} takes float32 da and dt, got {da.dtype}, {dt.dtype}")
        if x.ndim != 4 or 0 in x.shape:
            raise ValueError(f"{self.name}: x must be a non-empty (B, H, S, P), got "
                             f"{tuple(x.shape)}")
        b, h, s, p = x.shape
        n = b_in.shape[-1]
        if (da.shape != (b, h, s) or dt.shape != (b, h, s) or b_in.shape != (b, s, n)
                or c_in.shape != (b, s, n)):
            shapes = [tuple(t.shape) for t in (da, dt, b_in, c_in)]
            raise ValueError(f"{self.name}: da, dt (B, H, S) and b_in, c_in (B, S, N) do not "
                             f"fit x {tuple(x.shape)}: {shapes}")
        if not (1 <= p <= MAX_WIDTH and 1 <= n <= MAX_WIDTH):
            raise ValueError(f"{self.name}: head dim {p} and state size {n} must be 1..{MAX_WIDTH}")
        c = check_chunk(s, chunk)
        if c > MAX_CHUNK:
            raise ValueError(f"{self.name}: chunk {c} is longer than {MAX_CHUNK}")
        if b > MAX_GRID_YZ or s // c > MAX_GRID_YZ:
            raise ValueError(f"{self.name}: batch {b} and chunks {s // c} must be at most "
                             f"{MAX_GRID_YZ}")
        if state0 is not None and tuple(state0.shape) != (b, h, p, n):
            raise ValueError(f"{self.name}: state0 must be {(b, h, p, n)}, got "
                             f"{tuple(state0.shape)}")
        if any(t.stride(-1) != 1 for t in (x, b_in, c_in)):
            raise ValueError(f"{self.name}: the last axis of x, b_in and c_in must be contiguous")
        tensors = (x, da, dt, b_in, c_in) + (() if state0 is None else (state0,))
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{self.name}: every input must be on one device")
        if state0 is not None:
            state0 = state0.float().contiguous()
        y = torch.empty_like(x)
        if y.stride(-1) != 1:
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        scratch = torch.empty(sum(size for _, size in ssd_scratch(b, h, s, c).values()),
                              dtype=torch.float32, device=x.device)
        strides = (ctypes.c_longlong * 16)(
            *x.stride()[:3], *da.stride(), *dt.stride(), *b_in.stride()[:2], *c_in.stride()[:2],
            *y.stride()[:3])
        err = bind("ssd", "ssd_scan", _SIGNATURE)(
            KERNEL_DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), dt.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), scratch.data_ptr(), b, h, s, p, n, c, strides, int(x_vec16(x)),
            x.device.index, stream(x),
        )
        raise_on(err, self.name)
        self.launches += 1
        return y, state


ssd_scan = _SsdScan("ssd_scan")
KERNELS = (ssd_scan,)

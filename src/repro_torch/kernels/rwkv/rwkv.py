"""Binding of the hand-written CUDA wkv6 recurrence (``csrc/rwkv.cu``).

``wkv_scan`` replaces the Pallas kernel of the same name in
``repro/kernels/rwkv/rwkv.py``, with one more input: an optional initial
state (absent means zeros, the TPU kernel's case), which the model's scans
and decode need.  It is bound by bytes, with the FP32 units close behind
(``chip_smoke.py::cost``: 5 K^2 + 5 K operations per token and head); the
source note in ``rwkv.cu`` gives the design: each thread keeps a
``K/8 x 4`` tile of the state in registers, time is staged through a ring
of 16-step stages filled by 16-byte ``cp.async`` copies.  The functions
below mirror its launch (:func:`wkv_tiles`, :func:`wkv_dot_lanes`,
:func:`wkv_smem_bytes`), so the CPU tests can check it.  The wrapper checks
what the kernel takes, copies an input whose rows are not 16-byte aligned,
allocates y with r's strides (so a (B, S, H, K) tensor viewed as
(B, H, S, K) comes back in the same layout and the caller's swap back costs
no copy) and the final state, launches on PyTorch's current stream, raises
if the launch was refused, and adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: the head sizes the kernel takes (a template instance each)
HEAD_SIZES = (16, 32, 64)
#: time steps a stage holds and the stages of the ring (``kT``, ``kStages``
#: in ``rwkv.cu``)
STAGE_STEPS, STAGES = 16, 2


def wkv_threads(kd: int) -> int:
    """Threads of a block, one block per (head, batch): 2 K."""
    return 2 * kd


def wkv_tiles(kd: int) -> list[tuple[range, range]]:
    """The state entries each thread owns, by thread: rows
    [g K/8, (g+1) K/8) with g = lane >> 2, and 4 columns from
    4 (4 warp + (lane & 3))."""
    ti = kd // 8
    tiles = []
    for tid in range(wkv_threads(kd)):
        lane, warp = tid % 32, tid // 32
        i0, j0 = (lane >> 2) * ti, 4 * (4 * warp + (lane & 3))
        tiles.append((range(i0, i0 + ti), range(j0, j0 + 4)))
    return tiles


def wkv_smem_bytes(kd: int, elem_size: int) -> int:
    """Shared memory of one block (``wkv_smem_bytes`` in ``rwkv.cu``): the
    ring of r, k, w, v stages in the storage type, an f32 copy of one stage
    for bf16, y of one stage and one dot a step, in f32."""
    stage = 4 * STAGE_STEPS * kd
    return (STAGES * stage * elem_size + (0 if elem_size == 4 else 4 * stage)
            + 4 * STAGE_STEPS * kd + 4 * STAGE_STEPS)


def wkv_dot_lanes(kd: int) -> list[tuple[int, range]]:
    """The step of a stage and the 8 elements of r . (u k) each thread takes:
    K / 8 consecutive lanes a step."""
    q = kd // 8
    return [(tid // q, range(8 * (tid % q), 8 * (tid % q) + 8)) for tid in range(wkv_threads(kd))]


def _aligned(t):
    """``t`` if its base and its strides over (b, h, s) are 16-byte multiples
    (the kernel's 16-byte copies), else a contiguous copy."""
    es = t.element_size()
    if t.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              ctypes.POINTER(ctypes.c_longlong), _I, _P]


class _WkvScan(Kernel):
    def __call__(self, r, k, v, w, u, chunk: int = 64, state0=None):
        """r, k, v, w: (B, H, S, K) of one dtype (f32 or bf16), any strides
        with K contiguous; u: (H, K); state0: (B, H, K, K) or None (zeros) ->
        (y (B, H, S, K) f32, state (B, H, K, K) f32).  ``chunk`` is the TPU
        kernel's time tile: this kernel takes any S."""
        del chunk
        if r.dtype not in KERNEL_DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
            raise TypeError(f"{self.name} takes float32 or bfloat16 r, k, v, w of one dtype, "
                            f"got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
        if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)) or 0 in r.shape:
            raise ValueError(f"{self.name}: r, k, v, w must share one non-empty (B, H, S, K) "
                             f"shape, got {[tuple(t.shape) for t in (r, k, v, w)]}")
        b, h, s, kd = r.shape
        if kd not in HEAD_SIZES:
            raise ValueError(f"{self.name}: head size {kd} is not one of {HEAD_SIZES}")
        if tuple(u.shape) != (h, kd):
            raise ValueError(f"{self.name}: u must be (H, K) = {(h, kd)}, got {tuple(u.shape)}")
        if state0 is not None and tuple(state0.shape) != (b, h, kd, kd):
            raise ValueError(f"{self.name}: state0 must be {(b, h, kd, kd)}, got "
                             f"{tuple(state0.shape)}")
        if any(t.stride(-1) != 1 for t in (r, k, v, w)):
            raise ValueError(f"{self.name}: the K axis of r, k, v and w must be contiguous")
        tensors = (r, k, v, w, u) + (() if state0 is None else (state0,))
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{self.name}: every input must be on one device")
        r, k, v, w = (_aligned(t) for t in (r, k, v, w))
        u = _aligned(u.float().contiguous())
        if state0 is not None:
            state0 = _aligned(state0.float().contiguous())
        y = torch.empty_like(r, dtype=torch.float32)
        if y.stride(-1) != 1 or any(st % 4 for st in y.stride()[:-1]):
            y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        state = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
        strides = (ctypes.c_longlong * 15)(*(st for t in (r, k, v, w, y) for st in t.stride()[:3]))
        err = bind("rwkv", "wkv_scan", _SIGNATURE)(
            KERNEL_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), b, h, s, kd, strides, r.device.index, stream(r),
        )
        raise_on(err, self.name)
        self.launches += 1
        return y, state


wkv_scan = _WkvScan("wkv_scan")
KERNELS = (wkv_scan,)

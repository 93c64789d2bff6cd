"""Binding of the hand-written CUDA flash attention (``csrc/attention.cu``).

``flash_attention`` replaces the Pallas kernel of the same name in
``repro/kernels/attention/attention.py``.  It is bound by operations (two
D-long products per visible (query, key) pair); the source note in
``attention.cu`` gives the design.  Three kernels compute it, chosen by a
shape rule (:func:`flash_path`), not by a fallback: bf16 with a head dim that
is a multiple of 16 takes the tensor-core kernel (wgmma, TMA) when TMA can
copy q, k and v; f32 with a head dim that is a multiple of 8 takes the TF32
tensor-core kernel (``mma.sync`` in 3xTF32, a ``cp.async`` ring) when its
16-byte copies can take q, k and v; every other call takes the CUDA-core
kernel.  The wrapper checks what the
kernel takes, allocates the output with q's strides (so a (B, S, H, D) tensor
viewed as (B, H, S, D) comes back in the same layout, and the caller's swap
back costs no copy), launches on PyTorch's current stream, raises if the
launch was refused, and adds one to its ``launches`` count and to the path's
in ``launches_by_path``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: the head dims the kernels take: multiples of 4 (float4 tiles) up to 128
MAX_HEAD_DIM = 128
#: the tensor-core kernel's bf16 head dims are multiples of this (wgmma's k)
TC_HEAD_DIM_STEP = 16
#: the TF32 kernel's f32 head dims are multiples of this (mma.sync's k)
TF32_HEAD_DIM_STEP = 8
#: the TF32 kernel's plan (``TF32_PLAN`` in ``attention.cu``): key rows of a
#: K/V tile, stages of the K/V ring, warps of a block (16 query rows each);
#: each staged row is the head dim padded to 32, 64 or 128 plus 4 floats
TF32_PLAN = (64, 2, 8)
TF32_KEYS, TF32_STAGES, TF32_WARPS = TF32_PLAN
TF32_ROWS, TF32_PAD = 16 * TF32_WARPS, 4
#: tensor-core tiles: 128 query rows a CTA, 128-row K/V tiles in a 3-stage
#: ring, each tile in 64-column halves of 128-byte rows (``attention.cu``)
TC_ROWS, TC_STAGES, TC_HALF_BYTES, TC_BARRIER_BYTES = 128, 3, 128 * 128, 128
#: shared memory one block may take on the card
SMEM_LIMIT = 232448
#: what TMA takes: a 16-byte-aligned base and 16-byte-multiple strides
TMA_ALIGN = 16
#: the C entry's code for a tensor map the driver refused (+ the CUresult)
_MAP_ERROR = 100000

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURE = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _I, ctypes.c_float, _I, _P]
_TC_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _I, ctypes.c_float, _I, _P]
#: the paths :func:`flash_path` names, as ``launches_by_path`` counts them
FLASH_PATHS = ("tensor_core", "tf32", "cuda_core")


def tc_head_dim(d: int) -> int:
    """The head dim the tensor-core kernel pads ``d`` to: 64 or 128."""
    return 64 if d <= 64 else 128


def tc_smem_bytes(d_pad: int) -> int:
    """Shared memory of one tensor-core CTA (``tc_smem_bytes`` in
    ``attention.cu``): Q and every stage of K and V, ``d_pad // 64`` halves
    each, 1 KB to align the swizzle, the barriers."""
    return (1 + 2 * TC_STAGES) * (d_pad // 64) * TC_HALF_BYTES + 1024 + TC_BARRIER_BYTES


def tf32_head_dim(d: int) -> int:
    """The head dim the TF32 kernel pads ``d`` to: 32, 64 or 128."""
    return 32 if d <= 32 else 64 if d <= 64 else 128


def tf32_smem_bytes(d_pad: int, plan=TF32_PLAN) -> int:
    """Shared memory of one TF32 block (``tf32_smem_bytes`` in
    ``attention.cu``) under ``plan``: every stage's K and V tile, rows of
    ``d_pad`` plus the pad, in f32."""
    keys, stages, _ = plan
    return stages * 2 * keys * (d_pad + TF32_PAD) * 4


def tma_strides(t: torch.Tensor) -> list[int]:
    """The (batch, head, row) element strides a tensor map is given; an axis
    of extent 1 is never stepped, so its stride is set to 16 bytes."""
    return [s if n > 1 else TMA_ALIGN // t.element_size()
            for n, s in zip(t.shape[:3], t.stride()[:3])]


def tma_takes(t: torch.Tensor) -> bool:
    """Whether TMA (or the TF32 kernel's 16-byte ``cp.async`` copies) can
    copy ``t``: a 16-byte-aligned base and (batch, head, row) strides that
    are multiples of 16 bytes."""
    es = t.element_size()
    return t.data_ptr() % TMA_ALIGN == 0 and all(s * es % TMA_ALIGN == 0 for s in tma_strides(t))


def flash_path(q, k, v) -> str:
    """The kernel that computes ``flash_attention(q, k, v)``: "tensor_core"
    for bf16 with a head dim that is a multiple of 16, "tf32" for f32 with a
    head dim that is a multiple of 8, each when q, k and v take 16-byte
    copies (:func:`tma_takes`); "cuda_core", whose loads take any base and
    strides, for every other call."""
    step = {torch.bfloat16: TC_HEAD_DIM_STEP, torch.float32: TF32_HEAD_DIM_STEP}.get(q.dtype)
    if step is None or q.shape[-1] % step or not all(tma_takes(t) for t in (q, k, v)):
        return "cuda_core"
    return "tensor_core" if q.dtype == torch.bfloat16 else "tf32"


class _FlashAttention(Kernel):
    def __init__(self, name: str):
        super().__init__(name)
        self.launches_by_path = dict.fromkeys(FLASH_PATHS, 0)

    def __call__(self, q, k, v, causal: bool = True):
        """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), f32 or bf16, any
        strides with D contiguous -> o: (B, Hq, Sq, D) in q's dtype."""
        if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"{self.name} takes float32 or bfloat16 q, k, v of one dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
            raise ValueError(f"{self.name}: q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        b, hq, sq, d = q.shape
        _, hkv, skv, dk = k.shape
        if k.shape[0] != b or dk != d or hq % hkv or 0 in q.shape or 0 in k.shape:
            raise ValueError(f"{self.name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} need "
                             "one batch, one head_dim and Hq % Hkv == 0")
        if d % 4 or d > MAX_HEAD_DIM:
            raise ValueError(f"{self.name}: head_dim {d} is not a multiple of 4 up to "
                             f"{MAX_HEAD_DIM}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError(f"{self.name}: the head_dim axis of q, k and v must be contiguous")
        if len({q.device, k.device, v.device}) != 1:
            raise ValueError(f"{self.name}: q, k and v must be on one device")
        path = flash_path(q, k, v)
        o = torch.empty_like(q)
        if o.stride(-1) != 1:
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if path == "tensor_core":
            st = [*tma_strides(q), *tma_strides(k), *tma_strides(v), *o.stride()[:3]]
            err = bind("attention", "flash_attention_tc", _TC_SIGNATURE)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, sq, skv, d,
                (ctypes.c_longlong * 12)(*st), int(causal), d**-0.5, q.device.index, stream(q),
            )
            if err >= _MAP_ERROR:
                raise RuntimeError(f"{self.name}: the driver refused a TMA tensor map "
                                   f"(CUresult {err - _MAP_ERROR}; 0: no cuTensorMapEncodeTiled)")
        elif path == "tf32":
            st = [s for t in (q, k, v, o) for s in t.stride()[:3]]
            err = bind("attention", "flash_attention_tf32", _TC_SIGNATURE)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, sq, skv, d,
                (ctypes.c_longlong * 12)(*st), int(causal), d**-0.5, q.device.index, stream(q),
            )
        else:
            st = [s for t in (q, k, v, o) for s in t.stride()[:3]]
            err = bind("attention", "flash_attention", _SIGNATURE)(
                KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, hq, hkv, sq, skv, d, (ctypes.c_longlong * 12)(*st), int(causal), d**-0.5,
                q.device.index, stream(q),
            )
        raise_on(err, self.name)
        self.launches += 1
        self.launches_by_path[path] += 1
        return o


flash_attention = _FlashAttention("flash_attention")
KERNELS = (flash_attention,)

"""Public wrapper of the flash attention kernel, the port of the reference's
``kernels/attention/ops.py::flash_sdpa``.

CPU tensors take the plain version (``ref.py``), which autograd
differentiates; CUDA tensors take the hand-written kernel, or raise.  The
kernel has no backward yet: on the card it is called through
``forward_only``, so a gradient through it raises.  ``block_q`` and
``block_k`` are the TPU kernel's tile sizes, kept so calls read the same in
both packages; the CUDA kernels tile by 64 or 128 and take any Sq and Skv,
and neither choice changes the result beyond the order of its f32 sums."""

from __future__ import annotations

from repro_torch.kernels.attention import attention as _k
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.common import forward_only, use_plain

_flash_on_card = forward_only(_k.flash_attention, "flash_attention")


def flash_sdpa(q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    if use_plain(q, k, v):
        return attention_ref(q, k, v, causal=causal)
    return _flash_on_card(q, k, v, causal=causal)

"""The hand-written CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: y / x in f32 at 1e-4 absolute per element (the reference's
kernel bound); bf16 compared as f32-upcast values at rtol = atol = 2e-2; ld
at rtol 1e-5 with atol 1e-4 (a sum of B*M*ca terms in another order).
"""

import pytest
import torch

from repro_torch.kernels.flowstep import flowstep as kern
from repro_torch.kernels.flowstep.ops import fused_flowstep_fwd, fused_flowstep_inv
from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, m, c, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    ca = c // 2
    x = torch.randn(b, m, c, generator=g)
    ls, ab = 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w = torch.randn(c, c, generator=g) / c**0.5 + torch.eye(c)
    h = torch.randn(b, m, 2 * ca, generator=g)
    x, h = x.to(dev, dtype), h.to(dev, dtype)
    return x, ls.to(dev), ab.to(dev), w.to(dev), h[..., :ca], h[..., ca:]


def _close(a, b, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=0, atol=1e-4)
    torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (8, 300, 12), (2, 28, 6)])
def test_kernels_match_plain_versions(dev, shape, dtype):
    x, ls, ab, w, raw, t = _inputs(*shape, dtype, dev)
    fwd0, inv0 = kern.flowstep_fwd.launches, kern.flowstep_inv.launches
    y, ld = fused_flowstep_fwd(x, ls, ab, w, raw, t)
    y_r, ld_r = flowstep_fwd_ref(x, ls, ab, w, raw, t)
    _close(y, y_r, dtype)
    torch.testing.assert_close(ld, ld_r, rtol=1e-5, atol=1e-4)
    w_inv = torch.linalg.inv(w)
    back = fused_flowstep_inv(y_r, ls, ab, w_inv, raw, t)
    _close(back, flowstep_inv_ref(y_r, ls, ab, w_inv, raw, t), dtype)
    torch.cuda.synchronize()
    assert (kern.flowstep_fwd.launches, kern.flowstep_inv.launches) == (fwd0 + 1, inv0 + 1)
    _, ld2 = fused_flowstep_fwd(x, ls, ab, w, raw, t)
    assert torch.equal(ld, ld2)  # no atomics: bitwise repeatable


def test_gradient_through_the_kernel_raises(dev):
    x, ls, ab, w, raw, t = _inputs(2, 64, 12, torch.float32, dev)
    x.requires_grad_(True)
    y, ld = fused_flowstep_fwd(x, ls, ab, w, raw, t)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        (y.sum() + ld.sum()).backward()

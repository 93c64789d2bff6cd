"""The fused flow-step module of the port against the reference's Pallas
kernels, and its dispatch by tensor device.

The reference's ``flowstep_fwd`` / ``flowstep_inv`` run with
``interpret=True``, as ``tests/test_flowstep.py`` runs them on the CPU; the
port's plain versions (``ref.py``, which a wrapper runs for CPU tensors) are
held against them over the ragged spatial extents of ``tests/test_kernels.py``
(M = 300, 96, 28), C in {6, 12}, in float32 and bfloat16.  The CUDA kernels
themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, each with its reason:

* y / x in f32: 1e-4 absolute per element, the reference's own kernel bound;
* bf16: the f32-upcast values at rtol = atol = 2e-2 (the reference's bf16
  bound in ``tests/test_flowstep.py``): both sides compute in f32 and round
  the output to bf16, which can land one bf16 ulp apart;
* ld: a sum of B*M*ca float32 terms taken in another order, so it is held to
  rtol 1e-5 with atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pick_block_m
from repro.kernels.flowstep.flowstep import flowstep_fwd as j_flowstep_fwd
from repro.kernels.flowstep.flowstep import flowstep_inv as j_flowstep_inv
from repro_torch.kernels import common
from repro_torch.kernels.flowstep import flowstep as kern
from repro_torch.kernels.flowstep.ops import fused_flowstep_fwd, fused_flowstep_inv
from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, m, c, seed=0):
    """Float32 numpy inputs of one flow step: x, an_ls, an_b, w, raw, t."""
    rng = np.random.default_rng(seed)
    ca = c // 2
    return (
        rng.standard_normal((b, m, c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c) + np.eye(c)).astype(np.float32),
        rng.standard_normal((b, m, ca)).astype(np.float32),
        rng.standard_normal((b, m, ca)).astype(np.float32),
    )


def _both(arrays, dtype):
    """(jax, torch) versions; the (B, M, *) tensors in ``dtype``, the
    channel parameters and W in float32."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a).astype(jdt if a.ndim == 3 else jnp.float32) for a in arrays]
    t = [torch.from_numpy(a).to(tdt if a.ndim == 3 else torch.float32) for a in arrays]
    return j, t


def _f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _close(a, b, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(a), _f32(b), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [6, 12])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_plain_fwd_matches_reference_kernel(m, c, dtype):
    (jx, jls, jb, jw, jraw, jt), (x, ls, b, w, raw, t) = _both(_inputs(2, m, c), dtype)
    jy, jld = j_flowstep_fwd(jx, jls, jb, jw, jraw, jt, block_m=pick_block_m(m), interpret=True)
    y, ld = flowstep_fwd_ref(x, ls, b, w, raw, t)
    assert y.dtype == x.dtype and ld.dtype == torch.float32
    _close(y, jy, dtype)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [6, 12])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_plain_inv_matches_reference_kernel(m, c, dtype):
    # y is a forward output, so x comes back at the input's scale
    x0, ls0, b0, w0, raw0, t0 = _inputs(2, m, c, seed=1)
    y0, _ = flowstep_fwd_ref(*(torch.from_numpy(a) for a in (x0, ls0, b0, w0, raw0, t0)))
    arrays = [y0.numpy(), ls0, b0, np.linalg.inv(w0).astype(np.float32), raw0, t0]
    (jy, jls, jb, jwi, jraw, jt), (y, ls, b, wi, raw, t) = _both(arrays, dtype)
    jx = j_flowstep_inv(jy, jls, jb, jwi, jraw, jt, block_m=pick_block_m(m), interpret=True)
    x = flowstep_inv_ref(y, ls, b, wi, raw, t)
    assert x.dtype == y.dtype
    _close(x, jx, dtype)


@pytest.mark.parametrize("m", [300, 28])
def test_plain_pair_round_trips(m):
    x, ls, b, w, raw, t = (torch.from_numpy(a) for a in _inputs(2, m, 12, seed=2))
    y, _ = flowstep_fwd_ref(x, ls, b, w, raw, t)
    back = flowstep_inv_ref(y, ls, b, torch.linalg.inv(w), raw, t)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """On CPU tensors the wrappers are the plain versions (same values, bit
    for bit), no kernel library is loaded and no launch is counted."""
    before = (kern.flowstep_fwd.launches, kern.flowstep_inv.launches)
    x, ls, b, w, raw, t = (torch.from_numpy(a) for a in _inputs(2, 96, 12, seed=3))
    h = torch.cat([raw, t], dim=-1)  # strided halves, as the flow step passes them
    y, ld = fused_flowstep_fwd(x, ls, b, w, h[..., :6], h[..., 6:])
    y_r, ld_r = flowstep_fwd_ref(x, ls, b, w, raw, t)
    assert torch.equal(y, y_r) and torch.equal(ld, ld_r)
    wi = torch.linalg.inv(w)
    assert torch.equal(fused_flowstep_inv(y, ls, b, wi, raw, t), flowstep_inv_ref(y, ls, b, wi, raw, t))
    assert (kern.flowstep_fwd.launches, kern.flowstep_inv.launches) == before == (0, 0)
    assert common._libs == {}


def test_dispatch_raises_off_cpu_and_cuda():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="several devices"):
        common.use_plain(x, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fused_flowstep_fwd(*(torch.zeros(s, device="meta") for s in
                             [(1, 4, 2), (2,), (2,), (2, 2), (1, 4, 1), (1, 4, 1)]))


def _kernel_args(m=40, c=12, dtype=torch.float32):
    x, ls, b, w, raw, t = (torch.from_numpy(a) for a in _inputs(2, m, c, seed=4))
    return [x.to(dtype), ls, b, w, raw.to(dtype), t.to(dtype)]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(0, a[0].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
    (lambda a: a.__setitem__(4, a[4][:, :-1]), ValueError),
    (lambda a: a.__setitem__(5, a[5].to(torch.bfloat16)), ValueError),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    args = _kernel_args()
    bad(args)
    with pytest.raises(err):
        kern._check(*args)


def test_kernel_wrapper_tile_and_shared_memory_limit():
    """The tile path's block and shared memory (raw and t two tensors: not
    the stream's halves of one conditioner output)."""
    args = _kernel_args(m=300, c=12)
    assert kern.flowstep_path(args[0], args[4], args[5]) == "tile"
    (b, m, c, ca, block_m), params = kern._check(*args)
    assert (b, m, c, ca) == (2, 300, 12, 6) and block_m == kern.TILE_ELEMS // 12
    assert all(p.dtype == torch.float32 and p.is_contiguous() for p in params)
    # the slice's widths fit: C = 12, 24, 48
    for c in (12, 24, 48):
        assert kern.smem_bytes(c, kern.TILE_ELEMS // c) <= kern.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kern._check(*_kernel_args(m=8, c=128))

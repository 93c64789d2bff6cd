"""The backward kernels of the port's flow step against the reference's
Pallas kernels, and the backward body of the fused step's
``autograd.Function``.

The reference's ``spine_bwd`` / ``coupling_bwd`` run with ``interpret=True``,
as ``tests/test_flowstep.py`` runs them on the CPU; the port's plain versions
(which a wrapper runs for CPU tensors) are held against them over the ragged
spatial extents M = 300, 96, 28, C in {6, 12}, in float32 and bfloat16.  The
CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, the reference's own (``tests/test_flowstep.py``):

* per-element outputs: 1e-4 absolute in f32; rtol = atol = 2e-2 in bf16
  (both sides compute in f32 and round to bf16, which can land one ulp
  apart);
* the sums over (b, m) (``gW``, ``g_log_s``, ``g_b``): rtol = atol = 1e-4
  in f32 and 5e-2 in bf16, sums of B*M terms taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pick_block_m
from repro.kernels.coupling.coupling import coupling_bwd as j_coupling_bwd
from repro.kernels.flowstep.flowstep import spine_bwd as j_spine_bwd
from repro.kernels.flowstep.ops import _fwd_pallas
from repro_torch.kernels import common
from repro_torch.kernels.coupling import coupling as ckern
from repro_torch.kernels.coupling.ops import fused_coupling_bwd
from repro_torch.kernels.coupling.ref import coupling_bwd_ref
from repro_torch.kernels.flowstep import flowstep as kern
from repro_torch.kernels.flowstep.ops import flowstep_fwd_vjp, fused_spine_bwd
from repro_torch.kernels.flowstep.ref import spine_bwd_ref

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TILE_TOL = {"float32": dict(rtol=0, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SUM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _channel_params(c, rng):
    w = (rng.standard_normal((c, c)) / np.sqrt(c) + np.eye(c)).astype(np.float32)
    ls = (0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return w, np.linalg.inv(w).astype(np.float32), ls, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [6, 12])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_plain_spine_bwd_matches_reference_kernel(m, c, dtype):
    rng = np.random.default_rng(m + c)
    (jx2, x2), (jgx2, gx2) = (_both(rng.standard_normal((2, m, c)).astype(np.float32), dtype)
                              for _ in range(2))
    w, wi, ls, b = _channel_params(c, rng)
    ref = j_spine_bwd(jx2, jgx2, *map(jnp.asarray, (w, wi, ls, b)), block_m=pick_block_m(m),
                      interpret=True)
    got = spine_bwd_ref(x2, gx2, *map(torch.from_numpy, (w, wi, ls, b)))
    assert got[0].dtype == got[1].dtype == x2.dtype
    assert all(g.dtype == torch.float32 for g in got[2:])
    for name, a, r in zip(("x", "gx", "gW", "g_log_s", "g_b"), got, ref):
        tol = SUM_TOL[dtype] if name.startswith("g") and name != "gx" else TILE_TOL[dtype]
        np.testing.assert_allclose(_f32(a), _f32(r), **tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [6, 12])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_plain_coupling_bwd_matches_reference_kernel(m, c, dtype):
    """On the transformed half of a (B, M, C) step, as the flow step passes
    it: y and gy are the first C/2 channels, raw/t the halves of one
    conditioner output (strided views on the port's side)."""
    rng = np.random.default_rng(2 * m + c)
    ca = c // 2
    y, gy, h = (rng.standard_normal((2, m, c)).astype(np.float32) for _ in range(3))
    gld = rng.standard_normal(2).astype(np.float32)
    (jy, ty), (jgy, tgy), (jh, th) = (_both(a, dtype) for a in (y, gy, h))
    ref = j_coupling_bwd(jy[..., :ca], jh[..., :ca], jh[..., ca:], jgy[..., :ca],
                         jnp.asarray(gld), block_m=pick_block_m(m), interpret=True)
    got = fused_coupling_bwd(ty[..., :ca], th[..., :ca], th[..., ca:], tgy[..., :ca],
                             torch.from_numpy(gld))
    for name, a, r in zip(("x", "gx", "graw", "gt"), got, ref):
        assert a.dtype == ty.dtype and tuple(a.shape) == (2, m, ca)
        np.testing.assert_allclose(_f32(a), _f32(r), **TILE_TOL[dtype], err_msg=name)


@pytest.mark.parametrize("m", [96, 28])
def test_flowstep_vjp_matches_reference_custom_vjp(m):
    """The backward body of the port's fused step (what ``_FwdFn.backward``
    runs) against ``jax.vjp`` of the reference's Pallas custom VJP, in
    interpret mode, at 1e-4."""
    rng = np.random.default_rng(m)
    c, ca = 12, 6
    x = rng.standard_normal((2, m, c)).astype(np.float32)
    h = rng.standard_normal((2, m, c)).astype(np.float32)
    w, _, ls, b = _channel_params(c, rng)
    gy = rng.standard_normal((2, m, c)).astype(np.float32)
    gld = rng.standard_normal(2).astype(np.float32)
    jargs = [jnp.asarray(v) for v in (x, ls, b, w, h[..., :ca], h[..., ca:])]
    (jy, _), vjp = jax.vjp(
        lambda *a: _fwd_pallas(*a, 2.0, pick_block_m(m), True), *jargs)
    ref = vjp((jnp.asarray(gy), jnp.asarray(gld)))
    th = torch.from_numpy(h)
    got = flowstep_fwd_vjp(torch.from_numpy(np.array(jy)), th[..., :ca], th[..., ca:],
                           *map(torch.from_numpy, (ls, b, w, gy, gld)))
    # the reference returns (gx, g_an_ls, g_an_b, gW, graw, gt), the port too
    for name, a, r in zip(("gx", "g_an_log_s", "g_an_b", "gW", "graw", "gt"), got, ref):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=1e-4, atol=1e-4, err_msg=name)


def test_cpu_tensors_take_the_plain_backward_and_launch_nothing():
    rng = np.random.default_rng(7)
    x2, gx2 = (torch.from_numpy(rng.standard_normal((2, 40, 12)).astype(np.float32))
               for _ in range(2))
    w, wi, ls, b = map(torch.from_numpy, _channel_params(12, rng))
    got = fused_spine_bwd(x2, gx2, w, wi, ls, b)
    assert all(torch.equal(a, r) for a, r in zip(got, spine_bwd_ref(x2, gx2, w, wi, ls, b)))
    gld = torch.ones(2)
    got = fused_coupling_bwd(x2[..., :6], gx2[..., :6], gx2[..., 6:], x2[..., 6:], gld)
    ref = coupling_bwd_ref(x2[..., :6], gx2[..., :6], gx2[..., 6:], x2[..., 6:], gld)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert kern.spine_bwd.launches == ckern.coupling_bwd.launches == 0
    assert common._libs == {}


def _spine_args(m=40, c=12):
    rng = np.random.default_rng(8)
    x2, gx2 = (torch.from_numpy(rng.standard_normal((2, m, c)).astype(np.float32))
               for _ in range(2))
    return [x2, gx2, *map(torch.from_numpy, _channel_params(c, rng))]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(0, a[0].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
    (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), ValueError),
    (lambda a: a.__setitem__(1, a[1][:, :-1]), ValueError),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError),
    (lambda a: a.__setitem__(4, a[4][:-1]), ValueError),
])
def test_spine_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    args = _spine_args()
    bad(args)
    with pytest.raises(err):
        kern.spine_bwd(*args)
    assert common._libs == {}


def test_spine_wrapper_shared_memory_limit():
    # the trained widths fit: C = 12, 24, 48
    for c in (12, 24, 48):
        assert kern.spine_smem_bytes(c, kern.TILE_ELEMS // c) <= kern.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kern.spine_bwd(*_spine_args(m=8, c=96))


def _coupling_args():
    rng = np.random.default_rng(9)
    y, gy, h = (torch.from_numpy(rng.standard_normal((2, 40, 12)).astype(np.float32))
                for _ in range(3))
    return [y[..., :6], h[..., :6], h[..., 6:], gy[..., :6], torch.ones(2)]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(1, a[1].transpose(1, 2).contiguous().transpose(1, 2)), ValueError),
    (lambda a: a.__setitem__(2, a[2].contiguous()), ValueError),
    (lambda a: a.__setitem__(3, a[3][:, :-1]), ValueError),
    (lambda a: a.__setitem__(4, torch.ones(3)), ValueError),
])
def test_coupling_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    args = _coupling_args()
    bad(args)
    with pytest.raises(err):
        ckern.coupling_bwd(*args)
    assert common._libs == {}

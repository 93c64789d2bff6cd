"""The fused affine coupling of the port against the reference's Pallas
kernels, and the ``autograd.Function``s around it.

The reference's ``coupling_fwd`` / ``coupling_inv`` and the custom VJP of its
forward run with ``interpret=True``, as ``tests/test_kernels.py`` runs them
on the CPU.  The port's wrappers, given CPU tensors, run the plain versions
in ``kernels/coupling/ref.py``; they are fed strided views (x the first half
of a (B, M, 2*ca) tensor, raw/t the halves of one conditioner output), as the
flow passes them, over the ragged spatial extents M = 300, 96, 28, in float32
and bfloat16.  The CUDA kernels are held against the same plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, the reference's own (``tests/test_kernels.py``,
``tests/test_flowstep.py``):

* per-element outputs: 1e-4 absolute in f32; rtol = atol = 2e-2 in bf16
  (both sides compute in f32 and round to bf16, which can land one ulp
  apart);
* ``ld``: rtol 1e-5, atol 1e-4, a sum of M*ca terms taken in another order;
* gradients through the forward's custom VJP: 1e-4 absolute (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pick_block_m
from repro.kernels.coupling.coupling import coupling_fwd as j_coupling_fwd
from repro.kernels.coupling.coupling import coupling_inv as j_coupling_inv
from repro.kernels.coupling.ops import _fwd_pallas
from repro_torch.kernels import common
from repro_torch.kernels.coupling import coupling as ckern
from repro_torch.kernels.coupling.ops import (
    fused_coupling_bwd,
    fused_coupling_fwd,
    fused_coupling_inv,
)
from repro_torch.kernels.coupling.ref import coupling_fwd_ref, coupling_inv_ref

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TILE_TOL = {"float32": dict(rtol=0, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _halves(m, ca, dtype, seed):
    """x (the first ca channels of a (2, m, 2*ca) tensor) and raw, t (the
    halves of another), on both sides: strided views on the port's."""
    rng = np.random.default_rng(seed)
    xx, h = (rng.standard_normal((2, m, 2 * ca)).astype(np.float32) for _ in range(2))
    (jx, tx), (jh, th) = _both(xx, dtype), _both(h, dtype)
    return (jx[..., :ca], jh[..., :ca], jh[..., ca:]), (tx[..., :ca], th[..., :ca], th[..., ca:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ca", [3, 6])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_plain_coupling_fwd_and_inv_match_reference_kernels(m, ca, dtype):
    (jx, jraw, jt), (tx, traw, tt) = _halves(m, ca, dtype, 10 * m + ca)
    assert tx.stride(-1) == 1 and not tx.is_contiguous()
    jy, jld = j_coupling_fwd(jx, jraw, jt, block_m=pick_block_m(m), interpret=True)
    y, ld = fused_coupling_fwd(tx, traw, tt)
    assert y.dtype == tx.dtype and tuple(y.shape) == (2, m, ca) and ld.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(jy), **TILE_TOL[dtype])
    np.testing.assert_allclose(_f32(ld), _f32(jld), rtol=1e-5, atol=1e-4)
    # the inverse, from the same (strided) output side
    jback = j_coupling_inv(jx, jraw, jt, block_m=pick_block_m(m), interpret=True)
    back = fused_coupling_inv(tx, traw, tt)
    np.testing.assert_allclose(_f32(back), _f32(jback), **TILE_TOL[dtype])
    if dtype == "float32":
        np.testing.assert_allclose(_f32(fused_coupling_inv(y, traw, tt)), _f32(tx), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("m", [300, 28])
def test_fused_coupling_fwd_gradient_matches_reference_custom_vjp(m):
    """The port's ``autograd.Function`` (backward from the output side
    through ``fused_coupling_bwd``) against ``jax.vjp`` of the reference's
    Pallas custom VJP in interpret mode."""
    ca = 6
    (jx, jraw, jt), (tx, traw, tt) = _halves(m, ca, "float32", m)
    rng = np.random.default_rng(m + 1)
    gy = rng.standard_normal((2, m, ca)).astype(np.float32)
    gld = rng.standard_normal(2).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _fwd_pallas(*a, 2.0, pick_block_m(m), True), jx, jraw, jt)
    ref = vjp((jnp.asarray(gy), jnp.asarray(gld)))
    leaves = [v.detach().clone().requires_grad_() for v in (tx, traw, tt)]
    y, ld = fused_coupling_fwd(*leaves)
    assert y.grad_fn is not None and "FwdFn" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (ld * torch.from_numpy(gld)).sum(),
                              leaves)
    for name, a, r in zip(("gx", "graw", "gt"), got, ref):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fused_coupling_inv_has_no_gradient():
    _, (ty, traw, tt) = _halves(28, 3, "float32", 5)
    y = ty.detach().clone().requires_grad_()
    x = fused_coupling_inv(y, traw, tt)
    with pytest.raises(NotImplementedError, match="no gradient"):
        x.sum().backward()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _, (tx, traw, tt) = _halves(40, 6, "float32", 6)
    y, ld = fused_coupling_fwd(tx, traw, tt)
    y_r, ld_r = coupling_fwd_ref(tx, traw, tt)
    assert torch.equal(y, y_r) and torch.equal(ld, ld_r)
    assert torch.equal(fused_coupling_inv(y, traw, tt), coupling_inv_ref(y, traw, tt))
    fused_coupling_bwd(y, traw, tt, y, torch.ones(2))
    assert all(k.launches == 0 for k in ckern.KERNELS)
    assert common._libs == {}


def test_bindings_refuse_what_the_kernels_do_not_take():
    """The wrappers check their inputs before any library is loaded."""
    _, (tx, traw, tt) = _halves(28, 3, "float32", 7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ckern.coupling_fwd(tx.double(), traw.double(), tt.double())
    with pytest.raises(ValueError, match="share strides"):
        ckern.coupling_inv(tx, traw, tt.contiguous())
    with pytest.raises(ValueError, match="unit channel stride"):
        ckern.coupling_fwd(tx.transpose(1, 2), traw.transpose(1, 2), tt.transpose(1, 2))
    with pytest.raises(ValueError, match="gld"):
        ckern.coupling_bwd(tx, traw, tt, tx, torch.ones(3))
    assert common._libs == {}

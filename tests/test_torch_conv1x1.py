"""The port's ``invertible_conv1x1`` against the reference's op.

The reference's ``invertible_conv1x1`` runs its Pallas kernels in interpret
mode (``REPRO_PALLAS_INTERPRET=1``, as ``tests/test_kernels.py`` forces it);
the port's op, given CPU tensors, runs the plain versions in
``kernels/conv1x1/ref.py`` inside the same ``autograd.Function`` that the
card runs with the CUDA kernels.  Inputs come from numpy with a seed, at the
reference's shapes (``tests/test_kernels.py:204,216,238``).

Tolerances, the reference's own:

* forward: rtol = atol = 2e-5 in f32 (the same products summed in another
  order), 2e-2 in bf16 (one bf16 ulp);
* VJP in f32: 1e-4;
* VJP in bf16: gx at 2e-2, and gW, an f32 sum of bf16 products, at 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import INTERPRET_ENV
from repro.kernels.conv1x1.ops import invertible_conv1x1 as j_invertible_conv1x1
from repro_torch.kernels import common
from repro_torch.kernels.conv1x1 import conv1x1 as kern
from repro_torch.kernels.conv1x1.ops import invertible_conv1x1
from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref, conv1x1_mm_ref

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _reference_runs_its_kernels(monkeypatch):
    monkeypatch.setenv(INTERPRET_ENV, "1")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _f32(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1],) * 2).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(gy).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(gy).to(tdt)))


def _grads(mm, x, w, gy, jax_side):
    if jax_side:
        return jax.grad(lambda x_, w_: jnp.sum(mm(x_, w_).astype(jnp.float32)
                                               * gy.astype(jnp.float32)), argnums=(0, 1))(x, w)
    x_, w_ = x.clone().requires_grad_(), w.clone().requires_grad_()
    return torch.autograd.grad((mm(x_, w_).float() * gy.float()).sum(), (x_, w_))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 12), (1, 512, 48), (2, 128, 192), (1, 300, 8)])
def test_conv1x1_forward_matches_reference(shape, dtype):
    (jx, jw, _), (tx, tw, _) = _inputs(shape, dtype, sum(shape))
    ref = j_invertible_conv1x1(jx, jw, block_m=128)
    got = invertible_conv1x1(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(ref), **_tol(dtype))


@pytest.mark.parametrize("m", [256, 300])
def test_conv1x1_vjp_matches_reference(m):
    (jx, jw, jgy), (tx, tw, tgy) = _inputs((2, m, 12), "float32", m)
    ref = _grads(j_invertible_conv1x1, jx, jw, jgy, True)
    got = _grads(invertible_conv1x1, tx, tw, tgy, False)
    for name, a, r in zip(("gx", "gw"), got, ref):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [300, 96, 28])
def test_conv1x1_dtype_ragged_parity(m, dtype):
    """Forward and VJP at non-power-of-two extents in both dtypes; gW is an
    f32 sum whatever the activations' dtype, and comes back in W's dtype."""
    (jx, jw, jgy), (tx, tw, tgy) = _inputs((2, m, 8), dtype, m + 1)
    np.testing.assert_allclose(_f32(invertible_conv1x1(tx, tw)),
                               _f32(j_invertible_conv1x1(jx, jw)), **_tol(dtype))
    ref = _grads(j_invertible_conv1x1, jx, jw, jgy, True)
    got = _grads(invertible_conv1x1, tx, tw, tgy, False)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    gw_tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    for name, a, r, tol in zip(("gx", "gw"), got, ref, (_tol(dtype), gw_tol)):
        np.testing.assert_allclose(_f32(a), _f32(r), **tol, err_msg=f"{name} (m={m}, {dtype})")


def test_weight_is_rounded_to_the_activation_dtype_first():
    """In bf16 the product takes W rounded to bf16, as the reference's
    ``w.astype(x.dtype)``: the plain version equals an f32 product of the
    rounded operands."""
    x = torch.randn(2, 30, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    expect = (x.float() @ w.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(conv1x1_mm_ref(x, w), expect)
    assert not torch.equal(conv1x1_mm_ref(x, w), (x.float() @ w).to(torch.bfloat16))
    gw = conv1x1_gw_ref(x, x)
    assert gw.dtype == torch.float32 and gw.shape == (8, 8)


@pytest.mark.parametrize("n_rows,c,elem_size", [
    (131072, 12, 4), (32768, 24, 4), (8192, 48, 4), (8192, 48, 2), (256, 192, 4), (600, 8, 4),
])
def test_gw_chunks_keep_the_partials_small(n_rows, c, elem_size):
    """The row chunks of ``conv1x1_gw``: at least one, at most two per SM,
    and their (C, C) f32 partials at most a quarter of the inputs' bytes
    wherever more than one chunk is taken."""
    n = kern.gw_chunks(n_rows, c, elem_size, n_sm=132)
    assert 1 <= n <= min(264, n_rows)
    if n > 1:
        assert n * c * c * 4 <= n_rows * 2 * c * elem_size / 4
    rows = -(-n_rows // n)
    assert kern.gw_smem_bytes(c, min(rows, kern.TILE_ELEMS // c)) <= kern.SMEM_LIMIT


@pytest.mark.parametrize("c", [8, 12, 48, 192, 1000])
def test_mm_tiles_fit_in_shared_memory_without_opt_in(c):
    """``conv1x1_mm`` cuts W into column panels, so no C that the reference
    takes needs more than 48 KB a block (C = 192 in f32 is 147 KB of W)."""
    block_m = max(1, kern.TILE_ELEMS // c)
    panel = max(1, min(c, kern.PANEL_ELEMS // c))
    assert kern.mm_smem_bytes(c, block_m, panel) <= kern.SMEM_LIMIT
    assert (panel == c) == (c <= 90)


def test_cpu_tensors_launch_nothing_and_bindings_check_inputs():
    x = torch.randn(2, 30, 8)
    invertible_conv1x1(x, torch.eye(8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kern.conv1x1_mm(x.double(), torch.eye(8))
    with pytest.raises(ValueError, match="contiguous"):
        kern.conv1x1_gw(x, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="W must be"):
        kern.conv1x1_mm(x, torch.eye(7))
    with pytest.raises(ValueError, match="takes x"):
        invertible_conv1x1(x, torch.eye(7))
    assert all(k.launches == 0 for k in kern.KERNELS)
    assert common._libs == {}

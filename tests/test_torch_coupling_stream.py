"""The coupling row stream (``coupling_fwd`` / ``coupling_inv`` on whole rows
at the GLOW widths, ``csrc/coupling.cu``: ``coupling_rows_kernel``) on the
CPU: its arithmetic, its launch plan and the row op's gradient.

The row op computes the coupling layer's whole (B, M, C) output from its
whole input and conditioner output h.  Its plain versions
(``coupling_fwd_rows_ref`` / ``coupling_inv_rows_ref``) and the stream's
mirror (``coupling_stream_ref``, ld summed in the kernel's order: each lane
over its rows and then its coupled columns, the tile's lanes by a fixed
shuffle tree, the tiles of a batch as ``ld_reduce_kernel`` adds them) are
held against the reference's Pallas ``coupling_fwd`` / ``coupling_inv``
(interpret mode, as ``tests/test_kernels.py`` runs them on the CPU) joined
to the pass-through half by ``jnp.concatenate``, as the reference's layer
does (``src/repro/core/coupling.py:65-69``), at C = 12, 24, 48 with ragged
spatial extents, raw and t the two halves of one conditioner output.  Then
the Python mirrors of the launch (``kernels/coupling/coupling.py``): every
row computed once, the ld order (a lane-by-lane walk of the kernel's tiles
gives the mirror's ld bit for bit, whatever the grid), shared memory, and
the shape rule ``coupling_path``; and the row op's ``autograd.Function``
against ``jax.vjp`` of the reference's kernel-backed forward and its
concatenation.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, each with its reason:

* y / x in f32: 1e-4 absolute per element, the reference's own kernel bound;
* bf16: the f32-upcast values at rtol = atol = 2e-2 (the reference's bf16
  bound): both sides compute in f32 and round the output to bf16, which can
  land one bf16 ulp apart;
* ld: ``TOL_LD_REL``, 1e-5 of sum |log_s| (at least 1), as ``chip_smoke.py``
  holds ``coupling_fwd``: a sum of M*ca float32 terms taken in another
  order, which cancel for random raw;
* gradients: 1e-4 (rtol = atol), as ``tests/test_torch_coupling.py`` holds
  the half's custom VJP;
* the pass-through half: bit for bit.
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
from repro_torch.kernels.coupling.ops import (fused_coupling_fwd, fused_coupling_fwd_rows,
                                              fused_coupling_inv, fused_coupling_inv_rows)
from repro_torch.kernels.coupling.ref import (coupling_fwd_ref, coupling_fwd_rows_ref,
                                              coupling_inv_ref, coupling_inv_rows_ref,
                                              coupling_stream_ref)

torch.set_num_threads(2)
SEED = 20261017
TOL_LD_REL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: what a block may opt in to on an H100, and the shared memory of one SM
SMEM_OPT_IN, SMEM_PER_SM = 232448, 233472
#: C = 12, 24, 48, each with an M whose last tile is ragged and, at C = 48
#: (8-row tiles), more tiles a batch than ld_reduce_kernel's 32 lanes
SHAPES = [(2, 300, 12), (2, 100, 24), (2, 300, 48)]


def _inputs(b, m, c, seed):
    """Float32 numpy rows x (B, M, C) and the conditioner output h (B, M, C)
    whose halves are raw and t."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, m, c)).astype(np.float32),
            rng.standard_normal((b, m, c)).astype(np.float32))


def _f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _close(a, b, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def _ld_close(ld, ref, raw):
    scale = np.maximum(np.abs(2.0 * np.tanh(_f32(raw) / 2.0)).sum(axis=(1, 2)), 1.0)
    err = np.abs(_f32(ld) - _f32(ref)) / scale
    assert err.max() <= TOL_LD_REL, err.max()


def _reference_rows(x, h, dtype, inverse=False):
    """The reference's layer op on the same rows: its Pallas kernel on the
    first half (interpret mode), then ``jnp.concatenate`` with the second."""
    jdt = DTYPES[dtype][0]
    ca = x.shape[-1] // 2
    jx, jh = jnp.asarray(x).astype(jdt), jnp.asarray(h).astype(jdt)
    bm = pick_block_m(x.shape[1])
    if inverse:
        xa = j_coupling_inv(jx[..., :ca], jh[..., :ca], jh[..., ca:], block_m=bm, interpret=True)
        return jnp.concatenate([xa, jx[..., ca:]], axis=-1)
    ya, ld = j_coupling_fwd(jx[..., :ca], jh[..., :ca], jh[..., ca:], block_m=bm, interpret=True)
    return jnp.concatenate([ya, jx[..., ca:]], axis=-1), ld


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_forward_matches_the_reference(shape, dtype):
    x, h = _inputs(*shape, seed=SEED)
    tx, th = (torch.from_numpy(v).to(DTYPES[dtype][1]) for v in (x, h))
    ca = shape[-1] // 2
    assert ckern.coupling_path(tx, th[..., :ca], th[..., ca:]) == "rows"
    jy, jld = _reference_rows(x, h, dtype)
    y, ld = coupling_fwd_rows_ref(tx, th)
    assert y.dtype == tx.dtype and tuple(y.shape) == shape and ld.dtype == torch.float32
    _close(y, jy, dtype)
    _ld_close(ld, jld, th[..., :ca])
    ys, lds = coupling_stream_ref(tx, th)
    assert torch.equal(ys, y)
    _ld_close(lds, jld, th[..., :ca])
    # the op on the CPU is the plain row version, bit for bit
    yo, ldo = fused_coupling_fwd_rows(tx, th)
    assert torch.equal(yo, y) and torch.equal(ldo, ld)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_inverse_matches_the_reference(shape, dtype):
    # y is a forward output, so x comes back at the input's scale
    x0, h = _inputs(*shape, seed=SEED + 1)
    y0, _ = coupling_fwd_rows_ref(torch.from_numpy(x0), torch.from_numpy(h))
    ty, th = (torch.from_numpy(v).to(DTYPES[dtype][1]) for v in (y0.numpy(), h))
    x = coupling_inv_rows_ref(ty, th)
    assert x.dtype == ty.dtype and tuple(x.shape) == shape
    _close(x, _reference_rows(y0.numpy(), h, dtype, inverse=True), dtype)
    assert torch.equal(coupling_stream_ref(ty, th, inverse=True), x)
    assert torch.equal(fused_coupling_inv_rows(ty, th), x)
    if dtype == "float32":
        np.testing.assert_allclose(x.numpy(), x0, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [12, 24, 48, 7])
def test_pass_through_half_is_the_inputs_bit_for_bit(c, dtype, flip):
    """The half the coupling does not transform leaves the row op as it came
    in, and the row op is the layer's join of the half's result, bit for
    bit."""
    n = c - c // 2 if flip else c // 2
    rng = np.random.default_rng(c)
    tdt = DTYPES[dtype][1]
    x = torch.from_numpy(rng.standard_normal((2, 37, c)).astype(np.float32)).to(tdt)
    h = torch.from_numpy(rng.standard_normal((2, 37, 2 * n)).astype(np.float32)).to(tdt)
    keep = slice(0, c // 2) if flip else slice(c // 2, c)
    y, ld = coupling_fwd_rows_ref(x, h, flip=flip)
    back = coupling_inv_rows_ref(y, h, flip=flip)
    assert torch.equal(y[..., keep], x[..., keep]) and torch.equal(back[..., keep], x[..., keep])
    xa, xb, raw, t = ckern.row_halves(x, h, flip)
    ya, ld_half = fused_coupling_fwd(xa, raw, t)
    assert torch.equal(y, torch.cat([xb, ya] if flip else [ya, xb], dim=-1))
    assert torch.equal(ld, ld_half)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ca", [1, 6, 7])
def test_half_contract_is_the_row_op_with_nothing_passed_through(ca, dtype, flip):
    """An h of width 2 C makes all of x the transformed half, whichever half
    ``flip`` names: ``row_halves`` gives x whole and an empty pass-through
    half, ``join_rows`` the half itself, and the half wrappers (the row ops
    on h = (raw | t)) the half's plain versions bit for bit, with the
    gradient autograd takes through them."""
    rng = np.random.default_rng(ca)
    tdt = DTYPES[dtype][1]
    x, raw, t = (torch.from_numpy(rng.standard_normal((2, 29, ca)).astype(np.float32)).to(tdt)
                 for _ in range(3))
    h = torch.cat([raw, t], dim=-1)
    xa, xb, hr, ht = ckern.row_halves(x, h, flip)
    assert xa.shape == x.shape and xb.shape[-1] == 0 and torch.equal(xa, x)
    assert torch.equal(hr, raw) and torch.equal(ht, t)
    assert ckern.join_rows(xa, xb, flip) is xa
    y, ld = coupling_fwd_rows_ref(x, h, flip=flip)
    y_h, ld_h = coupling_fwd_ref(x, raw, t)
    assert torch.equal(y, y_h) and torch.equal(ld, ld_h)
    assert torch.equal(coupling_inv_rows_ref(y, h, flip=flip), coupling_inv_ref(y, raw, t))
    leaves = [v.float().requires_grad_() for v in (x, raw, t)]
    y_w, ld_w = fused_coupling_fwd(*leaves)
    assert torch.equal(y_w, coupling_fwd_ref(*leaves)[0]) and torch.equal(
        ld_w, coupling_fwd_ref(*leaves)[1])
    assert torch.equal(fused_coupling_inv(*leaves), coupling_inv_ref(*leaves))
    g = [torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) for v in (y_w, ld_w)]
    got = torch.autograd.grad((y_w * g[0]).sum() + (ld_w * g[1]).sum(), leaves)
    y_r, ld_r = coupling_fwd_ref(*leaves)
    want = torch.autograd.grad((y_r * g[0]).sum() + (ld_r * g[1]).sum(), leaves)
    for name, a, r in zip(("x", "raw", "t"), got, want):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("b,m", [(1, 1), (2, 7), (8, 300), (3, 1024), (8, 16384 // 16 + 5),
                                 (8, 16384), (8, 4096), (8, 1024)])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_coupling_walk_computes_every_row_once(c, b, m, grid):
    """Every (batch, row) lies in exactly one tile of one warp; a tile is at
    most ``coupling_rows_per_tile(c)`` rows of one batch, and tile starts are
    whole tiles into the batch (16-byte aligned in either storage type)."""
    seen = np.zeros((b, m), np.int64)
    walk = ckern.coupling_walk(b, m, c, grid)
    r = ckern.coupling_rows_per_tile(c)
    assert len(walk) == grid * ckern.COUPLING_PLAN[2]
    for tiles in walk:
        for bb, m0, m1 in tiles:
            assert 0 <= bb < b and 0 <= m0 < m1 <= m
            assert m1 - m0 <= r and m0 % r == 0
            assert m0 * c * 2 % 16 == 0
            seen[bb, m0:m1] += 1
    assert (seen == 1).all()
    assert sum(map(len, walk)) == b * ckern.coupling_tiles_per_batch(m, c)


def _ld_by_walk(raw, c, grid, clamp=2.0):
    """ld as the kernel takes it, walked lane by lane: each warp's tiles in
    its order (``coupling_walk``), each lane's rows and then coupled
    columns, the lanes' sums by the shuffle tree into the tile's partial,
    then per batch ``ld_reduce_kernel``'s order.  Scalar f32 arithmetic
    throughout."""
    b, m, ca = raw.shape
    k, rpl, _ = ckern.COUPLING_PLAN
    g, per, r = ca // k, ckern.coupling_tiles_per_batch(m, c), ckern.coupling_rows_per_tile(c)
    log_s = (clamp * torch.tanh(raw.float() / clamp)).numpy()
    partial = np.zeros((b, per), np.float32)
    for tiles in ckern.coupling_walk(b, m, c, grid):
        for bb, m0, m1 in tiles:
            lanes = np.zeros(32, np.float32)
            for lane in range(32):
                row0, j0 = (lane // g) * rpl, (lane % g) * k
                s = np.float32(0)
                for u in range(rpl):
                    if m0 + row0 + u < m1:
                        for j in range(k):
                            s = np.float32(s + log_s[bb, m0 + row0 + u, j0 + j])
                lanes[lane] = s
            for o in (16, 8, 4, 2, 1):
                lanes[:o] = lanes[:o] + lanes[o:2 * o]
            partial[bb, m0 // r] = lanes[0]
    ld = np.zeros(b, np.float32)
    for bb in range(b):
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            s = np.float32(0)
            for i in range(lane, per, 32):
                s = np.float32(s + partial[bb, i])
            lanes[lane] = s
        for o in (16, 8, 4, 2, 1):
            lanes[:o] = lanes[:o] + lanes[o:2 * o]
        ld[bb] = lanes[0]
    return ld


@pytest.mark.parametrize("shape", [(2, 300, 12), (2, 100, 24), (1, 300, 48), (2, 1100, 48)])
def test_stream_ld_is_summed_in_the_kernels_order(shape):
    """The mirror's ld is bit for bit the lane-by-lane walk's, and that walk
    gives the same bits for every grid: each tile's partial is a sum of its
    own rows, so the ld does not depend on which warp took the tile."""
    x, h = (torch.from_numpy(v) for v in _inputs(*shape, seed=SEED + 2))
    _, ld = coupling_stream_ref(x, h)
    for grid in (1, 5, 132):
        np.testing.assert_array_equal(ld.numpy(), _ld_by_walk(h[..., : shape[-1] // 2],
                                                              shape[-1], grid))


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_coupling_rows_block_fits_the_card(c, elem_size):
    """One row-stream block's shared memory fits what a block may opt in to,
    and at least two blocks fit an SM; a tile is a whole number of 16-byte
    copies; the lanes cover the coupled half of whole rows, every lane
    computing, each lane's columns a whole number of 4-byte words."""
    k, rpl, warps = ckern.COUPLING_PLAN
    smem = ckern.coupling_rows_smem_bytes(c, elem_size)
    assert smem <= SMEM_OPT_IN and 2 * (smem + 1024) <= SMEM_PER_SM
    assert ckern.coupling_rows_per_tile(c) * c * elem_size % 16 == 0
    assert (c // 2) % k == 0 and 32 % (c // 2 // k) == 0
    assert k * elem_size % 4 == 0
    assert warps * 32 <= 1024


def _rows(b, m, c, dtype=torch.float32):
    return torch.zeros(b, m, c, dtype=dtype), torch.zeros(b, m, c, dtype=dtype)


def _path(x, h, flip=False):
    _, _, raw, t = ckern.row_halves(x, h, flip)
    return ckern.coupling_path(x, raw, t, flip)


def test_coupling_path_rule():
    for c in common.STREAM_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            assert _path(*_rows(2, 40, c, dtype)) == "rows"
    # the second half coupled
    assert _path(*_rows(2, 40, 12), flip=True) == "tile"
    # other widths, an odd one among them
    for c in (6, 7, 8, 16, 96):
        x = torch.zeros(2, 40, c)
        assert _path(x, torch.zeros(2, 40, 2 * (c // 2))) == "tile"
    x, h = _rows(2, 40, 12)
    # raw and t two tensors, or not the two halves of one h, or swapped
    assert ckern.coupling_path(x, h[..., :6].contiguous(), h[..., 6:].contiguous()) == "tile"
    wide = torch.zeros(2, 40, 18)
    assert ckern.coupling_path(x, wide[..., :6], wide[..., 12:]) == "tile"
    assert ckern.coupling_path(x, h[..., 6:], h[..., :6]) == "tile"
    assert _path(x, wide[..., :12]) == "tile"
    # x not contiguous
    assert _path(torch.zeros(2, 12, 40).transpose(1, 2), h) == "tile"
    # x 4 bytes, h 8 bytes off a 16-byte boundary
    x_off = torch.zeros(2 * 40 * 12 + 1)[1:].view(2, 40, 12)
    assert _path(x_off, h) == "tile"
    h_off = torch.zeros(2 * 40 * 12 + 2)[2:].view(2, 40, 12)
    assert _path(x, h_off) == "tile"
    # bf16 at C = 12 with an odd M: every other batch's rows start 8 bytes off
    assert _path(*_rows(2, 41, 12, torch.bfloat16)) == "tile"
    assert _path(*_rows(1, 41, 12, torch.bfloat16)) == "rows"
    assert _path(*_rows(2, 41, 12)) == "rows"


def test_row_partials_and_kernels_per_call():
    """The forward's ld partials are (B, tiles a batch); the forward launches
    two kernels a call, the inverse one; both count their launches by
    path."""
    assert ckern.coupling_tiles_per_batch(16384, 12) == 512
    assert ckern.coupling_tiles_per_batch(4096, 24) == 256
    assert ckern.coupling_tiles_per_batch(1024, 48) == 128
    assert ckern.coupling_tiles_per_batch(300, 12) == 10
    assert ckern.KERNELS_PER_CALL == {"coupling_fwd": 2, "coupling_inv": 1}
    for k in (ckern.coupling_fwd, ckern.coupling_inv):
        assert set(k.launches_by_path) == {"rows", "tile"}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("m", [300, 28])
def test_row_op_gradient_matches_reference_vjp(m, flip):
    """The row op's ``autograd.Function`` (backward from the output side
    through ``fused_coupling_bwd``, the row cotangent split into its coupled
    and pass-through halves, h's cotangent as (graw | gt)) against
    ``jax.vjp`` of the reference's Pallas custom VJP in interpret mode
    followed by the layer's concatenation."""
    c = 12 if not flip else 13
    s = c // 2
    n = c - s if flip else s
    rng = np.random.default_rng(m + flip)
    x = rng.standard_normal((2, m, c)).astype(np.float32)
    h = rng.standard_normal((2, m, 2 * n)).astype(np.float32)
    gy = rng.standard_normal((2, m, c)).astype(np.float32)
    gld = rng.standard_normal(2).astype(np.float32)

    def ref(jx, jh):
        xa, xb = (jx[..., s:], jx[..., :s]) if flip else (jx[..., :s], jx[..., s:])
        ya, ld = _fwd_pallas(xa, jh[..., :n], jh[..., n:], 2.0, pick_block_m(m), True)
        return jnp.concatenate([xb, ya] if flip else [ya, xb], axis=-1), ld

    (jy, jld), vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(h))
    jgx, jgh = vjp((jnp.asarray(gy), jnp.asarray(gld)))
    tx, th = (torch.from_numpy(v).requires_grad_() for v in (x, h))
    y, ld = fused_coupling_fwd_rows(tx, th, flip=flip)
    assert y.grad_fn is not None and "FwdFn" in type(y.grad_fn).__name__
    np.testing.assert_allclose(_f32(y.detach()), _f32(jy), rtol=0, atol=1e-4)
    gx, gh = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                                 + (ld * torch.from_numpy(gld)).sum(), (tx, th))
    np.testing.assert_allclose(_f32(gx), _f32(jgx), rtol=1e-4, atol=1e-4, err_msg="gx")
    np.testing.assert_allclose(_f32(gh), _f32(jgh), rtol=1e-4, atol=1e-4, err_msg="gh")


def test_row_inverse_has_no_gradient_and_cpu_launches_nothing():
    x, h = (torch.from_numpy(v) for v in _inputs(2, 28, 12, SEED + 3))
    y = x.clone().requires_grad_()
    back = fused_coupling_inv_rows(y, h)
    with pytest.raises(NotImplementedError, match="no gradient"):
        back.sum().backward()
    assert all(k.launches == 0 for k in ckern.KERNELS)
    assert all(n == 0 for k in (ckern.coupling_fwd, ckern.coupling_inv)
               for n in k.launches_by_path.values())
    assert common._libs == {}


def test_row_bindings_refuse_what_the_kernels_do_not_take():
    """The row wrappers check their inputs before any library is loaded."""
    x, h = _rows(2, 40, 12)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ckern.coupling_fwd.rows(x.double(), h.double())
    with pytest.raises(ValueError, match="h must be"):
        ckern.coupling_inv.rows(x, h[..., :10])
    with pytest.raises(ValueError, match="rows must be"):
        ckern.coupling_fwd.rows(x[0], h[0])
    with pytest.raises(ValueError, match="h on meta"):
        ckern.coupling_fwd.rows(x, torch.zeros(2, 40, 12, device="meta"))
    assert common._libs == {}

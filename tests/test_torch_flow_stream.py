"""The flow-step stream kernels (``flowstep_fwd`` / ``flowstep_inv`` at the
GLOW widths, ``csrc/flowstep.cu``: ``flow_stream``) on the CPU: their
arithmetic and their launch plan.

``flowstep_stream_ref`` is the stream's arithmetic in plain PyTorch, with the
coupling logdet summed in the kernel's order (each lane over its rows and
columns, the tile's lanes by a fixed shuffle tree, the tiles of a batch as
``ld_reduce_kernel`` adds them).  It is held against the reference's Pallas
``flowstep_fwd`` / ``flowstep_inv`` (interpret mode, as
``tests/test_flowstep.py`` runs them on the CPU) and against the
reference's ``kernels/flowstep/ref.py``, at C = 12, 24, 48 with ragged
spatial extents, raw and t the two halves of one conditioner output, as
``GlowStepStack`` passes them.  Then the Python mirrors of the launch
(``kernels/flowstep/flowstep.py``): every row computed once, the ld order
(a lane-by-lane walk of the kernel's tiles gives the mirror's ld bit for
bit, whatever the grid), shared memory, and the shape rule
``flowstep_path``.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, each with its reason:

* y / x in f32: 1e-4 absolute per element, the reference's own kernel bound;
* bf16: the f32-upcast values at rtol = atol = 2e-2 (the reference's bf16
  bound in ``tests/test_flowstep.py``): both sides compute in f32 and round
  the output to bf16, which can land one bf16 ulp apart;
* ld: ``TOL_LD_REL``, 1e-5 of max(|ld|, 1), as ``chip_smoke.py`` holds the
  kernel: a sum of M*ca float32 terms taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pick_block_m
from repro.kernels.flowstep.flowstep import flowstep_fwd as j_flowstep_fwd
from repro.kernels.flowstep.flowstep import flowstep_inv as j_flowstep_inv
from repro.kernels.flowstep.ref import flowstep_fwd_ref as j_flowstep_fwd_ref
from repro.kernels.flowstep.ref import flowstep_inv_ref as j_flowstep_inv_ref
from repro_torch.kernels import common
from repro_torch.kernels.flowstep import flowstep as kern
from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_stream_ref

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
    """Float32 numpy inputs of one flow step: x, an_ls, an_b, W, and the
    conditioner output h (B, M, C) whose halves are raw and t."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, m, c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c) + np.eye(c)).astype(np.float32),
        rng.standard_normal((b, m, c)).astype(np.float32),
    )


def _torch(x, ls, ab, w, h, dtype):
    """The port's tensors: x and h in ``dtype``, raw and t views of h."""
    tdt = DTYPES[dtype][1]
    ca = x.shape[-1] // 2
    ht = torch.from_numpy(h).to(tdt)
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(ls), torch.from_numpy(ab),
            torch.from_numpy(w), ht[..., :ca], ht[..., ca:])


def _jax(x, ls, ab, w, h, dtype):
    jdt = DTYPES[dtype][0]
    ca = x.shape[-1] // 2
    return (jnp.asarray(x).astype(jdt), jnp.asarray(ls), jnp.asarray(ab), jnp.asarray(w),
            jnp.asarray(h[..., :ca]).astype(jdt), jnp.asarray(h[..., ca:]).astype(jdt))


def _f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _close(a, b, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def _ld_close(ld, ref):
    ref = _f32(ref)
    err = np.abs(_f32(ld) - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max() <= TOL_LD_REL, err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stream_forward_matches_the_reference(shape, dtype):
    arrays = _inputs(*shape, seed=SEED)
    x, ls, ab, w, raw, t = _torch(*arrays, dtype)
    assert kern.flowstep_path(x, raw, t) == "stream"
    y, ld = flowstep_stream_ref(x, ls, ab, w, raw, t)
    assert y.dtype == x.dtype and ld.dtype == torch.float32 and ld.shape == (shape[0],)
    jx, jls, jab, jw, jraw, jt = _jax(*arrays, dtype)
    jy, jld = j_flowstep_fwd(jx, jls, jab, jw, jraw, jt, block_m=pick_block_m(shape[1]),
                             interpret=True)
    _close(y, jy, dtype)
    _ld_close(ld, jld)
    jy_ref, jld_ref = j_flowstep_fwd_ref(jx, jls, jab, jw, jraw, jt)
    _close(y, jy_ref, dtype)
    _ld_close(ld, jld_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stream_inverse_matches_the_reference(shape, dtype):
    # y is a forward output, so x comes back at the input's scale
    x0, ls0, ab0, w0, h0 = _inputs(*shape, seed=SEED + 1)
    ca = shape[-1] // 2
    y0, _ = flowstep_fwd_ref(*(torch.from_numpy(a) for a in (x0, ls0, ab0, w0)),
                             torch.from_numpy(h0[..., :ca]), torch.from_numpy(h0[..., ca:]))
    arrays = (y0.numpy(), ls0, ab0, np.linalg.inv(w0).astype(np.float32), h0)
    y, ls, ab, wi, raw, t = _torch(*arrays, dtype)
    assert kern.flowstep_path(y, raw, t) == "stream"
    x = flowstep_stream_ref(y, ls, ab, wi, raw, t, inverse=True)
    assert x.dtype == y.dtype
    jy, jls, jab, jwi, jraw, jt = _jax(*arrays, dtype)
    jx = j_flowstep_inv(jy, jls, jab, jwi, jraw, jt, block_m=pick_block_m(shape[1]),
                        interpret=True)
    _close(x, jx, dtype)
    _close(x, j_flowstep_inv_ref(jy, jls, jab, jwi, jraw, jt), dtype)


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("b,m", [(1, 1), (2, 7), (8, 300), (3, 1024), (8, 16384 // 16 + 5),
                                 (8, 16384), (8, 4096), (8, 1024)])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_flow_walk_computes_every_row_once(c, b, m, grid):
    """Every (batch, row) lies in exactly one tile of one warp; a tile is at
    most ``stream_rows(c)`` rows of one batch, and tile starts are whole
    tiles into the batch (16-byte aligned in either storage type)."""
    seen = np.zeros((b, m), np.int64)
    walk = kern.flow_walk(b, m, c, grid)
    assert len(walk) == grid * kern.FLOW_PLAN[c][2]
    for tiles in walk:
        for bb, m0, m1 in tiles:
            assert 0 <= bb < b and 0 <= m0 < m1 <= m
            r = common.stream_rows(c, kern.FLOW_PLAN)
            assert m1 - m0 <= r and m0 % r == 0
            assert m0 * c * 2 % 16 == 0
            seen[bb, m0:m1] += 1
    assert (seen == 1).all()
    assert sum(map(len, walk)) == b * kern.flow_tiles_per_batch(m, c)


def _ld_by_walk(raw, c, grid, clamp=2.0):
    """ld as the kernel takes it, walked lane by lane: each warp's tiles in
    its order (``flow_walk``), each lane's rows and then columns, the lanes'
    sums by the shuffle tree into the tile's partial, then per batch
    ``ld_reduce_kernel``'s order.  Scalar f32 arithmetic throughout."""
    b, m, ca = raw.shape
    out, rpl, _ = kern.FLOW_PLAN[c]
    g, kc, per = c // out, min(out, c // 2), kern.flow_tiles_per_batch(m, c)
    log_s = (clamp * torch.tanh(raw.float() / clamp)).numpy()
    partial = np.zeros((b, per), np.float32)
    for tiles in kern.flow_walk(b, m, c, grid):
        for bb, m0, m1 in tiles:
            lanes = np.zeros(32, np.float32)
            for lane in range(32):
                row0, j0 = (lane // g) * rpl, (lane % g) * out
                if j0 >= ca:
                    continue
                s = np.float32(0)
                for u in range(rpl):
                    if m0 + row0 + u < m1:
                        for j in range(kc):
                            s = np.float32(s + log_s[bb, m0 + row0 + u, j0 + j])
                lanes[lane] = s
            for o in (16, 8, 4, 2, 1):
                lanes[:o] = lanes[:o] + lanes[o:2 * o]
            partial[bb, m0 // common.stream_rows(c, kern.FLOW_PLAN)] = lanes[0]
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
    x, ls, ab, w, raw, t = _torch(*_inputs(*shape, seed=SEED + 2), "float32")
    _, ld = flowstep_stream_ref(x, ls, ab, w, raw, t)
    for grid in (1, 5, 132):
        np.testing.assert_array_equal(ld.numpy(), _ld_by_walk(raw, shape[-1], grid))


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_flow_stream_block_fits_the_card(c, elem_size):
    """One stream block's shared memory fits what a block may opt in to, and
    at least two blocks fit an SM; a tile is a whole number of 16-byte
    copies; the lane layout covers whole rows."""
    out, rpl, warps = kern.FLOW_PLAN[c]
    smem = kern.flow_stream_smem_bytes(c, elem_size)
    assert smem <= SMEM_OPT_IN and 2 * (smem + 1024) <= SMEM_PER_SM
    assert common.stream_rows(c, kern.FLOW_PLAN) * c * elem_size % 16 == 0
    assert c % out == 0 and 32 % (c // out) == 0
    # a lane's columns are all coupled or none, or it holds the whole row
    assert out == c or (c // 2) % out == 0
    assert warps * 32 <= 1024


def _halves(b, m, c, dtype=torch.float32):
    h = torch.zeros(b, m, c, dtype=dtype)
    return torch.zeros(b, m, c, dtype=dtype), h[..., : c // 2], h[..., c // 2:]


def test_flowstep_path_rule():
    for c in common.STREAM_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            assert kern.flowstep_path(*_halves(2, 40, c, dtype)) == "stream"
    # other widths
    for c in (6, 8, 16, 96):
        assert kern.flowstep_path(*_halves(2, 40, c)) == "tile"
    # x 4 bytes off a 16-byte boundary
    x, raw, t = _halves(2, 40, 12)
    x_off = torch.zeros(2 * 40 * 12 + 1)[1:].view(2, 40, 12)
    assert kern.flowstep_path(x_off, raw, t) == "tile"
    # raw and t two tensors, or not next to each other, or swapped
    assert kern.flowstep_path(x, raw.contiguous(), t.contiguous()) == "tile"
    wide = torch.zeros(2, 40, 18)
    assert kern.flowstep_path(x, wide[..., :6], wide[..., 12:]) == "tile"
    assert kern.flowstep_path(x, t, raw) == "tile"
    # h's base 8 bytes off a 16-byte boundary
    h = torch.zeros(2 * 40 * 12 + 2)[2:].view(2, 40, 12)
    assert kern.flowstep_path(x, h[..., :6], h[..., 6:]) == "tile"
    # bf16 at C = 12 with an odd M: every other batch's rows start 8 bytes off
    assert kern.flowstep_path(*_halves(2, 41, 12, torch.bfloat16)) == "tile"
    assert kern.flowstep_path(*_halves(1, 41, 12, torch.bfloat16)) == "stream"
    assert kern.flowstep_path(*_halves(2, 41, 12)) == "stream"


def test_stream_partials_and_kernels_per_call():
    """The forward's ld partials are (B, tiles a batch); the forward launches
    two kernels a call on either path, the inverse one."""
    assert kern.flow_tiles_per_batch(16384, 12) == 512
    assert kern.flow_tiles_per_batch(4096, 24) == 128
    assert kern.flow_tiles_per_batch(1024, 48) == 128
    assert kern.flow_tiles_per_batch(300, 12) == 10
    assert kern.KERNELS_PER_CALL == {"flowstep_fwd": 2, "flowstep_inv": 1}
    assert kern.flowstep_fwd.launches_by_path == {"stream": 0, "tile": 0}
    assert kern.flowstep_inv.launches_by_path == {"stream": 0, "tile": 0}

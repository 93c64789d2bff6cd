"""The arithmetic and the launch plans of the redesigned ``wkv_scan`` and
``spine_bwd`` CUDA kernels, on the CPU.

``wkv_scan`` (``csrc/rwkv.cu``) keeps the state in register tiles and takes
y as ``r S + (r . (u k)) v`` with its partial sums added in a fixed order;
``wkv_tiled_ref`` is that arithmetic in plain PyTorch.  It is held against
the reference's Pallas ``wkv_scan`` (interpret mode) and its ``wkv_ref``,
and with an initial state against the reference's model-path
``repro.nn.ssm._wkv_scan``, at K = 16, 32, 64, with S not a multiple of the
kernel's 16-step stage and S = 1, for the reference's sigmoid decays and
rwkv6's.  ``spine_bwd``'s cluster kernel (``csrc/flowstep.cu``) sums gW on
the tensor cores in 3xTF32 and over the blocks of its launch plan;
``spine_tiled_ref`` emulates both and is held against the reference's Pallas
``spine_bwd`` (interpret mode) and its ``spine_bwd_ref``.  Then the Python
mirrors of both kernels' launches (``kernels/rwkv/rwkv.py``,
``kernels/flowstep/flowstep.py``): every state entry owned once, every row
summed once, shared memory, threads and registers within the card's.

Tolerances: the reference's scan-kernel bound (``tests/test_kernels.py:305``:
2e-4 rtol = atol in f32, 5e-2 in bf16); ``TOL_SCAN_SCALE``, 1e-4 of the
output's largest entry, at an rwkv-like shape, as ``chip_smoke.py`` holds
the kernel at the model's shapes; the flow step's, as
``tests/test_torch_bwd_kernels.py`` holds them: 1e-4 absolute in f32 and
rtol = atol = 2e-2 in bf16 per element, rtol = atol = 1e-4 (f32) and 5e-2
(bf16) for the sums over (b, m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pick_block_m
from repro.kernels.flowstep.flowstep import spine_bwd as j_spine_bwd
from repro.kernels.flowstep.ref import spine_bwd_ref as j_spine_bwd_ref
from repro.kernels.rwkv.rwkv import wkv_scan as j_wkv_scan
from repro.kernels.rwkv.ref import wkv_ref as j_wkv_ref
from repro.nn import ssm as jssm
from repro_torch.kernels.flowstep import flowstep as fkern
from repro_torch.kernels.flowstep.ref import spine_bwd_ref, spine_tiled_ref
from repro_torch.kernels.rwkv import rwkv as rkern
from repro_torch.kernels.rwkv.ref import wkv_ref, wkv_tiled_ref

torch.set_num_threads(4)
SEED = 20261017
SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TOL_SCAN_SCALE = 1e-4
TILE_TOL = {"float32": dict(rtol=0, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SUM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: one H100's SMs, the shared memory of one SM, what a block may opt in to,
#: the card's reserve a block, and the registers of an SM
N_SM, SMEM_PER_SM, SMEM_OPT_IN, SMEM_RESERVE = 132, 233472, 232448, 1024
REGS_PER_SM = 65536


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _pair(a, dtype: str = "float32"):
    """One numpy array as a JAX and a torch tensor of ``dtype`` (bf16 rounded
    once, in JAX, so both sides hold the same values)."""
    j = jnp.asarray(np.asarray(a, np.float32), DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


def _wkv_inputs(shape, rng, decay):
    """r, k, v standard normal; w = sigmoid(normal) (the reference's kernel
    test) or rwkv6's exp(-exp(-6 + normal)); u (H, K); a state0; numpy f32."""
    b, h, s, kd = shape
    r, k, v, z = (rng.standard_normal((b, h, s, kd)) for _ in range(4))
    w = 1 / (1 + np.exp(-z)) if decay == "sigmoid" else np.exp(-np.exp(z - 6.0))
    u = 0.1 * rng.standard_normal((h, kd))
    state0 = 0.5 * rng.standard_normal((b, h, kd, kd))
    return [a.astype(np.float32) for a in (r, k, v, w, u, state0)]


# (B, H, S, K): each head size with S a multiple of the 16-step stage, S not a
# multiple of it, and decode's S = 1
WKV_SHAPES = [(1, 2, 48, 16), (2, 2, 37, 16), (1, 3, 1, 16), (2, 2, 32, 32), (1, 2, 21, 32),
              (2, 3, 1, 32), (1, 2, 40, 64), (2, 1, 19, 64), (2, 2, 1, 64)]


@pytest.mark.parametrize("decay", ["sigmoid", "rwkv6"])
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wkv_tiled_matches_the_reference_kernel(shape, decay):
    """Without a state: ``wkv_tiled_ref`` against the reference's Pallas
    ``wkv_scan`` (interpret mode, one chunk of the whole S) and its
    ``wkv_ref``."""
    r, k, v, w, u, _ = _wkv_inputs(shape, np.random.default_rng(SEED), decay)
    jy, jst = j_wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=shape[2],
                         interpret=True)
    jy_ref, jst_ref = j_wkv_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    y, st = wkv_tiled_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    for got, want in ((y, jy), (st, jst), (y, jy_ref), (st, jst_ref)):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL["float32"])


@pytest.mark.parametrize("decay", ["sigmoid", "rwkv6"])
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wkv_tiled_carries_an_initial_state(shape, decay):
    """With a state: ``wkv_tiled_ref`` against the reference's model-path
    ``_wkv_scan`` on (B, S, H, K) views and the port's ``wkv_ref``."""
    r, k, v, w, u, state0 = _wkv_inputs(shape, np.random.default_rng(SEED + 1), decay)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, state0)]
    y, st = wkv_tiled_ref(*t)
    y_ref, st_ref = wkv_ref(*t)
    jy, jst = jssm._wkv_scan(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)),
                             jnp.asarray(u), jnp.asarray(state0))
    for got, want in ((y, y_ref), (st, st_ref), (y, np.asarray(jy).transpose(0, 2, 1, 3)),
                      (st, jst)):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL["float32"])


@pytest.mark.parametrize("shape", [(1, 2, 128, 16), (2, 4, 64, 32)], ids=["1x2x128x16", "2x4x64x32"])
def test_wkv_tiled_takes_bf16_inputs(shape):
    """bf16 r, k, v, w (widened to f32, as the kernel widens its stages)
    against the reference's Pallas ``wkv_scan`` on the same bf16 values, at
    the reference's kernel-test shapes (``tests/test_kernels.py:363``)."""
    r, k, v, w, u, _ = _wkv_inputs(shape, np.random.default_rng(SEED + 2), "sigmoid")
    (jr, tr), (jk, tk), (jv, tv), (jw, tw) = (_pair(a, "bfloat16") for a in (r, k, v, w))
    jy, jst = j_wkv_scan(jr, jk, jv, jw, jnp.asarray(u), chunk=32, interpret=True)
    y, st = wkv_tiled_ref(tr, tk, tv, tw, torch.from_numpy(u))
    for got, want in ((y, jy), (st, jst)):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL["bfloat16"])


def test_wkv_tiled_keeps_the_model_gate():
    """At an rwkv-like (2, 4, 512, 64) with rwkv6's decays and a state, the
    tiled arithmetic stays within 1e-4 of the output's scale of the
    step-by-step ``wkv_ref``."""
    r, k, v, w, u, state0 = _wkv_inputs((2, 4, 512, 64), np.random.default_rng(SEED + 3), "rwkv6")
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, state0)]
    y, st = wkv_tiled_ref(*t)
    y_ref, st_ref = wkv_ref(*t)
    for got, want in ((y, y_ref), (st, st_ref)):
        assert (got - want).abs().max().item() <= TOL_SCAN_SCALE * want.abs().max().item()


@pytest.mark.parametrize("kd", rkern.HEAD_SIZES)
def test_wkv_tiles_own_every_state_entry_once(kd):
    """The block's threads own each (i, j) of the K x K state exactly once;
    the 8 row groups of each column are lanes l, l ^ 4, ..., l ^ 28 of one
    warp (the kernel's shuffle sum: g ^ 4, then g ^ 2, then g ^ 1); after
    it the lanes of even row group hold column j0 + 2 hi + mid, which
    writes every column of y once."""
    owner = np.zeros((kd, kd), np.int64)
    tiles = rkern.wkv_tiles(kd)
    assert len(tiles) == rkern.wkv_threads(kd) and rkern.wkv_threads(kd) % 32 == 0
    for rows, cols in tiles:
        owner[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (owner == 1).all()
    written = np.zeros(kd, np.int64)
    for tid, (rows, cols) in enumerate(tiles):
        lane = tid % 32
        partners = {tiles[tid - lane + (lane ^ x)][0].start for x in range(0, 32, 4)}
        assert partners == set(range(0, kd, kd // 8))  # the 8 row groups, one warp
        if not (lane >> 2) & 1:
            written[cols.start + 2 * (lane >> 4) + ((lane >> 3) & 1)] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("kd", rkern.HEAD_SIZES)
def test_wkv_dot_lanes_cover_every_step_once(kd):
    """Each of a stage's 16 steps takes K / 8 consecutive lanes of one warp,
    whose 8-element slices cover the K elements of r . (u k) once."""
    seen = np.zeros((rkern.STAGE_STEPS, kd), np.int64)
    lanes = rkern.wkv_dot_lanes(kd)
    for tid, (step, elems) in enumerate(lanes):
        seen[step, elems.start:elems.stop] += 1
        assert tid // 32 == (tid - (tid % (kd // 8))) // 32  # a step's lanes share a warp
    assert (seen == 1).all()


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("kd", rkern.HEAD_SIZES)
def test_wkv_block_fits_the_card(kd, elem_size):
    """Shared memory under what a block may take; at rwkv6-7b's K = 64 four
    blocks (16 warps) to an SM in shared memory and in registers (at most
    128 a thread under the kernel's ``__launch_bounds__(2 K, 4)``).  That
    the build keeps within 128 registers without spilling is ptxas's to
    tell: ``chip_smoke.py``'s build phase checks its report."""
    smem = rkern.wkv_smem_bytes(kd, elem_size)
    assert smem <= SMEM_OPT_IN
    threads = rkern.wkv_threads(kd)
    assert threads <= 1024
    if kd == 64:
        assert 4 * (smem + SMEM_RESERVE) <= SMEM_PER_SM
        assert 4 * threads * 128 <= REGS_PER_SM


def _spine_inputs(b, m, c, rng, dtype):
    x2, gx2 = (rng.standard_normal((b, m, c)).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal((c, c)) / np.sqrt(c) + np.eye(c)).astype(np.float32)
    wi = np.linalg.inv(w).astype(np.float32)
    ls, bias = (0.1 * rng.standard_normal(c)).astype(np.float32), \
        (0.1 * rng.standard_normal(c)).astype(np.float32)
    (jx2, tx2), (jgx2, tgx2) = _pair(x2, dtype), _pair(gx2, dtype)
    return (jx2, jgx2, *map(jnp.asarray, (w, wi, ls, bias))), \
        (tx2, tgx2, *map(torch.from_numpy, (w, wi, ls, bias)))


# (B, M, C): each template width, with more rows than a slab and a ragged
# last block of the plan
SPINE_SHAPES = [(2, 300, 12), (2, 96, 24), (2, 160, 48), (3, 77, 12)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SPINE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_spine_tiled_matches_the_reference_kernel(shape, dtype):
    """``spine_tiled_ref`` under the cluster kernel's plan (16 clusters at
    most, as many as the rows allow) against the reference's Pallas
    ``spine_bwd`` (interpret mode) and its ``spine_bwd_ref``."""
    b, m, c = shape
    jargs, targs = _spine_inputs(b, m, c, np.random.default_rng(m + c), dtype)
    plan = fkern.spine_plan(b * m, c, 16)
    got = spine_tiled_ref(*targs, plan=plan)
    ref = j_spine_bwd(*jargs, block_m=pick_block_m(m), interpret=True)
    ref_plain = j_spine_bwd_ref(*jargs)
    assert got[0].dtype == got[1].dtype == targs[0].dtype
    for want in (ref, ref_plain):
        for name, a, r in zip(("x", "gx", "gW", "g_log_s", "g_b"), got, want):
            tol = SUM_TOL[dtype] if name in ("gW", "g_log_s", "g_b") else TILE_TOL[dtype]
            np.testing.assert_allclose(_np(a), _np(r), **tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spine_tiled_gw_keeps_the_sum_gate(dtype):
    """At the scanned GLOW's C = 48 scale cut to (2, 1024, 48), the 3xTF32
    gW summed as the plan sums it stays within ``TOL_SUM`` (1e-4 in f32, 5e-2
    in bf16) of the largest entry of the plain version's f32 gW, and the
    per-element outputs equal the plain version's."""
    b, m, c = 2, 1024, 48
    _, targs = _spine_inputs(b, m, c, np.random.default_rng(SEED + 4), dtype)
    got = spine_tiled_ref(*targs, plan=fkern.spine_plan(b * m, c, 16))
    ref = spine_bwd_ref(*targs)
    for a, r in zip(got[:2], ref[:2]):
        assert torch.equal(a, r)
    tol = SUM_TOL[dtype]["rtol"]
    for a, r in zip(got[2:], ref[2:]):
        assert (a - r).abs().max().item() <= tol * r.abs().max().item()


# (rows, C): the scanned GLOW's three scales, a ragged N, tiny and odd counts
PLAN_CASES = [(131072, 12), (32768, 24), (8192, 48), (2400, 12), (8 * 300, 24), (13, 48),
              (1, 12), (231, 24), (1000, 48)]


@pytest.mark.parametrize("max_clusters", [16, 9, 1])
@pytest.mark.parametrize("n_rows,c", PLAN_CASES)
def test_spine_plan_sums_every_row_once(n_rows, c, max_clusters):
    """The cluster kernel's blocks take every row exactly once, in slabs of
    whole 8-row steps no longer than the kernel's slab; no more clusters than
    the card holds at once, at most two blocks an SM, and a block's shared
    memory fits, in either storage type."""
    plan = fkern.spine_plan(n_rows, c, max_clusters)
    assert 1 <= plan["clusters"] <= min(max_clusters, fkern.SPINE_PLAN[c])
    assert plan["cluster_size"] == fkern.SPINE_CLUSTER
    assert plan["clusters"] * plan["cluster_size"] <= 2 * N_SM  # two blocks an SM
    assert plan["cta_rows"] % 8 == 0 and plan["slab_rows"] % 8 == 0
    assert plan["slab_rows"] <= min(plan["cta_rows"], fkern.spine_slab_rows(c))
    seen = np.zeros(n_rows, np.int64)
    for slabs in fkern.spine_walk(n_rows, plan):
        for r0, r1 in slabs:
            assert r0 < r1 <= n_rows and r1 - r0 <= plan["slab_rows"]
            seen[r0:r1] += 1
    assert (seen == 1).all()
    for elem_size in (4, 2):
        assert fkern.spine_cluster_smem_bytes(c, elem_size, plan["cluster_size"]) <= SMEM_OPT_IN


@pytest.mark.parametrize("c", fkern.SPINE_WIDTHS)
def test_spine_lanes_cover_each_slab(c):
    """One pass of the block's 8 warps covers a slab: C / 12 lanes a row,
    each 12 of its columns, every (row, column) once; the warps' (tile,
    group) pairs cover every 16 x 8 tile of gW over every 8-row step of the
    slab once; two blocks fit an SM in f32 and in bf16."""
    g = c // fkern.SPINE_OUT
    tr = fkern.spine_slab_rows(c)
    seen = np.zeros((tr, c), np.int64)
    for tid in range(fkern.THREADS):
        warp, lane = divmod(tid, 32)
        row, j0 = warp * (32 // g) + lane // g, (lane % g) * fkern.SPINE_OUT
        seen[row, j0:j0 + fkern.SPINE_OUT] += 1
    assert (seen == 1).all()
    nt = -(-c // 8)
    tiles, groups = -(-c // 16) * nt, fkern.spine_groups(c)
    products = np.zeros((tiles, tr // 8), np.int64)
    for warp in range(8):
        for pair in range(warp, tiles * groups, 8):
            tile, grp = pair % tiles, pair // tiles
            products[tile, grp::groups] += 1
    assert (products == 1).all()
    for es in (4, 2):
        assert 2 * (fkern.spine_cluster_smem_bytes(c, es, fkern.SPINE_CLUSTER)
                    + SMEM_RESERVE) <= SMEM_PER_SM


def test_spine_path_rule():
    """The cluster kernel at its widths with x2 and gx2 16-byte aligned; the
    tile kernel at any other width or alignment."""
    for c in fkern.SPINE_WIDTHS:
        x = torch.zeros(2, 5, c)
        assert fkern.spine_path(x, x) == "cluster"
        assert fkern.spine_path(x.to(torch.bfloat16), x.to(torch.bfloat16)) == "cluster"
        off = torch.zeros(2 * 5 * c + 1)[1:].view(2, 5, c)
        assert fkern.spine_path(off, x) == "tile" and fkern.spine_path(x, off) == "tile"
    for c in (6, 8, 16, 192):
        assert fkern.spine_path(torch.zeros(2, 5, c), torch.zeros(2, 5, c)) == "tile"
    assert fkern.spine_kernels_per_call("tile", None) == 2
    assert fkern.spine_kernels_per_call("cluster", {"clusters": 1}) == 1
    assert fkern.spine_kernels_per_call("cluster", {"clusters": 4}) == 2

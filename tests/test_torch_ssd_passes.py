"""The arithmetic and the plans of the redesigned CUDA kernels, on the CPU.

``ssd_scan`` (``csrc/ssd.cu``) runs SSD's chunked decomposition as five
passes; ``ssd_passes_ref`` is those passes in plain PyTorch.  Here it is held
against the port's sequential ``ssd_ref``, the reference's Pallas
``ssd_scan`` (interpret mode) and its ``ssd_ref``, and with an initial state
the reference's model-path ``_ssd_chunk_scan``, on small shapes: chunks that
are and are not multiples of the kernel's 64-row tiles, a prompt shorter than
the chunk, many chunks.  The kernel's products run on the tensor cores in
3xTF32; an emulation of its operand rounding shows that it keeps the model
shapes' gate and that single-pass TF32 would not.  Then the Python mirrors
of both kernels' launch plans (``ssd.py``, ``conv1x1.py``): every row summed
exactly once, scratch laid out without overlap, shared memory within the
card's.

Tolerances: the reference's kernel bound (``tests/test_kernels.py:305``:
2e-4 rtol = atol in f32) against the reference; ``TOL_SCAN_SCALE``, 1e-4 of
the output's largest entry, at the zamba2-like shape, as ``chip_smoke.py``
holds the kernel at the model's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import mamba2_ssd as j_mamba2_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.nn import ssm as jssm
from repro_torch.kernels.common import product_3xtf32, tf32_round
from repro_torch.kernels.conv1x1 import conv1x1 as ckern
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_passes_ref, ssd_ref

torch.set_num_threads(4)
SEED = 20261017
TOL = dict(rtol=2e-4, atol=2e-4)
TOL_SCAN_SCALE = 1e-4
#: one H100's SMs and the shared memory of one SM (a block takes at most
#: SMEM_OPT_IN of it, and the card reserves 1 KB a block)
N_SM, SMEM_PER_SM = 132, 233472


def _inputs(shape, rng, model_like=False):
    """x (B, H, S, P), da, dt (B, H, S), b_in, c_in (B, S, N), state0, as
    numpy f32: the reference's kernel-test inputs, or zamba2's init (dt =
    softplus(normal + softplus^-1(0.01)), da = dt A, A = -linspace(1, 16, H))."""
    b, h, s, p, n = shape
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    if model_like:
        dt = np.log1p(np.exp(rng.standard_normal((b, h, s)) + np.log(np.expm1(0.01))))
        da = dt * -np.linspace(1.0, 16.0, h)[None, :, None]
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, h, s))))
        da = -dt * np.exp(0.2 * rng.standard_normal((b, h, s)))
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state0 = (0.5 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    return x, da.astype(np.float32), dt.astype(np.float32), b_in, c_in, state0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, H, S, P, N, chunk): the reference's kernel-test shape, a chunk of 48
# (no multiple of the 64-row tile), a chunk of 100 (a whole and a ragged
# tile), a prompt shorter than the chunk, and many small chunks
PASS_SHAPES = [(1, 2, 256, 16, 16, 64), (2, 3, 96, 16, 8, 48), (1, 2, 200, 8, 16, 100),
               (2, 2, 12, 16, 16, 256), (1, 3, 160, 20, 12, 16)]


@pytest.mark.parametrize("shape", PASS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_passes_match_the_reference_kernel(shape):
    """Without a state: the passes against the reference's Pallas
    ``ssd_scan`` (interpret mode), its ``ssd_ref`` and the port's."""
    *dims, chunk = shape
    x, da, dt, b_in, c_in, _ = _inputs(dims, np.random.default_rng(SEED))
    c = skern.check_chunk(dims[2], chunk)
    jy, jst = j_mamba2_ssd(*(jnp.asarray(a) for a in (x, da, dt, b_in, c_in)), chunk=chunk)
    jy_ref, jst_ref = j_ssd_ref(*(jnp.asarray(a) for a in (x, da, dt, b_in, c_in)))
    y, st = ssd_passes_ref(*_t(x, da, dt, b_in, c_in), c)
    y_ref, st_ref = ssd_ref(*_t(x, da, dt, b_in, c_in))
    for got, want in ((y, jy), (st, jst), (y, jy_ref), (st, jst_ref), (y, y_ref), (st, st_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", PASS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_passes_carry_an_initial_state(shape):
    """With a state: the passes against the port's ``ssd_ref`` and the
    reference's ``_ssd_chunk_scan`` on (B, S, H, .) views."""
    *dims, chunk = shape
    x, da, dt, b_in, c_in, state0 = _inputs(dims, np.random.default_rng(SEED + 1))
    c = skern.check_chunk(dims[2], chunk)
    y, st = ssd_passes_ref(*_t(x, da, dt, b_in, c_in), c, torch.from_numpy(state0))
    y_ref, st_ref = ssd_ref(*_t(x, da, dt, b_in, c_in, state0))
    jy, jst = jssm._ssd_chunk_scan(
        jnp.asarray(x.transpose(0, 2, 1, 3)), jnp.asarray(da.transpose(0, 2, 1)),
        jnp.asarray(dt.transpose(0, 2, 1)), jnp.asarray(b_in), jnp.asarray(c_in),
        jnp.asarray(state0), chunk=c)
    for got, want in ((y, y_ref), (st, st_ref), (y, np.asarray(jy).transpose(0, 2, 1, 3)),
                      (st, jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _product_3xtf32(a, b):
    """The kernel's product: each operand split into a TF32 hi and lo,
    a_lo b_hi + a_hi b_lo + a_hi b_hi, each product exact (float64 here)."""
    return product_3xtf32(a, b)


def _product_tf32(a, b):
    return torch.matmul(tf32_round(a).double(), tf32_round(b).double()).float()


@pytest.mark.parametrize("product,within", [(_product_3xtf32, True), (_product_tf32, False)],
                         ids=["3xtf32", "tf32"])
def test_tensor_core_rounding_keeps_the_model_gate(product, within):
    """At a zamba2-like (1, 4, 512, 64, 64, 256) with zamba2's decays and a
    state, the passes with the kernel's 3xTF32 operands stay within 1e-4 of
    the output's scale of ``ssd_ref``; with single-pass TF32 they do not."""
    x, da, dt, b_in, c_in, state0 = _inputs((1, 4, 512, 64, 64), np.random.default_rng(SEED + 2),
                                            model_like=True)
    y_ref, st_ref = ssd_ref(*_t(x, da, dt, b_in, c_in, state0))
    y, st = ssd_passes_ref(*_t(x, da, dt, b_in, c_in), 256, torch.from_numpy(state0),
                           product=product)
    rel = max(((y - y_ref).abs().max() / y_ref.abs().max()).item(),
              ((st - st_ref).abs().max() / st_ref.abs().max()).item())
    assert (rel <= TOL_SCAN_SCALE) == within, rel


# (B, H, S, chunk): zamba2-7b's prefill, the card tests' shapes
PLAN_SHAPES = [(8, 112, 2048, 256), (2, 8, 2048, 256), (2, 3, 96, 48), (2, 2, 12, 256),
               (1, 2, 200, 100), (1, 3, 160, 16)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_output_pass_writes_every_row_once(shape):
    """``ssd_out_kernel``'s blocks (heaviest row tile first) write every (batch,
    head, time) row exactly once, each from the source rows of its chunk up to
    its own last row, every one of them exactly once."""
    b, h, s, chunk = shape
    c = skern.check_chunk(s, chunk)
    k = s // c
    if b * h * s > 1 << 16:
        b, h = 1, 2  # the decoding repeats over (batch, head): a slice of it
    seen = np.zeros((b, h, s), np.int64)
    blocks = skern.out_blocks(h, k, b, c)
    tiles = skern.tiles_of(c)
    assert [blk[3] for blk in blocks[:tiles]] == list(range(tiles - 1, -1, -1))
    for bb, hh, kk, r in blocks:
        rows, sources = skern.out_rows(c, kk, r)
        seen[bb, hh, rows.start:rows.stop] += 1
        covered = np.zeros(s, np.int64)
        for src in sources:
            covered[src.start:src.stop] += 1
        assert (covered[kk * c:rows.stop] == 1).all() and covered.sum() == rows.stop - kk * c
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_scratch_is_laid_out_without_overlap(shape):
    """The passes' scratch arrays follow each other, each 64-float (256-byte)
    aligned, with the sizes the kernels index; at zamba2-7b's prefill the
    chunk states are the 117 MB of (8, 112, 8, 64, 64) f32."""
    b, h, s, chunk = shape
    c = skern.check_chunk(s, chunk)
    parts = skern.ssd_scratch(b, h, s, c)
    assert list(parts) == ["cum", "cuml", "dts", "bp", "bt", "ct", "g0t", "states", "falls"]
    end = 0
    for off, size in parts.values():
        assert off == end and off % 64 == 0 and size % 64 == 0 and size > 0
        end = off + size
    tiles = skern.tiles_of(c)
    assert parts["g0t"][1] == b * (s // c) * tiles * (tiles + 1) // 2 * 64 * 64
    assert parts["states"][1] == b * h * (s // c) * 64 * 64
    if shape == PLAN_SHAPES[0]:
        assert 4 * parts["states"][1] == 117_440_512


@pytest.mark.parametrize("elem_size", [4, 2])
def test_ssd_product_blocks_fit_three_to_an_sm(elem_size):
    """The two product kernels' shared memory: under what a block may take,
    and (f32, the models' type) three blocks to an SM."""
    for smem in skern.ssd_smem_bytes(elem_size).values():
        assert smem <= ckern.SMEM_OPT_IN
        if elem_size == 4:
            assert 3 * (smem + 1024) <= SMEM_PER_SM


# (rows, C, element size): the unrolled GLOW's three widths in f32 and bf16,
# a ragged N that leaves a cluster partly empty, tiny and odd row counts
GW_CASES = [(131072, 12, 4), (131072, 12, 2), (32768, 24, 4), (32768, 24, 2), (8192, 48, 4),
            (8192, 48, 2), (602, 12, 4), (13, 48, 2), (77 * 3, 24, 2), (1, 12, 4), (1000, 48, 4)]


@pytest.mark.parametrize("n_rows,c,elem_size", GW_CASES)
def test_gw_plan_sums_every_row_once(n_rows, c, elem_size):
    """The cluster kernel's blocks sum every row exactly once (every slice
    walks the same rows), in slabs of whole 8-row steps that fit the ring;
    the grid has no more blocks than SMs, whole clusters, and its shared
    memory fits a block."""
    plan = ckern.gw_plan(n_rows, c, elem_size, N_SM)
    assert plan["slices"] * plan["xw"] == c and plan["xw"] % 4 == 0
    assert plan["cta_rows"] % 8 == 0 and plan["slab_rows"] % 8 == 0
    assert plan["slab_rows"] <= plan["cta_rows"]
    assert plan["slab_rows"] * (plan["xw"] + c) * elem_size <= max(
        ckern.GW_STAGE_BYTES, 8 * (plan["xw"] + c) * elem_size)
    assert plan["slices"] * plan["clusters"] * plan["cluster_size"] <= N_SM
    assert plan["cluster_size"] in (1, 2, 4, 8, 16)
    seen = np.zeros(n_rows, np.int64)
    for slabs in ckern.gw_walk(n_rows, plan):
        for r0, r1 in slabs:
            assert r0 < r1 <= n_rows and r1 - r0 <= plan["slab_rows"]
            seen[r0:r1] += 1
    assert (seen == 1).all()
    smem = ckern.gw_cluster_smem_bytes(c, plan["xw"], plan["slab_rows"], elem_size,
                                       plan["cluster_size"])
    assert smem <= ckern.SMEM_OPT_IN


def test_gw_path_rule():
    """The cluster kernel at the stream widths with both operands 16-byte
    aligned; the per-chunk partials at any other width or alignment."""
    for c in ckern.STREAM_WIDTHS:
        x = torch.zeros(2, 5, c)
        assert ckern.gw_path(x, x) == "cluster"
        assert ckern.gw_path(x.to(torch.bfloat16), x.to(torch.bfloat16)) == "cluster"
        off = torch.zeros(2 * 5 * c + 1)[1:].view(2, 5, c)
        assert ckern.gw_path(off, x) == "panel" and ckern.gw_path(x, off) == "panel"
    for c in (8, 16, 192):
        assert ckern.gw_path(torch.zeros(2, 5, c), torch.zeros(2, 5, c)) == "panel"

"""The coupling backward on whole rows (``coupling_bwd`` on the backward's row
stream, ``csrc/coupling.cu``: ``coupling_bwd_rows_kernel``) on the CPU: its
arithmetic, its launch plan and its callers.

The row op takes the layer's output row y, its conditioner output h and the
row cotangent gy, and writes the backward's whole rows: x (the rebuilt
input row), gx (the cotangent of x, with gy's pass-through half, to which
the caller adds the conditioner's cotangent in place) and gh = (graw | gt),
the cotangent of h.  Its plain version ``coupling_bwd_rows_ref`` is held
against the reference's Pallas ``coupling_bwd`` (interpret mode, as
``tests/test_kernels.py`` runs it on the CPU) joined to the pass-through
halves by ``jnp.concatenate``, at C = 12, 24, 48 with ragged spatial
extents, h whole as the layer passes it.  Then the Python mirrors of the
launch (``kernels/coupling/coupling.py``): every row computed once, shared
memory, and the shape rule ``coupling_path`` for the backward; and the
callers that take the rows, ``AffineCoupling.fused_bwd`` and
``GlowStepStack._step_bwd``, against ``jax.vjp`` of the reference's layer
and step.  The kernel itself runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances, each with its reason:

* x, gx, gh in f32: 1e-4 absolute per element, the reference's own kernel
  bound;
* bf16: the f32-upcast values at rtol = atol = 2e-2 (the reference's bf16
  bound): both sides compute in f32 and round each output to bf16, which
  can land one bf16 ulp apart;
* the layer's and the step's rebuilt input and every cotangent: 1e-4
  absolute, the reference's grad-parity bound (``tests/test_flowstep.py``);
* the pass-through halves and the joins the callers made before: bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coupling import AffineCoupling as JAffineCoupling
from repro.kernels.common import pick_block_m
from repro.kernels.coupling.coupling import coupling_bwd as j_coupling_bwd
from repro.nn.nets import CouplingCNN as JCouplingCNN
from repro_torch.bridge import params_from_numpy
from repro_torch.core.coupling import AffineCoupling
from repro_torch.kernels import common
from repro_torch.kernels.coupling import coupling as ckern
from repro_torch.kernels.coupling.ops import fused_coupling_bwd_rows
from repro_torch.kernels.coupling.ref import coupling_bwd_ref, coupling_bwd_rows_ref
from repro_torch.nn.nets import CouplingCNN
from torch_parity import SEED, make_pair, perturbed, to_jax

torch.set_num_threads(2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: what a block may opt in to on an H100, and the shared memory of one SM
SMEM_OPT_IN, SMEM_PER_SM = 232448, 233472
#: C = 12, 24, 48, each with an M whose last tile is ragged
SHAPES = [(2, 300, 12), (2, 100, 24), (2, 300, 48)]


def _inputs(b, m, c, seed):
    """Float32 numpy y, h, gy (B, M, C) and gld (B,)."""
    rng = np.random.default_rng(seed)
    return (*(rng.standard_normal((b, m, c)).astype(np.float32) for _ in range(3)),
            rng.standard_normal(b).astype(np.float32))


def _f32(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _close(a, b, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def _reference_rows(y, h, gy, gld, dtype):
    """The reference's backward on the same rows: its Pallas kernel on the
    first half (interpret mode), then ``jnp.concatenate`` of x, gx and gh as
    its layer joins them."""
    jdt = DTYPES[dtype][0]
    ca = y.shape[-1] // 2
    jy, jh, jg = (jnp.asarray(v).astype(jdt) for v in (y, h, gy))
    xa, gxa, graw, gt = j_coupling_bwd(jy[..., :ca], jh[..., :ca], jh[..., ca:], jg[..., :ca],
                                       jnp.asarray(gld), block_m=pick_block_m(y.shape[1]),
                                       interpret=True)
    return (jnp.concatenate([xa, jy[..., ca:]], axis=-1),
            jnp.concatenate([gxa, jg[..., ca:]], axis=-1),
            jnp.concatenate([graw, gt], axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rows_backward_matches_the_reference(shape, dtype):
    y, h, gy, gld = _inputs(*shape, seed=SEED)
    ty, th, tg = (torch.from_numpy(v).to(DTYPES[dtype][1]) for v in (y, h, gy))
    tgld = torch.from_numpy(gld)
    ca = shape[-1] // 2
    assert ckern.coupling_path(ty, th[..., :ca], th[..., ca:], gy=tg) == "rows"
    got = coupling_bwd_rows_ref(ty, th, tg, tgld)
    for name, a, r in zip(("x", "gx", "gh"), got, _reference_rows(y, h, gy, gld, dtype)):
        assert a.dtype == ty.dtype and tuple(a.shape) == shape, name
        _close(a, r, dtype)
    x, gx, gh = got
    # the pass-through halves move as they are; gt is gy's coupled half
    assert torch.equal(x[..., ca:], ty[..., ca:]) and torch.equal(gx[..., ca:], tg[..., ca:])
    assert torch.equal(gh[..., ca:], tg[..., :ca])
    # the op on the CPU is the plain row version, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(fused_coupling_bwd_rows(ty, th, tg, tgld), got))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [12, 24, 48, 7])
def test_rows_are_the_joins_the_callers_made(c, dtype, flip):
    """The row version is bit for bit what its callers computed from the
    half's results before: x = the half's x joined to y's pass-through half,
    gx = the half's gx joined to gy's, gh = ``cat(graw, gt)``; with an h 2 C
    wide, the half's own results."""
    n = c - c // 2 if flip else c // 2
    rng = np.random.default_rng(c + 10 * flip)
    tdt = DTYPES[dtype][1]
    y, gy = (torch.from_numpy(rng.standard_normal((2, 37, c)).astype(np.float32)).to(tdt)
             for _ in range(2))
    h = torch.from_numpy(rng.standard_normal((2, 37, 2 * n)).astype(np.float32)).to(tdt)
    gld = torch.from_numpy(rng.standard_normal(2).astype(np.float32))
    ya, yb, raw, t = ckern.row_halves(y, h, flip)
    gya, gyb, _, _ = ckern.row_halves(gy, h, flip)
    xa, gxa, graw, gt = coupling_bwd_ref(ya, raw, t, gya, gld)
    x, gx, gh = coupling_bwd_rows_ref(y, h, gy, gld, flip=flip)
    join = (lambda a, b: torch.cat([b, a] if flip else [a, b], dim=-1))
    assert torch.equal(x, join(xa, yb)) and torch.equal(gx, join(gxa, gyb))
    assert torch.equal(gh, torch.cat([graw, gt], dim=-1))
    whole = torch.from_numpy(rng.standard_normal((2, 37, 2 * c)).astype(np.float32)).to(tdt)
    xw, gxw, ghw = coupling_bwd_rows_ref(y, whole, gy, gld, flip=flip)
    ref = coupling_bwd_ref(y, whole[..., :c], whole[..., c:], gy, gld)
    assert torch.equal(xw, ref[0]) and torch.equal(gxw, ref[1])
    assert torch.equal(ghw, torch.cat(ref[2:], dim=-1))


@pytest.mark.parametrize("grid", [1, 5, 132 * 3])
@pytest.mark.parametrize("b,m", [(1, 1), (2, 7), (8, 300), (8, 16384), (8, 4096), (8, 1024)])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_backward_walk_computes_every_row_once(c, b, m, grid):
    """The backward's stream walks the forward's tiles (``coupling_walk``):
    every (batch, row) in exactly one tile of one warp, a tile at most
    ``coupling_rows_per_tile(c)`` rows of one batch, 16-byte aligned in
    either storage type, whatever the grid the occupancy gives."""
    seen = np.zeros((b, m), np.int64)
    r = ckern.coupling_rows_per_tile(c)
    for tiles in ckern.coupling_walk(b, m, c, grid):
        for bb, m0, m1 in tiles:
            assert m1 - m0 <= r and m0 % r == 0 and m0 * c * 2 % 16 == 0
            seen[bb, m0:m1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("c", common.STREAM_WIDTHS)
def test_backward_block_fits_the_card(c, elem_size):
    """One backward block holds each warp's 2 stages of (y | h | gy) tiles:
    72 KB in f32 at every width (R * C = 384), so three blocks share an SM
    (with the 1 KB the card reserves a block), half that in bf16."""
    k, rpl, warps = ckern.COUPLING_PLAN
    r = ckern.coupling_rows_per_tile(c)
    smem = ckern.coupling_bwd_rows_smem_bytes(c, elem_size)
    assert smem == warps * 2 * 3 * r * c * elem_size == 3 * ckern.coupling_rows_smem_bytes(
        c, elem_size) // 2
    assert r * c == 384 and smem == 384 * 48 * elem_size
    assert smem <= SMEM_OPT_IN and 3 * (smem + 1024) <= SMEM_PER_SM


def _rows(b, m, c, dtype=torch.float32):
    return tuple(torch.zeros(b, m, c, dtype=dtype) for _ in range(3))


def _bwd_path(y, h, gy, flip=False):
    _, _, raw, t = ckern.row_halves(y, h, flip)
    return ckern.coupling_path(y, raw, t, flip, gy)


def test_backward_path_rule():
    """The forward's rule, and the row cotangent gy a contiguous (B, M, C)
    tensor of y's dtype on a 16-byte boundary."""
    for c in common.STREAM_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            assert _bwd_path(*_rows(2, 40, c, dtype)) == "rows"
    y, h, gy = _rows(2, 40, 12)
    # the second half coupled; another width
    assert _bwd_path(y, h, gy, flip=True) == "tile"
    assert _bwd_path(*_rows(2, 40, 16)) == "tile"
    # gy: a transposed view, an expanded one, 4 bytes off, another dtype,
    # another shape
    assert _bwd_path(y, h, torch.zeros(2, 12, 40).transpose(1, 2)) == "tile"
    assert _bwd_path(y, h, torch.zeros(1, 1, 12).expand(2, 40, 12)) == "tile"
    assert _bwd_path(y, h, torch.zeros(2 * 40 * 12 + 1)[1:].view(2, 40, 12)) == "tile"
    assert _bwd_path(y, h, gy.to(torch.bfloat16)) == "tile"
    assert ckern.coupling_path(y, h[..., :6], h[..., 6:], gy=gy[:, :20]) == "tile"
    # y or h off 16 bytes, h not the halves of one tensor
    assert _bwd_path(torch.zeros(2 * 40 * 12 + 2)[2:].view(2, 40, 12), h, gy) == "tile"
    assert _bwd_path(y, torch.zeros(2 * 40 * 12 + 1)[1:].view(2, 40, 12), gy) == "tile"
    wide = torch.zeros(2, 40, 18)
    assert ckern.coupling_path(y, wide[..., :6], wide[..., 12:], gy=gy) == "tile"
    # bf16 at C = 12 with an odd M: every other batch's rows start 8 bytes off
    assert _bwd_path(*_rows(2, 41, 12, torch.bfloat16)) == "tile"
    assert _bwd_path(*_rows(1, 41, 12, torch.bfloat16)) == "rows"
    assert set(ckern.coupling_bwd.launches_by_path) == {"rows", "tile"}


def test_backward_rows_refuse_what_the_kernels_do_not_take():
    """The backward's row wrapper checks its inputs before any library is
    loaded, and the CPU path launches nothing."""
    y, h, gy = _rows(2, 40, 12)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ckern.coupling_bwd.rows(y.double(), h.double(), gy.double(), torch.ones(2))
    with pytest.raises(ValueError, match="gy must be"):
        ckern.coupling_bwd.rows(y, h, gy[:, :20], torch.ones(2))
    with pytest.raises(ValueError, match="gy must be"):
        ckern.coupling_bwd.rows(y, h, gy.to(torch.bfloat16), torch.ones(2))
    with pytest.raises(ValueError, match="gld"):
        ckern.coupling_bwd.rows(y, h, gy, torch.ones(3))
    with pytest.raises(ValueError, match="h must be"):
        ckern.coupling_bwd.rows(y, h[..., :10], gy, torch.ones(2))
    with pytest.raises(ValueError, match="gy on meta"):
        ckern.coupling_bwd.rows(y, h, torch.zeros(2, 40, 12, device="meta"), torch.ones(2))
    fused_coupling_bwd_rows(y, h, gy, torch.ones(2))
    assert ckern.coupling_bwd.launches == 0
    assert all(n == 0 for n in ckern.coupling_bwd.launches_by_path.values())
    assert common._libs == {}


def _floats(tree):
    """The float leaves of a tree, and a function that puts them back."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keep = [jnp.issubdtype(a.dtype, jnp.floating) for a in leaves]
    fl = [a for a, k in zip(leaves, keep) if k]

    def merge(new):
        it = iter(new)
        return jax.tree_util.tree_unflatten(treedef, [next(it) if k else a
                                                      for a, k in zip(leaves, keep)])

    return fl, merge


@pytest.mark.parametrize("kernel_training", [True, False])
@pytest.mark.parametrize("c,flip", [(12, False), (24, False), (13, True)])
def test_affine_coupling_fused_bwd_matches_reference_vjp(c, flip, kernel_training):
    """``AffineCoupling.fused_bwd`` (the rows op, the conditioner's VJP, its
    cotangent added into gx's pass-through half) against ``jax.vjp`` of the
    reference layer's forward, on one perturbed parameter tree: the rebuilt
    input, gx and every parameter's cotangent at 1e-4."""
    hidden, shape = 8, (2, 4, 5, c)
    jlayer = JAffineCoupling(lambda d_out: JCouplingCNN(d_out, hidden=hidden), flip=flip,
                             kernel_training=kernel_training)
    rng = np.random.default_rng(c + flip)
    x = rng.standard_normal(shape).astype(np.float32)
    tree = jlayer.init(jax.random.PRNGKey(c), jnp.asarray(x))
    tree = perturbed(jax.tree_util.tree_map(np.asarray, tree), rng, scale=0.3, stacked=False)
    jtree = to_jax(tree)
    (jy, jld), vjp = jax.vjp(lambda p, xx: jlayer.forward(p, xx), jtree, jnp.asarray(x))
    gy = rng.standard_normal(shape).astype(np.float32)
    gld = rng.standard_normal(shape[0]).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(gy), jnp.asarray(gld)))

    ca = c - c // 2 if flip else c // 2
    layer = AffineCoupling(CouplingCNN(c - ca, 2 * ca, hidden, device="cpu"), flip=flip,
                           kernel_training=kernel_training)
    params_from_numpy(layer, tree)
    xr, gx, gp, gcond = layer.fused_bwd(torch.from_numpy(np.array(jy)), torch.from_numpy(gy),
                                        torch.from_numpy(gld))
    assert gcond is None
    np.testing.assert_allclose(_f32(xr), x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(gx), _f32(jgx), rtol=0, atol=1e-4)
    for conv in ("conv1", "conv2", "conv3"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_f32(gp[f"net.{conv}.{leaf}"]),
                                       _f32(jgp["net"][conv][leaf]), rtol=0, atol=1e-4,
                                       err_msg=f"{conv}.{leaf}")


@pytest.mark.parametrize("layer,i", [(2, 0), (2, 1), (5, 1)])
def test_step_bwd_matches_reference_vjp(layer, i):
    """``GlowStepStack._step_bwd`` (the rows op, the conditioner's VJP, its
    cotangent added into gx2 in place, ``spine_bwd``) against ``jax.vjp`` of
    the reference's ``_step_fwd`` on the same step's parameters, at C = 12
    and 24: the rebuilt input, gx and every float leaf's cotangent at
    1e-4."""
    jflow, jparams, flow, _ = make_pair(dict(n_scales=2, k_steps=2, hidden=8), (2, 8, 8, 3))
    jstack, stack = jflow.layers[layer].layer, flow.layers[layer].layer
    c = 12 if layer == 2 else 24
    shape = (2, 4, 4, c) if layer == 2 else (2, 2, 2, c)
    p_i = jax.tree_util.tree_map(lambda a: a[i], jparams[layer])
    floats, merge = _floats(p_i)
    rng = np.random.default_rng(layer + i)
    x = rng.standard_normal(shape).astype(np.float32)
    (jy, jld), vjp = jax.vjp(lambda fl, xx: jstack._step_fwd(merge(fl), xx, None), floats,
                             jnp.asarray(x))
    gy = rng.standard_normal(shape).astype(np.float32)
    gld = rng.standard_normal(shape[0]).astype(np.float32)
    jgf, jgx = vjp((jnp.asarray(gy), jnp.asarray(gld)))
    jgp = merge(jgf)

    xr, gx, gp, gcond = stack._step_bwd(i, torch.from_numpy(np.array(jy)), torch.from_numpy(gy),
                                        torch.from_numpy(gld), None)
    assert gcond is None
    np.testing.assert_allclose(_f32(xr), x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(gx), _f32(jgx), rtol=0, atol=1e-4)
    names = {"an.log_s": ("an", "log_s"), "an.b": ("an", "b"), "lu.l": ("lu", "l"),
             "lu.u": ("lu", "u"), "lu.log_s": ("lu", "log_s")}
    names.update({f"net.{cv}.{lf}": ("net", cv, lf) for cv in ("conv1", "conv2", "conv3")
                  for lf in ("w", "b")})
    assert set(gp) == set(names)
    for name, path in names.items():
        ref = jgp
        for key in path:
            ref = ref[key]
        np.testing.assert_allclose(_f32(gp[name]), _f32(ref), rtol=0, atol=1e-4, err_msg=name)


def test_train_steps_pass_every_coupling_rows_the_stream_takes(monkeypatch):
    """Both GLOW builds' ``coupled`` reversible backward hands the rows op,
    at every coupling, rows that ``coupling_path`` sends to the row stream
    (contiguous y and gy, h whole), as the card's train step needs for its
    24 ``"rows"`` launches: the chain's last cotangent, a slice of the packed
    one, is made contiguous first."""
    from repro_torch.core import build_glow, build_glow_scanned, glow_scan, value_and_grad_nll
    from repro_torch.core import coupling as coupling_mod

    paths = []

    def spying(fn):
        def rows(y, h, gy, gld, flip=False, clamp=2.0):
            n = h.shape[-1] // 2
            paths.append(ckern.coupling_path(y, h[..., :n], h[..., n:], flip, gy))
            return fn(y, h, gy, gld, flip=flip, clamp=clamp)
        return rows

    monkeypatch.setattr(coupling_mod, "fused_coupling_bwd_rows",
                        spying(coupling_mod.fused_coupling_bwd_rows))
    monkeypatch.setattr(glow_scan, "fused_coupling_bwd_rows",
                        spying(glow_scan.fused_coupling_bwd_rows))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 16, 3), np.float32))
    small = dict(n_scales=3, k_steps=2, hidden=8, channels=3, device="cpu")
    for flow in (build_glow(grad_mode="coupled", **small),
                 build_glow_scanned(grad_mode="coupled", coupled_bwd="reversible", **small)):
        assert flow.engine == "coupled"
        paths.clear()
        value_and_grad_nll(flow, x)
        assert paths == ["rows"] * 6, paths

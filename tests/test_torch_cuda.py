"""The hand-written CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: y / x and every per-element backward output in f32 at 1e-4
absolute (the reference's kernel bound); bf16 compared as f32-upcast values
at rtol = atol = 2e-2; ld at rtol 1e-5 with atol 1e-4 (a sum of B*M*ca terms
in another order; for ``coupling_fwd``, whose random raw makes the terms
cancel, 1e-5 of sum |log_s| plus 1e-4); the backward's sums over (b, m) (gW,
g_log_s, g_b, and ``conv1x1_gw``'s gW) at 1e-4 in f32 and 5e-2 in bf16 of
each tensor's largest entry: sums of up to 131,072 terms, where an entry that
cancels to near zero keeps the round-off of the large partial sums (as
``chip_smoke.py`` holds them); gradients through ``fused_coupling_fwd`` and
``invertible_conv1x1`` at rtol = atol = 1e-4 against autograd through the
plain versions; ``flash_attention`` at the reference's ``_tol``
(``tests/test_kernels.py:43``: 2e-5 in f32, 2e-2 in bf16) against
``attention_ref``, and ``attn_apply(impl="flash")`` within 2e-4 of the
einsum path, as the reference pins it; ``wkv_scan`` and ``ssd_scan`` at the
reference's kernel bound (``tests/test_kernels.py:305``: 2e-4 in f32, 5e-2
in bf16, rtol = atol) against ``wkv_ref`` and ``ssd_ref`` on the same
inputs, and the model's scans (``nn/ssm.py``) on the card against the same
scans on the CPU at 2e-4; ``coupling_bwd`` on whole rows (x, gx, gh) at the
per-element bounds above, its pass-through halves bit for bit; the cHINT
cross couplings' half contract at M = 1 (batch 256 to 20,000) on the half
kernels at the same bounds, and a full-width cHINT train step against the
CPU (loss at 1e-5 relative, each gradient leaf at 1e-4 of its largest
entry, as ``chip_smoke.py`` holds GLOW's); an LM train step (granite-moe
``REDUCED``, f32) against the CPU at the same bounds in each engine, and
``moe_apply`` at granite-moe's expert widths bitwise repeatable and within
1e-4 of the CPU in f32.
"""

import pytest
import torch

from repro_torch.config import AttentionConfig
from repro_torch.kernels.attention import attention as akern
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.conv1x1 import conv1x1 as c1kern
from repro_torch.kernels.conv1x1.ops import invertible_conv1x1
from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref, conv1x1_mm_ref
from repro_torch.kernels.coupling import coupling as ckern
from repro_torch.kernels.coupling.ops import fused_coupling_fwd, fused_coupling_fwd_rows
from repro_torch.kernels.coupling.ref import (coupling_bwd_ref, coupling_bwd_rows_ref,
                                              coupling_fwd_ref, coupling_fwd_rows_ref,
                                              coupling_inv_ref, coupling_inv_rows_ref,
                                              coupling_stream_ref)
from repro_torch.kernels.flowstep import flowstep as kern
from repro_torch.kernels.flowstep.ops import fused_flowstep_fwd, fused_flowstep_inv
from repro_torch.kernels.flowstep.ref import (flowstep_fwd_ref, flowstep_inv_ref,
                                              flowstep_stream_ref, spine_bwd_ref)
from repro_torch.kernels.rwkv import rwkv as rkern
from repro_torch.kernels.rwkv.ref import wkv_ref
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.nn import ssm
from repro_torch.nn.attention import attn_apply, attn_init

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


def test_gradient_through_the_kernel_matches_the_plain_path(dev):
    """The fused step's backward on the card (``coupling_bwd`` then
    ``spine_bwd``) gives the gradient that autograd takes through the plain
    version on the same inputs."""
    x, ls, ab, w, raw, t = _inputs(2, 300, 12, torch.float32, dev)
    g = torch.Generator().manual_seed(1)
    gy = torch.randn(x.shape, generator=g).to(dev)
    gld = torch.randn(2, generator=g).to(dev)

    def grads(fn):
        leaves = [v.detach().clone().requires_grad_() for v in (x, ls, ab, w, raw, t)]
        y, ld = fn(*leaves)
        return torch.autograd.grad((y * gy).sum() + (ld * gld).sum(), leaves)

    before = (kern.spine_bwd.launches, ckern.coupling_bwd.launches)
    got, ref = grads(fused_flowstep_fwd), grads(flowstep_fwd_ref)
    torch.cuda.synchronize()
    assert (kern.spine_bwd.launches, ckern.coupling_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, a, r in zip(("x", "an_log_s", "an_b", "w", "raw", "t"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,path", [((8, 16384, 12), "stream"), ((8, 4096, 24), "stream"),
                                        ((8, 1024, 48), "stream"), ((8, 300, 12), "stream"),
                                        ((3, 77, 24), "stream"), ((2, 1001, 48), "stream"),
                                        ((1, 5, 12), "stream"), ((2, 28, 6), "tile"),
                                        ((2, 100, 16), "tile")])
def test_flowstep_takes_the_path_its_shape_names(dev, shape, path, dtype):
    """``flowstep_path``: the stream at C = 12, 24, 48 on the halves of one
    conditioner output (ragged last tiles, more tiles a batch than the ld
    reduce's 32 lanes, fewer rows than a tile), the tile kernel at other
    widths and, at the stream's widths, for raw and t that are two tensors;
    each against the plain version, its ld against ``flowstep_stream_ref``'s
    kernel-order sum, y, ld and x bitwise repeatable, one launch on the
    named path a call."""
    x, ls, ab, w, raw, t = _inputs(*shape, dtype, dev, seed=8)
    w_inv = torch.linalg.inv(w)
    y_r, _ = flowstep_fwd_ref(x, ls, ab, w, raw, t)
    cases = [(raw, t, path)]
    if path == "stream":
        cases.append((raw.contiguous(), t.contiguous(), "tile"))
    for rc, tc, want in cases:
        assert kern.flowstep_path(x, rc, tc) == want
        before = (dict(kern.flowstep_fwd.launches_by_path),
                  dict(kern.flowstep_inv.launches_by_path))
        y, ld = kern.flowstep_fwd(x, ls, ab, w, rc, tc)
        y2, ld2 = kern.flowstep_fwd(x, ls, ab, w, rc, tc)
        back = kern.flowstep_inv(y_r, ls, ab, w_inv, rc, tc)
        back2 = kern.flowstep_inv(y_r, ls, ab, w_inv, rc, tc)
        torch.cuda.synchronize()
        assert kern.flowstep_fwd.launches_by_path[want] == before[0][want] + 2
        assert kern.flowstep_inv.launches_by_path[want] == before[1][want] + 2
        ref = flowstep_fwd_ref(x, ls, ab, w, rc, tc)
        _close(y, ref[0], dtype)
        torch.testing.assert_close(ld, ref[1], rtol=1e-5, atol=1e-4)
        if shape[-1] in (12, 24, 48):
            _, ld_k = flowstep_stream_ref(x, ls, ab, w, raw, t)
            assert ((ld - ld_k).abs() <= 1e-5 * ld_k.abs().clamp_min(1.0)).all()
        _close(back, flowstep_inv_ref(y_r, ls, ab, w_inv, rc, tc), dtype)
        assert torch.equal(y, y2) and torch.equal(ld, ld2) and torch.equal(back, back2)


BWD_SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (8, 300, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_spine_bwd_matches_plain_version(dev, shape, dtype):
    x2, ls, ab, w, _, _ = _inputs(*shape, dtype, dev)
    gx2 = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(dev, dtype)
    w_inv = torch.linalg.inv(w)
    got = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
    ref = spine_bwd_ref(x2, gx2, w, w_inv, ls, ab)
    again = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
    torch.cuda.synchronize()
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    for a, r in zip(got[:2], ref[:2]):
        _close(a, r, dtype)
    for name, a, r, b in zip(("gW", "g_log_s", "g_b"), got[2:], ref[2:], again[2:]):
        err = (a - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (name, err)
        assert torch.equal(a, b), f"{name} not bitwise repeatable"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,path", [((8, 300, 12), "cluster"), ((2, 1001, 48), "cluster"),
                                        ((3, 77, 24), "cluster"), ((2, 100, 16), "tile"),
                                        ((2, 28, 6), "tile")])
def test_spine_bwd_takes_the_path_its_shape_names(dev, shape, path, dtype):
    """``spine_path``: the cluster kernel at C = 12, 24, 48 (ragged rows, a
    plan whose last block is short), the tile kernel at a width off the
    template path and for an x2 one element off 16 bytes; each against the
    plain version, its sums bitwise repeatable, one launch on the named
    path."""
    x2, ls, ab, w, _, _ = _inputs(*shape, dtype, dev, seed=3)
    gx2 = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(dev, dtype)
    w_inv = torch.linalg.inv(w)
    cases = [(x2, path)]
    if path == "cluster":
        odd = torch.cat([torch.zeros(1, dtype=dtype, device=dev), x2.reshape(-1)])[1:]
        cases.append((odd.view(shape), "tile"))
    for x2c, want in cases:
        assert kern.spine_path(x2c, gx2) == want
        before = dict(kern.spine_bwd.launches_by_path)
        got = kern.spine_bwd(x2c, gx2, w, w_inv, ls, ab)
        again = kern.spine_bwd(x2c, gx2, w, w_inv, ls, ab)
        ref = spine_bwd_ref(x2c, gx2, w, w_inv, ls, ab)
        torch.cuda.synchronize()
        assert kern.spine_bwd.launches_by_path[want] == before[want] + 2
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        for a, r in zip(got[:2], ref[:2]):
            _close(a, r, dtype)
        for name, a, r, b in zip(("gW", "g_log_s", "g_b"), got[2:], ref[2:], again[2:]):
            err = (a - r).abs().max().item()
            assert err <= tol * r.abs().max().item(), (name, err)
            assert torch.equal(a, b), f"{name} not bitwise repeatable"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_coupling_bwd_matches_plain_version(dev, shape, dtype):
    """On strided halves, as the flow step's backward passes them."""
    y, _, _, _, raw, t = _inputs(*shape, dtype, dev)
    ca = shape[-1] // 2
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(dev, dtype)
    gld = torch.randn(shape[0], generator=torch.Generator().manual_seed(4)).to(dev)
    got = ckern.coupling_bwd(y[..., :ca], raw, t, gy[..., :ca], gld)
    ref = coupling_bwd_ref(y[..., :ca], raw, t, gy[..., :ca], gld)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        _close(a, r, dtype)


COUPLING_SHAPES = [(8, 16384, 6), (8, 4096, 12), (8, 1024, 24), (8, 300, 6), (2, 28, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", COUPLING_SHAPES)
def test_coupling_fwd_and_inv_match_plain_versions(dev, shape, dtype):
    """On strided halves (x the first ca channels of a (B, M, 2*ca) tensor,
    raw/t the halves of another), as the unrolled GLOW passes them."""
    b, m, ca = shape
    g = torch.Generator().manual_seed(5)
    xx = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    h = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    x, raw, t = xx[..., :ca], h[..., :ca], h[..., ca:]
    before = (ckern.coupling_fwd.launches, ckern.coupling_inv.launches)
    y, ld = ckern.coupling_fwd(x, raw, t)
    y_r, ld_r = coupling_fwd_ref(x, raw, t)
    back = ckern.coupling_inv(x, raw, t)
    _, ld2 = ckern.coupling_fwd(x, raw, t)
    torch.cuda.synchronize()
    _close(y, y_r, dtype)
    # the terms cancel for random raw: the sum's error scales with sum |log_s|
    scale = (2.0 * torch.tanh(raw.float() / 2.0)).abs().sum(dim=(1, 2))
    assert ((ld - ld_r).abs() <= 1e-5 * scale + 1e-4).all()
    assert torch.equal(ld, ld2)  # no atomics: bitwise repeatable
    _close(back, coupling_inv_ref(x, raw, t), dtype)
    assert (ckern.coupling_fwd.launches, ckern.coupling_inv.launches) == (before[0] + 2,
                                                                            before[1] + 1)


def test_fused_coupling_fwd_gradient_on_the_card_matches_the_plain_path(dev):
    """``fused_coupling_fwd``'s backward on the card (``coupling_bwd`` from
    the output side) gives the gradient autograd takes through the plain
    version."""
    g = torch.Generator().manual_seed(6)
    h = torch.randn(2, 300, 12, generator=g).to(dev)
    x = torch.randn(2, 300, 12, generator=g).to(dev)[..., :6]
    gy = torch.randn(2, 300, 6, generator=g).to(dev)
    gld = torch.randn(2, generator=g).to(dev)

    def grads(fn):
        leaves = [v.detach().clone().requires_grad_() for v in (x, h[..., :6], h[..., 6:])]
        y, ld = fn(*leaves)
        return torch.autograd.grad((y * gy).sum() + (ld * gld).sum(), leaves)

    before = ckern.coupling_bwd.launches
    got, ref = grads(fused_coupling_fwd), grads(coupling_fwd_ref)
    torch.cuda.synchronize()
    assert ckern.coupling_bwd.launches == before + 1
    for name, a, r in zip(("x", "raw", "t"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


# the row stream: the unrolled model's (B, M, C), a ragged last tile at each
# GLOW width
ROW_SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (8, 300, 12), (3, 77, 24),
              (1, 13, 48)]


def _rows(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g).to(dev, dtype),
            torch.randn(shape, generator=g).to(dev, dtype))


def _ld_scale(h):
    """sum |log_s| of each batch (at least 1): the terms cancel for random
    raw, so the sum's error scales with it"""
    ca = h.shape[-1] // 2
    return (2.0 * torch.tanh(h[..., :ca].float() / 2.0)).abs().sum(dim=(1, 2)).clamp_min(1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_coupling_rows_match_plain_versions(dev, shape, dtype):
    """The row stream writes the layer's whole output row: the coupled half
    as the plain row version computes it, the pass-through half the input's
    bit for bit, ld within 1e-5 of sum |log_s| of the plain sum and of the
    kernel-order mirror, and bitwise repeatable."""
    x, h = _rows(shape, dtype, dev, 7)
    ca = shape[-1] // 2
    assert ckern.coupling_path(x, h[..., :ca], h[..., ca:]) == "rows"
    before = (dict(ckern.coupling_fwd.launches_by_path), dict(ckern.coupling_inv.launches_by_path))
    y, ld = ckern.coupling_fwd.rows(x, h)
    y2, ld2 = ckern.coupling_fwd.rows(x, h)
    y_r, ld_r = coupling_fwd_rows_ref(x, h)
    _, ld_k = coupling_stream_ref(x, h)
    back = ckern.coupling_inv.rows(y_r, h)
    back_r = coupling_inv_rows_ref(y_r, h)
    torch.cuda.synchronize()
    _close(y, y_r, dtype)
    _close(back, back_r, dtype)
    assert torch.equal(y[..., ca:], x[..., ca:]) and torch.equal(back[..., ca:], y_r[..., ca:])
    scale = _ld_scale(h)
    assert ((ld - ld_r).abs() <= 1e-5 * scale).all() and ((ld - ld_k).abs() <= 1e-5 * scale).all()
    assert torch.equal(ld, ld2) and torch.equal(y, y2)  # no atomics: bitwise repeatable
    assert ckern.coupling_fwd.launches_by_path == {**before[0], "rows": before[0]["rows"] + 2}
    assert ckern.coupling_inv.launches_by_path == {**before[1], "rows": before[1]["rows"] + 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coupling_rows_off_the_rule_take_the_half_kernels(dev, dtype):
    """The second half coupled, a width off the stream's, h a slice of a
    wider tensor, a base off 16 bytes: the half kernel and the join, against
    the plain row version."""
    x, h = _rows((2, 300, 12), dtype, dev, 9)
    wide = torch.randn(2, 300, 20, generator=torch.Generator().manual_seed(10)).to(dev, dtype)
    x_off = torch.randn(2 * 300 * 12 + 1, generator=torch.Generator().manual_seed(11))
    x_off = x_off.to(dev, dtype)[1:].view(2, 300, 12)
    x7, h7 = _rows((2, 300, 7), dtype, dev, 12)
    for xx, hh, flip in ((x, h, True), (x7, h7[..., :6], False), (x, wide[..., :12], False),
                         (x_off, h, False)):
        before = dict(ckern.coupling_fwd.launches_by_path)
        y, ld = ckern.coupling_fwd.rows(xx, hh, flip)
        y_r, ld_r = coupling_fwd_rows_ref(xx, hh, flip)
        back = ckern.coupling_inv.rows(y_r, hh, flip)
        torch.cuda.synchronize()
        assert ckern.coupling_fwd.launches_by_path == {**before, "tile": before["tile"] + 1}
        _close(y, y_r, dtype)
        _close(back, coupling_inv_rows_ref(y_r, hh, flip), dtype)
        n = hh.shape[-1] // 2
        scale = (2.0 * torch.tanh(hh[..., :n].float() / 2.0)).abs().sum(dim=(1, 2))
        assert ((ld - ld_r).abs() <= 1e-5 * scale.clamp_min(1.0)).all()


def test_coupling_rows_gradient_on_the_card_matches_the_plain_path(dev):
    """The row op's backward on the card (``coupling_bwd`` on the coupled
    half, the pass-through half's cotangent passed on, h's as (graw | gt))
    gives the gradient autograd takes through the plain row version."""
    x, h = _rows((2, 300, 12), torch.float32, dev, 13)
    g = torch.Generator().manual_seed(14)
    gy = torch.randn(2, 300, 12, generator=g).to(dev)
    gld = torch.randn(2, generator=g).to(dev)

    def grads(fn):
        leaves = [v.detach().clone().requires_grad_() for v in (x, h)]
        y, ld = fn(*leaves)
        return torch.autograd.grad((y * gy).sum() + (ld * gld).sum(), leaves)

    before = (ckern.coupling_bwd.launches_by_path["rows"],
              ckern.coupling_fwd.launches_by_path["rows"])
    got, ref = grads(fused_coupling_fwd_rows), grads(coupling_fwd_rows_ref)
    torch.cuda.synchronize()
    assert (ckern.coupling_bwd.launches_by_path["rows"],
            ckern.coupling_fwd.launches_by_path["rows"]) == (before[0] + 1, before[1] + 1)
    for name, a, r in zip(("x", "h"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_coupling_bwd_rows_match_plain_version(dev, shape, dtype):
    """The backward's row stream writes x, gx and gh as whole rows: each as
    the plain row version computes it, the pass-through halves and gt bit
    for bit gy's and y's, bitwise repeatable, one launch a call on "rows"."""
    y, h = _rows(shape, dtype, dev, 15)
    g = torch.Generator().manual_seed(16)
    gy = torch.randn(shape, generator=g).to(dev, dtype)
    gld = torch.randn(shape[0], generator=g).to(dev)
    ca = shape[-1] // 2
    assert ckern.coupling_path(y, h[..., :ca], h[..., ca:], gy=gy) == "rows"
    before = dict(ckern.coupling_bwd.launches_by_path)
    got = ckern.coupling_bwd.rows(y, h, gy, gld)
    again = ckern.coupling_bwd.rows(y, h, gy, gld)
    ref = coupling_bwd_rows_ref(y, h, gy, gld)
    torch.cuda.synchronize()
    assert ckern.coupling_bwd.launches_by_path == {**before, "rows": before["rows"] + 2}
    for a, r, b in zip(got, ref, again):
        assert a.shape == r.shape and a.dtype == r.dtype and a.is_contiguous()
        _close(a, r, dtype)
        assert torch.equal(a, b)  # nothing summed: bitwise repeatable
    x, gx, gh = got
    assert torch.equal(x[..., ca:], y[..., ca:]) and torch.equal(gx[..., ca:], gy[..., ca:])
    assert torch.equal(gh[..., ca:], gy[..., :ca])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coupling_bwd_rows_off_the_rule_take_the_half_kernel(dev, dtype):
    """The second half coupled, a width off the stream's, a gy that is a
    transposed view: the half kernel and the joins, against the plain row
    version."""
    y, h = _rows((2, 300, 12), dtype, dev, 17)
    y7, h7 = _rows((2, 300, 7), dtype, dev, 18)
    g = torch.Generator().manual_seed(19)
    gy = torch.randn(2, 300, 12, generator=g).to(dev, dtype)
    gy7 = torch.randn(2, 300, 7, generator=g).to(dev, dtype)
    gy_t = gy.transpose(1, 2).contiguous().transpose(1, 2)
    gld = torch.randn(2, generator=g).to(dev)
    for yy, hh, gg, flip in ((y, h, gy, True), (y7, h7[..., :6], gy7, False), (y, h, gy_t, False)):
        before = dict(ckern.coupling_bwd.launches_by_path)
        got = ckern.coupling_bwd.rows(yy, hh, gg, gld, flip)
        ref = coupling_bwd_rows_ref(yy, hh, gg, gld, flip)
        torch.cuda.synchronize()
        assert ckern.coupling_bwd.launches_by_path == {**before, "tile": before["tile"] + 1}
        for a, r in zip(got, ref):
            _close(a, r, dtype)


# the cHINT path's cross couplings: M = 1, a cb-wide half under an h of
# 2 cb = (raw | t), batch 256 (a train step), 2048 (a posterior draw) and
# 20,000 (a sample), cb 16 (the root of d_theta 32) and 8 (its children)
CHINT_SHAPES = [(256, 1, 16), (256, 1, 8), (2048, 1, 16), (20000, 1, 8)]


def _half_rows(shape, dtype, dev, seed):
    """v (B, 1, cb) and h (B, 1, 2 cb), as a HINT node passes them: v a
    strided half of a (B, 2 cb) state, h one conditioner output."""
    b, m, cb = shape
    g = torch.Generator().manual_seed(seed)
    state = torch.randn(b, 2 * cb, generator=g).to(dev, dtype)
    h = torch.randn(b, 2 * cb, generator=g).to(dev, dtype)
    return state[:, cb:].reshape(b, m, cb), h.reshape(b, m, 2 * cb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CHINT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_coupling_half_contract_at_m1_takes_the_tile_kernels(dev, shape, dtype):
    """HINT's cross coupling on the row ops (h twice the half's width): the
    inverse and the backward on the half kernels ("tile"), one launch each,
    against the plain row versions, bitwise repeatable; gh = (graw | gt)
    with gt bit for bit gy."""
    v, h = _half_rows(shape, dtype, dev, 21)
    g = torch.Generator().manual_seed(22)
    gy = torch.randn(shape, generator=g).to(dev, dtype)
    gld = torch.randn(shape[0], generator=g).to(dev)
    cb = shape[-1]
    assert ckern.coupling_path(v, h[..., :cb], h[..., cb:]) == "tile"
    before_i = dict(ckern.coupling_inv.launches_by_path)
    before_b = dict(ckern.coupling_bwd.launches_by_path)
    x = ckern.coupling_inv.rows(v, h)
    x_again = ckern.coupling_inv.rows(v, h)
    got = ckern.coupling_bwd.rows(v, h, gy, gld)
    again = ckern.coupling_bwd.rows(v, h, gy, gld)
    torch.cuda.synchronize()
    assert ckern.coupling_inv.launches_by_path == {**before_i, "tile": before_i["tile"] + 2}
    assert ckern.coupling_bwd.launches_by_path == {**before_b, "tile": before_b["tile"] + 2}
    _close(x, coupling_inv_rows_ref(v, h), dtype)
    assert torch.equal(x, x_again) and x.shape == shape
    for a, r, b in zip(got, coupling_bwd_rows_ref(v, h, gy, gld), again):
        assert a.shape == r.shape and a.dtype == r.dtype
        _close(a, r, dtype)
        assert torch.equal(a, b)
    assert torch.equal(got[2][..., cb:], gy)


def test_chint_train_step_and_draw_on_the_card(dev):
    """A coupled cHINT train step at the full width of ``CHINT_COUPLED``
    (d_theta 32, a 64-wide summary, batch 256) on the card against the same
    parameters on the CPU: loss at 1e-5 relative, each gradient leaf at 1e-4
    of its largest entry; 12 ``coupling_bwd`` launches on "tile" and no
    ``coupling_fwd``; a draw through the ``kernel_inverse`` twin launches 12
    ``coupling_inv`` and equals the plain inverse at 1e-4."""
    import copy

    from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint

    def build(device):
        g = torch.Generator().manual_seed(5)
        flow = build_chint(32, 64, grad_mode="coupled", generator=g, device="cpu")
        twin = build_chint(32, 64, kernel_inverse=True, generator=g, device="cpu")
        with torch.no_grad():
            for p in flow.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        return ConditionalFlow(flow, SummaryMLP(32, 64, 128, generator=g, device="cpu"),
                               sample_flow=twin, device=device)

    model_cpu = build("cpu")
    model = ConditionalFlow(copy.deepcopy(model_cpu.flow), copy.deepcopy(model_cpu.summary),
                            sample_flow=copy.deepcopy(model_cpu.sample_flow), device=dev)
    g = torch.Generator().manual_seed(6)
    theta, y = torch.randn(256, 32, generator=g), torch.randn(256, 32, generator=g)

    def step(m):
        named = dict(m.named_parameters())
        loss = m.loss(theta, y)
        return loss, dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    for k in ckern.KERNELS:
        k.launches_by_path = dict.fromkeys(k.launches_by_path, 0)
    loss, grads = step(model)
    torch.cuda.synchronize()
    assert ckern.coupling_bwd.launches_by_path == {"rows": 0, "tile": 12}
    assert sum(ckern.coupling_fwd.launches_by_path.values()) == 0
    loss_cpu, grads_cpu = step(model_cpu)
    assert abs(loss.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item())
    for name, r in grads_cpu.items():
        assert (grads[name].cpu() - r).abs().max() <= 1e-4 * r.abs().max(), name
    z = torch.randn(2048, 32, generator=g).to(dev)
    with torch.no_grad():
        cond = model._cond(y[:1].repeat(2048, 1))
        x = model.sample_flow.inverse(z, cond)
        torch.cuda.synchronize()
        assert ckern.coupling_inv.launches_by_path == {"rows": 0, "tile": 12}
        torch.testing.assert_close(x, model.flow.inverse(z, cond), rtol=0, atol=1e-4)


# the model's (B, M, C), the widest C the reference's tests take (conv1x1_gw's
# per-chunk path), a ragged M, a ragged last stream tile at each GLOW width,
# and an N that leaves blocks of conv1x1_gw's one cluster without rows
CONV1X1_SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (2, 128, 192), (2, 300, 8),
                  (2, 301, 12), (3, 77, 24), (1, 13, 48), (1, 200, 48)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV1X1_SHAPES)
def test_conv1x1_kernels_match_plain_versions(dev, shape, dtype):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    gy = torch.randn(shape, generator=g).to(dev, dtype)
    w = (torch.randn(shape[-1], shape[-1], generator=g) / shape[-1] ** 0.5).to(dev)
    by_path = dict(c1kern.conv1x1_mm.launches_by_path)
    gw_by_path = dict(c1kern.conv1x1_gw.launches_by_path)
    y = c1kern.conv1x1_mm(x, w)
    gx = c1kern.conv1x1_mm(gy, w.T)
    gw, gw2 = c1kern.conv1x1_gw(x, gy), c1kern.conv1x1_gw(x, gy)
    torch.cuda.synchronize()
    # the GLOW widths take the persistent stream and the cluster sum, the
    # others the W panels and the per-chunk partials
    glow = shape[-1] in c1kern.STREAM_WIDTHS
    path = "stream" if glow else "panel"
    assert c1kern.conv1x1_mm.launches_by_path[path] == by_path[path] + 2
    gw_path = "cluster" if glow else "panel"
    assert c1kern.conv1x1_gw.launches_by_path[gw_path] == gw_by_path[gw_path] + 2
    _close(y, conv1x1_mm_ref(x, w), dtype)
    _close(gx, conv1x1_mm_ref(gy, w.T), dtype)
    ref = conv1x1_gw_ref(x, gy)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert (gw - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(gw, gw2)  # no atomics: bitwise repeatable


def test_invertible_conv1x1_gradient_on_the_card_matches_the_plain_path(dev):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 300, 12, generator=g).to(dev)
    w = torch.randn(12, 12, generator=g).to(dev)
    gy = torch.randn(2, 300, 12, generator=g).to(dev)

    def grads(fn):
        x_, w_ = x.clone().requires_grad_(), w.clone().requires_grad_()
        return torch.autograd.grad((fn(x_, w_) * gy).sum(), (x_, w_))

    before = (c1kern.conv1x1_mm.launches, c1kern.conv1x1_gw.launches)
    got, ref = grads(invertible_conv1x1), grads(conv1x1_mm_ref)
    torch.cuda.synchronize()
    assert (c1kern.conv1x1_mm.launches, c1kern.conv1x1_gw.launches) == (before[0] + 2,
                                                                         before[1] + 1)
    for name, a, r in zip(("x", "w"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


# (B, Hq, Hkv, Sq, Skv, D): the reference's kernel tests, every head_dim of
# src/repro/configs, a top-left causal Sq != Skv, ragged lengths the kernel
# masks, yi-6b's prefill shape, and head dims that are no multiple of 16 (bf16
# on the CUDA-core kernel)
FLASH_SHAPES = [
    (1, 4, 4, 256, 256, 32), (2, 8, 2, 256, 256, 64), (1, 6, 1, 512, 512, 64),
    (2, 4, 2, 128, 128, 16), (1, 4, 1, 128, 128, 112), (1, 8, 2, 128, 128, 128),
    (1, 4, 2, 128, 256, 32), (2, 4, 2, 100, 77, 64), (8, 32, 4, 2048, 2048, 128),
    (2, 8, 2, 256, 256, 36), (1, 4, 2, 100, 77, 100),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_plain_version(dev, shape, dtype, causal):
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator().manual_seed(9)
    q = torch.randn(b, hq, sq, d, generator=g).to(dev, dtype)
    k = torch.randn(b, hkv, skv, d, generator=g).to(dev, dtype)
    v = torch.randn(b, hkv, skv, d, generator=g).to(dev, dtype)
    before = akern.flash_attention.launches
    by_path = dict(akern.flash_attention.launches_by_path)
    # bf16 with a head dim that is a multiple of 16 takes the tensor-core
    # kernel, f32 with one that is a multiple of 8 the TF32 kernel, the
    # other head dims the CUDA-core one
    path = akern.flash_path(q, k, v)
    assert path == ("tensor_core" if dtype == torch.bfloat16 and d % 16 == 0
                    else "tf32" if dtype == torch.float32 and d % 8 == 0 else "cuda_core")
    o = akern.flash_attention(q, k, v, causal=causal)
    o2 = akern.flash_attention(q, k, v, causal=causal)
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert akern.flash_attention.launches == before + 2
    assert akern.flash_attention.launches_by_path[path] == by_path[path] + 2
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o.float(), ref.float(), **tol)
    assert torch.equal(o, o2)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_strided_heads(dev, dtype):
    """(B, S, H, D) tensors viewed as (B, H, S, D), as attn_apply passes
    them: the same result as on copies, and the output in the same layout."""
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(2, 256, h, 64, generator=g).to(dev, dtype) for h in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    o = akern.flash_attention(*views)
    torch.testing.assert_close(o, akern.flash_attention(*(t.contiguous() for t in views)),
                               rtol=0, atol=0)
    assert o.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("d", [6, 130])
def test_flash_attention_refuses_an_unsupported_head_dim(dev, d):
    q = torch.zeros(1, 4, 128, d, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        akern.flash_attention(q, q[:, :2], q[:, :2])


def test_flash_attention_sends_a_bf16_view_tma_cannot_take_to_cuda_cores(dev):
    """The tensor-core kernel's TMA copies need a 16-byte-aligned base and
    16-byte-multiple strides: a bf16 q 8 bytes off, or a k whose rows lie 136
    bytes apart, goes to the CUDA-core kernel, which takes any."""
    g = torch.Generator().manual_seed(14)
    q0, k0, v = (torch.randn(2, h, 128, 64, generator=g).to(dev, torch.bfloat16)
                 for h in (4, 2, 2))
    q = torch.empty(q0.numel() + 4, device=dev, dtype=torch.bfloat16)[4:].view(q0.shape)
    k = torch.empty(2, 2, 128, 68, device=dev, dtype=torch.bfloat16)[..., :64]
    q.copy_(q0)
    k.copy_(k0)
    for args in ((q, k0, v), (q0, k, v)):
        assert akern.flash_path(*args) == "cuda_core"
        by_path = dict(akern.flash_attention.launches_by_path)
        o = akern.flash_attention(*args)
        torch.cuda.synchronize()
        assert akern.flash_attention.launches_by_path["cuda_core"] == by_path["cuda_core"] + 1
        torch.testing.assert_close(o.float(), attention_ref(*args).float(), rtol=2e-2, atol=2e-2)


def _guarded_cases(dev):
    """Each LM kernel: (its op's call through the guard, the kernel's own
    call, inputs)."""
    from repro_torch.kernels.attention.ops import flash_sdpa
    from repro_torch.kernels.rwkv.ops import rwkv6_wkv
    from repro_torch.kernels.ssd.ops import mamba2_ssd

    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(2, h, 128, 64, generator=g).to(dev, torch.bfloat16) for h in (8, 2, 2))
    r, kw, vw, w, u, s0 = _wkv_inputs((2, 4, 64, 32), torch.float32, dev)
    x, da, dt, b_in, c_in, s1 = _ssd_inputs((2, 4, 128, 32, 16), torch.float32, dev)
    return {
        "flash_attention": (akern.flash_attention, flash_sdpa, akern.flash_attention, (q, k, v)),
        "wkv_scan": (rkern.wkv_scan, lambda *a: rwkv6_wkv(*a[:5], state0=a[5]),
                     lambda *a: rkern.wkv_scan(*a[:5], state0=a[5]), (r, kw, vw, w, u, s0)),
        "ssd_scan": (skern.ssd_scan, lambda *a: mamba2_ssd(*a[:5], chunk=64, state0=a[5]),
                     lambda *a: skern.ssd_scan(*a[:5], chunk=64, state0=a[5]),
                     (x, da, dt, b_in, c_in, s1)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "wkv_scan", "ssd_scan"])
def test_lm_kernels_refuse_gradients_on_the_card(dev, name):
    """No backward kernel yet: a CUDA input that requires grad raises on
    backward instead of silently getting no gradient; under no_grad the op
    gives the kernel's own output with the same one launch."""
    kernel, op, unguarded, args = _guarded_cases(dev)[name]
    y = op(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(NotImplementedError, match=name):
        (y[0] if isinstance(y, tuple) else y).float().sum().backward()
    before = kernel.launches
    with torch.no_grad():
        guarded = op(*args)
    assert kernel.launches == before + 1
    plain = unguarded(*args)
    torch.cuda.synchronize()
    for a, b in (zip(guarded, plain) if isinstance(plain, tuple) else [(guarded, plain)]):
        assert torch.equal(a, b)


def test_flash_impl_of_attn_apply_on_the_card(dev):
    cfg = AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32)
    params = attn_init(torch.Generator(dev).manual_seed(0), 64, cfg)
    x = torch.randn(2, 128, 64, generator=torch.Generator(dev).manual_seed(1), device=dev)
    pos = torch.arange(128, device=dev)
    before = akern.flash_attention.launches
    out_flash, _ = attn_apply(params, x, cfg, pos, impl="flash")
    out_xla, _ = attn_apply(params, x, cfg, pos, impl="xla")
    torch.cuda.synchronize()
    assert akern.flash_attention.launches == before + 1
    torch.testing.assert_close(out_flash, out_xla, rtol=2e-4, atol=2e-4)


def _scan_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-4)


def _wkv_inputs(shape, dtype, dev, seed=11):
    """r, k, v standard normal, w = sigmoid(normal) in ``dtype``; u (H, K) and
    a state0 (B, H, K, K) in f32."""
    b, h, s, kd = shape
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, h, s, kd, generator=g).to(dev, dtype) for _ in range(3))
    w = torch.sigmoid(torch.randn(b, h, s, kd, generator=g)).to(dev, dtype)
    u = (0.1 * torch.randn(h, kd, generator=g)).to(dev)
    state0 = (0.5 * torch.randn(b, h, kd, kd, generator=g)).to(dev)
    return r, k, v, w, u, state0


# the reference's kernel-test shapes (tests/test_kernels.py:363), a ragged S
# (no multiple of the kernel's 16-step stage) at each head size, decode's
# S = 1, and rwkv6-7b's head size over 300 steps
WKV_SHAPES = [(1, 2, 128, 16), (2, 4, 64, 32), (2, 3, 37, 64), (8, 64, 1, 64), (2, 4, 300, 64),
              (2, 3, 21, 16), (1, 2, 45, 32)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wkv_scan_matches_plain_version(dev, shape, dtype, with_state):
    r, k, v, w, u, state0 = _wkv_inputs(shape, dtype, dev)
    s0 = state0 if with_state else None
    before = rkern.wkv_scan.launches
    y, st = rkern.wkv_scan(r, k, v, w, u, state0=s0)
    y2, st2 = rkern.wkv_scan(r, k, v, w, u, state0=s0)
    y_ref, st_ref = wkv_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rkern.wkv_scan.launches == before + 2
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, **_scan_tol(dtype))
    torch.testing.assert_close(st, st_ref, **_scan_tol(dtype))
    assert torch.equal(y, y2) and torch.equal(st, st2)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kd", [16, 32, 64])
def test_wkv_scan_takes_strided_and_misaligned_views(dev, kd, dtype):
    """(B, S, H, K) tensors viewed as (B, H, S, K), as the model passes them,
    and views whose base is one element off 16 bytes (the wrapper copies
    them for the kernel's 16-byte copies): y keeps r's layout where it can,
    equals the plain version and is bitwise repeatable, with and without a
    state."""
    b, h, s = 2, 3, 29
    r, k, v, w, u, state0 = _wkv_inputs((b, h, s, kd), dtype, dev, seed=14)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, w)]
    flat = torch.cat([torch.zeros(1, dtype=dtype, device=dev), r.transpose(1, 2).reshape(-1)])
    odd = flat[1:].view(b, s, h, kd).transpose(1, 2)
    assert odd.data_ptr() % 16 != 0 and torch.equal(odd, r)
    for args in (views, [odd] + views[1:]):
        for s0 in (None, state0):
            y, st = rkern.wkv_scan(*args, u, state0=s0)
            y2, st2 = rkern.wkv_scan(*args, u, state0=s0)
            y_ref, st_ref = wkv_ref(*args, u, s0)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, y_ref, **_scan_tol(dtype))
            torch.testing.assert_close(st, st_ref, **_scan_tol(dtype))
            assert torch.equal(y, y2) and torch.equal(st, st2)
    assert rkern.wkv_scan(*views, u)[0].stride() == views[0].stride()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kd", [16, 32, 64])
def test_wkv_decode_step_is_the_staged_first_step(dev, kd, dtype):
    """A decode step (S = 1) reads r, k, w, v straight from HBM; its y is
    bitwise the first step of the staged path (S = 17) on the same inputs."""
    r, k, v, w, u, state0 = _wkv_inputs((2, 3, 17, kd), dtype, dev, seed=16)
    y, _ = rkern.wkv_scan(r, k, v, w, u, state0=state0)
    y1, st1 = rkern.wkv_scan(*(t[:, :, :1] for t in (r, k, v, w)), u, state0=state0)
    y_ref, st_ref = wkv_ref(*(t[:, :, :1] for t in (r, k, v, w)), u, state0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y[:, :, :1])
    torch.testing.assert_close(st1, st_ref, **_scan_tol(dtype))


def _ssd_inputs(shape, dtype, dev, seed=12):
    """x, b_in, c_in in ``dtype``; dt = softplus(normal), da = -dt * decay
    rate, a state0 (B, H, P, N), all f32."""
    b, h, s, p, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, s, p, generator=g).to(dev, dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, h, s, generator=g))
    da = -dt * torch.exp(0.2 * torch.randn(b, h, s, generator=g))
    b_in, c_in = (torch.randn(b, s, n, generator=g).to(dev, dtype) for _ in range(2))
    state0 = (0.5 * torch.randn(b, h, p, n, generator=g)).to(dev)
    return x, da.to(dev), dt.to(dev), b_in, c_in, state0


# (B, H, S, P, N, chunk): the reference's kernel-test shapes
# (tests/test_kernels.py:299), a chunk that is no multiple of the 64-row tile,
# zamba2-7b's head dim, state size and chunk, a single-chunk prompt, eight
# chunks at zamba2's widths, and P, N < 64 over five ragged-tile chunks
SSD_SHAPES = [(1, 2, 256, 16, 16, 64), (2, 4, 128, 32, 16, 64), (2, 3, 96, 64, 64, 48),
              (1, 4, 512, 64, 64, 256), (2, 2, 12, 16, 16, 256), (2, 8, 2048, 64, 64, 256),
              (1, 3, 200, 20, 12, 40)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_matches_plain_version(dev, shape, dtype, with_state):
    *dims, chunk = shape
    x, da, dt, b_in, c_in, state0 = _ssd_inputs(dims, dtype, dev)
    s0 = state0 if with_state else None
    before = skern.ssd_scan.launches
    y, st = skern.ssd_scan(x, da, dt, b_in, c_in, chunk=chunk, state0=s0)
    y2, st2 = skern.ssd_scan(x, da, dt, b_in, c_in, chunk=chunk, state0=s0)
    y_ref, st_ref = ssd_ref(x, da, dt, b_in, c_in, s0)
    torch.cuda.synchronize()
    assert skern.ssd_scan.launches == before + 2
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref, **_scan_tol(dtype))
    torch.testing.assert_close(st, st_ref, **_scan_tol(dtype))
    assert torch.equal(y, y2) and torch.equal(st, st2)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_rising_decays_and_any_head_dim(dev, dtype):
    """da of either sign (mean -0.02, std 0.05), so cum rises inside every
    chunk and each decay below the diagonal is taken per element, not as a
    row and a column factor; P = 18, whose rows x copies one element at a
    time in either type."""
    b, h, s, p, n, chunk = 2, 3, 384, 18, 16, 192
    x, _, dt, b_in, c_in, state0 = _ssd_inputs((b, h, s, p, n), dtype, dev)
    noise = torch.randn(b, h, s, generator=torch.Generator().manual_seed(13))
    da = (-0.02 + 0.05 * noise).to(dev)
    assert (da > 0).any() and (da < 0).any()
    y, st = skern.ssd_scan(x, da, dt, b_in, c_in, chunk=chunk, state0=state0)
    y2, st2 = skern.ssd_scan(x, da, dt, b_in, c_in, chunk=chunk, state0=state0)
    y_ref, st_ref = ssd_ref(x, da, dt, b_in, c_in, state0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_ref, **_scan_tol(dtype))
    torch.testing.assert_close(st, st_ref, **_scan_tol(dtype))
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_model_scans_take_the_kernels_on_the_card(dev):
    """``_wkv_scan``, ``_wkv_scan_chunked`` and ``_ssd_chunk_scan`` on CUDA
    tensors, (B, S, H, .) as the mixers pass them: with ``kernel=True`` (the
    serving route) one launch each, the results equal to the same scans on
    the CPU, y back in (B, S, H, .); with ``kernel=False`` (the training
    route) the plain scans on the card, no launch."""
    r, k, v, w, u, state0 = _wkv_inputs((2, 4, 40, 64), torch.float32, dev)
    bshk = [t.transpose(1, 2).contiguous() for t in (r, k, v, w)]
    before = rkern.wkv_scan.launches
    y, st = ssm._wkv_scan(*bshk, u, state0, kernel=True)
    yc, stc = ssm._wkv_scan_chunked(*bshk, u, state0, chunk=16, kernel=True)
    yp, stp = ssm._wkv_scan(*bshk, u, state0)
    y_cpu, st_cpu = ssm._wkv_scan(*(t.cpu() for t in bshk), u.cpu(), state0.cpu())
    torch.cuda.synchronize()
    assert rkern.wkv_scan.launches == before + 2
    for a, b in ((y, y_cpu), (st, st_cpu), (yc, y_cpu), (stc, st_cpu), (yp, y_cpu),
                 (stp, st_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)
    x, da, dt, b_in, c_in, s0 = _ssd_inputs((2, 3, 128, 64, 64), torch.float32, dev)
    args = (x.transpose(1, 2).contiguous(), da.transpose(1, 2).contiguous(),
            dt.transpose(1, 2).contiguous(), b_in, c_in, s0)
    before = skern.ssd_scan.launches
    y, st = ssm._ssd_chunk_scan(*args, chunk=64, kernel=True)
    yp, stp = ssm._ssd_chunk_scan(*args, chunk=64)
    y_cpu, st_cpu = ssm._ssd_chunk_scan(*(t.cpu() for t in args), chunk=64)
    torch.cuda.synchronize()
    assert skern.ssd_scan.launches == before + 1 and y.shape == (2, 128, 3, 64)
    torch.testing.assert_close(yp.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(stp.cpu(), st_cpu, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st.cpu(), st_cpu, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the rest of the flow zoo and the UQ layer on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 7, 24, 32])
def test_realnvp_kernel_training_on_the_card(dev, d):
    """RealNVP's kernel path (depth 4, hidden 32, ``coupled``,
    ``kernel_training``) on (512, D): a train step on the card against the
    same parameters on the CPU (loss at 1e-5 relative, each gradient leaf at
    1e-4 of its largest entry), one ``coupling_fwd`` and one
    ``coupling_bwd`` a coupling: at D = 24 the unflipped couplings on the
    row stream (M = 1), every other on the half kernels; the round trip."""
    import copy

    from repro_torch.core import build_realnvp, value_and_grad_nll

    g = torch.Generator().manual_seed(d)
    flow_cpu = build_realnvp(d, depth=4, hidden=32, grad_mode="coupled", kernel_training=True,
                             generator=g, device="cpu")
    with torch.no_grad():
        for p in flow_cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    flow = copy.deepcopy(flow_cpu).to(dev)
    x_cpu = torch.randn(512, d, generator=g)
    for k in ckern.KERNELS:
        k.launches_by_path = dict.fromkeys(k.launches_by_path, 0)
    loss, grads = value_and_grad_nll(flow, x_cpu.to(dev))
    torch.cuda.synchronize()
    rows = 2 if d == 24 else 0
    assert ckern.coupling_fwd.launches_by_path == {"rows": rows, "tile": 4 - rows}
    assert ckern.coupling_bwd.launches_by_path == {"rows": rows, "tile": 4 - rows}
    assert sum(ckern.coupling_inv.launches_by_path.values()) == 0
    loss_cpu, grads_cpu = value_and_grad_nll(flow_cpu, x_cpu)
    assert abs(loss.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item())
    for name, r in grads_cpu.items():
        assert (grads[name].cpu() - r).abs().max() <= 1e-4 * r.abs().max(), name
    with torch.no_grad():
        z, _ = flow(x_cpu.to(dev))
        torch.testing.assert_close(flow.inverse(z).cpu(), x_cpu, rtol=0, atol=1e-4)


def test_hyperbolic_train_step_on_the_card(dev):
    """A coupled leapfrog network (depth 6, 3x3 convolutions) on the pair
    state of (2, 32, 32, 3) images: the card against the CPU (loss at 1e-5
    relative, each gradient leaf at 1e-4 of its largest entry), and the
    round trip."""
    import copy

    from repro_torch.core import build_hyperbolic, value_and_grad_nll

    torch.backends.cudnn.allow_tf32 = False  # the convolutions in f32, as on the CPU
    g = torch.Generator().manual_seed(7)
    flow_cpu = build_hyperbolic(3, depth=6, grad_mode="coupled", generator=g, device="cpu")
    flow = copy.deepcopy(flow_cpu).to(dev)
    x_cpu = tuple(torch.rand(2, 32, 32, 3, generator=g) - 0.5 for _ in range(2))
    x = tuple(v.to(dev) for v in x_cpu)
    loss, grads = value_and_grad_nll(flow, x)
    loss_cpu, grads_cpu = value_and_grad_nll(flow_cpu, x_cpu)
    assert abs(loss.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item())
    for name, r in grads_cpu.items():
        assert (grads[name].cpu() - r).abs().max() <= 1e-4 * r.abs().max(), name
    with torch.no_grad():
        back = flow.inverse(flow(x)[0])
    for a, b in zip(back, x):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_uq_scenarios_on_the_card(dev, tmp_path):
    """``lg-smoke`` trained a few steps on the card (one ``coupling_bwd`` a
    cross node a step: depth 2, recursion 1 at d_theta 4, so one node a
    block), restored bitwise, and reported (one ``coupling_inv`` a cross
    node a sampler call), the streamed moments equal to the chunks
    concatenated; a tiny scanned image prior sampled through its flow-step
    kernels (one ``flowstep_inv`` a step a chunk)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import HINTCoupling
    from repro_torch.kernels.flowstep import flowstep as fkern
    from repro_torch.uq import (PosteriorEngine, get_scenario, posterior_report, prior_report,
                                restore_scenario, train_scenario)
    from repro_torch.uq.scenarios import build_conditional_model

    sc = get_scenario("lg-smoke")
    nodes = sum(1 for m in build_conditional_model(sc, device="cpu").flow.modules()
                if isinstance(m, HINTCoupling) and not m.is_leaf)
    assert nodes == 2
    for k in ckern.KERNELS:
        k.launches_by_path = dict.fromkeys(k.launches_by_path, 0)
    run = train_scenario(sc, steps=3, ckpt_dir=str(tmp_path / "lg"), device=dev)
    torch.cuda.synchronize()
    assert ckern.coupling_bwd.launches_by_path == {"rows": 0, "tile": 3 * nodes}
    restored = restore_scenario(sc, str(tmp_path / "lg"), device=dev)
    for key, v in run.params.items():
        assert torch.equal(v, restored.params[key]), key
    y = restored.problem.batch_at(10_000)["y"][:1]
    for k in ckern.KERNELS:
        k.launches_by_path = dict.fromkeys(k.launches_by_path, 0)
    stats, report = posterior_report(restored, y_obs=y, n_samples=2500, chunk=1000, sbc_sims=40,
                                     sbc_draws=16)
    torch.cuda.synchronize()
    calls = 3 + 2 * 2  # three chunks, then two SBC and two coverage calls
    assert ckern.coupling_inv.launches_by_path == {"rows": 0, "tile": calls * nodes}
    chunks = list(PosteriorEngine(restored.model, y=y, theta_dim=4).sample_chunks(
        torch.Generator().manual_seed(0), 2500, 1000))
    flat = np.concatenate(chunks).astype(np.float64)
    np.testing.assert_allclose(stats.mean, flat.mean(0), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(stats.var, flat.var(0, ddof=1), rtol=1e-6)
    assert report.ranks.shape == (40, 4) and np.all(np.isfinite(report.pvalues))
    prior = get_scenario("images-prior-scanned")
    tiny = dataclasses.replace(prior, flow=dataclasses.replace(prior.flow, n_scales=2, k_steps=2,
                                                               hidden=8), image_size=8, batch=4)
    prun = train_scenario(tiny, steps=2, ckpt_dir=str(tmp_path / "prior"), device=dev)
    fkern.flowstep_inv.launches = 0
    st = prior_report(prun, n_samples=128, chunk=64)
    torch.cuda.synchronize()
    assert fkern.flowstep_inv.launches == 2 * 4 and np.all(np.isfinite(st.mean))


def test_moe_dispatch_is_bitwise_repeatable_on_the_card(dev):
    """``moe_apply`` at granite-moe-1b-a400m's expert widths (32 experts,
    top-8, d_model 1024, expert d_ff 512), batch 2 x 256 in bf16, with a
    capacity that drops tokens: output, aux and the gradients of x and the
    router are the same bits on two runs (dispatch writes distinct slots,
    combine gathers and sums over k in order: no atomics), and within 1e-4
    (f32) of the CPU on the same inputs."""
    from repro_torch.config import MoEConfig
    from repro_torch.nn.moe import moe_apply, moe_init

    outs = {}
    for dtype, cap in ((torch.bfloat16, 1.25), (torch.float32, 0.5)):
        cfg = MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, capacity_factor=cap)
        p = moe_init(torch.Generator().manual_seed(0), 1024, cfg, "swiglu")
        x = torch.randn(2, 256, 1024, generator=torch.Generator().manual_seed(1))

        def run(device):
            pd = {"router": p["router"].to(device).requires_grad_(),
                  "experts": {k: v.to(device) for k, v in p["experts"].items()}}
            xd = x.to(device, dtype).requires_grad_()
            y, aux = moe_apply(pd, xd, cfg, "swiglu")
            gx, gr = torch.autograd.grad((y.float().square().sum() + aux.sum()),
                                         [xd, pd["router"]])
            return [t.detach().float().cpu() for t in (y, aux, gx, gr)]

        first, second = run(dev), run(dev)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), dtype
        outs[dtype] = (first, run("cpu"))
    card, cpu = outs[torch.float32]
    for a, b in zip(card, cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_ssm_training_on_the_card_launches_no_scan_kernel(dev):
    """rwkv6-7b and zamba2-7b ``REDUCED`` train on the card through their
    plain scans, as the reference trains through ``lax.scan``: ``train_lm``
    runs its steps with 0 ``wkv_scan`` / ``ssd_scan`` launches, finite
    losses; a train step's loss in f32 matches the CPU's at 1e-5 relative
    under ``invertible`` and ``autodiff`` (the gradients' f32 conditioning
    and their gate are ``chip_smoke.py``'s ssm-a); serving the same model
    launches the kernels."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import train_lm

    for arch, kernel in (("rwkv6-7b", rkern.wkv_scan), ("zamba2-7b", skern.ssd_scan)):
        model, cfg = build_model(get_arch(arch).reduced, device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
        data = SyntheticTokens(cfg.vocab_size, 32, 2)
        before = kernel.launches
        res = train_lm(model, data, TrainConfig(steps=3, prefetch=0), device=dev)
        torch.cuda.synchronize()
        assert kernel.launches == before and len(res.losses) == 3
        assert all(torch.isfinite(torch.tensor(res.losses)))
        ServeEngine(model, 40, device=dev).generate({"tokens": data.batch_at(0)["tokens"]}, 2)
        torch.cuda.synchronize()
        assert kernel.launches == before + cfg.n_layers * (1 + (2 if arch == "rwkv6-7b" else 0))
        cpu, _ = build_model(cfg, device="cpu", dtype="float32")
        card, _ = build_model(cfg, device=dev, dtype="float32")
        card.load_state_dict(cpu.state_dict())
        batch = data.batch_at(1)
        for mode in ("invertible", "autodiff"):
            loss_c, _ = cpu.train_loss(batch, grad_mode=mode)
            b_dev = {k: v.to(dev) for k, v in batch.items()}
            loss_d, _ = card.train_loss(b_dev, grad_mode=mode)
            grads = torch.autograd.grad(loss_d, list(card.parameters()))
            assert abs(float(loss_d.cpu() - loss_c)) <= 1e-5 * abs(float(loss_c)), (arch, mode)
            assert all(bool(torch.isfinite(g).all()) for g in grads), (arch, mode)


def test_lm_train_step_on_the_card_matches_the_cpu(dev):
    """granite-moe-1b-a400m ``REDUCED`` in f32: ``train_loss`` and every
    gradient leaf on the card against the CPU under each engine (loss at
    1e-5 relative, each leaf at 1e-4 of its largest entry), and bitwise
    repeatable on the card."""
    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model

    model, cfg = build_model(get_arch("granite-moe-1b-a400m").reduced, device="cpu",
                             dtype="float32", generator=torch.Generator().manual_seed(0))
    batch = SyntheticTokens(cfg.vocab_size, 64, 2, seed=2).batch_at(0)
    card = build_model(cfg, device=dev)[0]
    card.load_state_dict(model.state_dict())

    def step(m, b, mode):
        loss, _ = m.train_loss(b, grad_mode=mode)
        return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, list(m.parameters()))]

    for mode in ("invertible", "coupled", "remat", "autodiff"):
        loss_c, g_c = step(model, batch, mode)
        b_dev = {k: v.to(dev) for k, v in batch.items()}
        loss_d, g_d = step(card, b_dev, mode)
        again = step(card, b_dev, mode)
        assert torch.equal(loss_d, again[0]) and all(torch.equal(a, b) for a, b in zip(g_d, again[1]))
        assert abs(float(loss_d - loss_c)) <= 1e-5 * abs(float(loss_c)), mode
        for a, b in zip(g_d, g_c):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), mode

"""The port's kernel guards and tile plans, on the CPU.

* ``forward_only``: a kernel with no backward kernel is called through an
  ``autograd.Function`` whose backward raises, so a gradient through it on
  the card raises instead of silently vanishing; the forward and its
  launches are unchanged.  The three LM ops (``flash_sdpa``, ``rwkv6_wkv``,
  ``mamba2_ssd``) take it on their card path.
* Their plain paths (the CPU's) stay differentiable: their gradients match
  ``jax.vjp`` through the reference's ``kernels/{attention,rwkv,ssd}/ref.py``
  on the same inputs and cotangents, in f32, within 1e-4 of each gradient's
  largest entry (sums of up to 64 steps or keys, taken in another order).
* Python mirrors of the reworked kernels' launch plans: the tensor-core
  flash kernel's shared memory per instantiation, the conv1x1 stream's walk
  over row tiles (every row exactly once, for ragged N and any grid), and
  both wrappers' path rules by dtype, width and alignment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro.kernels.rwkv.ref import wkv_ref as j_wkv_ref
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro_torch.kernels import common
from repro_torch.kernels.attention import attention as akern
from repro_torch.kernels.attention import ops as aops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.conv1x1 import conv1x1 as ckern
from repro_torch.kernels.rwkv import ops as rops
from repro_torch.kernels.rwkv import rwkv as rkern
from repro_torch.kernels.rwkv.ref import wkv_ref
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_ref

SEED = 20261017
TOL_GRAD = 1e-4  # of each gradient's largest entry


# ---- forward_only -----------------------------------------------------------

def _toy(calls):
    def fn(x, y=None, scale=2.0):
        calls.append(1)
        out = x * scale
        return out if y is None else (out, out + y)

    return fn


def test_forward_only_keeps_the_forward_and_its_calls():
    calls, guarded_calls = [], []
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    y = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    guarded = common.forward_only(_toy(guarded_calls), "toy_kernel")
    plain = _toy(calls)
    a, b = guarded(x, y=y, scale=3.0)
    a_r, b_r = plain(x, y=y, scale=3.0)
    assert torch.equal(a, a_r) and torch.equal(b, b_r)
    with torch.no_grad():
        assert torch.equal(guarded(x, scale=3.0), plain(x, scale=3.0))
    with torch.inference_mode():
        assert torch.equal(guarded(x), plain(x))
    assert len(guarded_calls) == len(calls) == 3


@pytest.mark.parametrize("which", ["positional", "keyword"])
def test_forward_only_backward_raises_with_the_kernel_name(which):
    x = torch.randn(3, 4, requires_grad=(which == "positional"))
    y = torch.randn(3, 4, requires_grad=(which == "keyword"))
    guarded = common.forward_only(_toy([]), "toy_kernel")
    a, b = guarded(x, y=y)
    assert b.requires_grad
    with pytest.raises(NotImplementedError,
                       match=r"toy_kernel has no backward on the card.*scan_on_kernel"):
        b.sum().backward()


def _fake_card(monkeypatch, ops, kernel, plain):
    """Send ``ops``' CPU tensors down its card path, with the kernel's
    launch replaced by its plain version."""
    monkeypatch.setattr(ops, "use_plain", lambda *ts: False)
    monkeypatch.setattr(type(kernel), "__call__", lambda self, *a, **kw: plain(*a, **kw))


def test_the_lm_ops_take_the_guard_on_their_card_path(monkeypatch):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g, requires_grad=True) for _ in range(3))
    _fake_card(monkeypatch, aops, akern.flash_attention,
               lambda q, k, v, causal=True: attention_ref(q, k, v, causal))
    with pytest.raises(NotImplementedError, match="flash_attention"):
        aops.flash_sdpa(q, k, v).sum().backward()

    r, kk, vv, w = (torch.rand(1, 2, 5, 16, generator=g, requires_grad=True) for _ in range(4))
    u = torch.randn(2, 16, generator=g)
    _fake_card(monkeypatch, rops, rkern.wkv_scan,
               lambda r, k, v, w, u, chunk=64, state0=None: wkv_ref(r, k, v, w, u, state0))
    with pytest.raises(NotImplementedError, match="wkv_scan"):
        rops.rwkv6_wkv(r, kk, vv, w, u)[0].sum().backward()
    # a state that requires grad alone, passed by keyword, is guarded too
    s0 = torch.zeros(1, 2, 16, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="wkv_scan"):
        rops.rwkv6_wkv(*(t.detach() for t in (r, kk, vv, w)), u, state0=s0)[1].sum().backward()

    x = torch.randn(1, 2, 8, 4, generator=g, requires_grad=True)
    da, dt = -torch.rand(1, 2, 8, generator=g), torch.rand(1, 2, 8, generator=g)
    b_in, c_in = torch.randn(1, 8, 4, generator=g), torch.randn(1, 8, 4, generator=g)
    _fake_card(monkeypatch, sops, skern.ssd_scan,
               lambda x, da, dt, b, c, chunk=128, state0=None: ssd_ref(x, da, dt, b, c, state0))
    with pytest.raises(NotImplementedError, match="ssd_scan"):
        sops.mamba2_ssd(x, da, dt, b_in, c_in, chunk=8)[0].sum().backward()


# ---- the plain paths' gradients against the reference's -----------------------

def _grads_close(got, ref):
    for name, a, r in zip(ref, got, ref.values()):
        r = np.asarray(r, np.float32)
        err = np.abs(a.detach().numpy() - r).max()
        assert err <= TOL_GRAD * max(1.0, np.abs(r).max()), (name, err)


def _torch_grads(fn, inputs, cots):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    outs = fn(**leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, list(leaves.values()))


def _jax_grads(fn, inputs, cots):
    names = list(inputs)

    def f(*args):
        return fn(**dict(zip(names, args)))

    _, vjp = jax.vjp(f, *(jnp.asarray(v) for v in inputs.values()))
    cot = tuple(jnp.asarray(c) for c in cots)
    return dict(zip(names, vjp(cot if len(cot) > 1 else cot[0])))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 2, 24, 24, 16), (1, 6, 3, 16, 32, 32)])
def test_flash_sdpa_plain_gradients_match_the_reference(shape, causal):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(SEED)
    inputs = {"q": rng.standard_normal((b, hq, sq, d), np.float32),
              "k": rng.standard_normal((b, hkv, skv, d), np.float32),
              "v": rng.standard_normal((b, hkv, skv, d), np.float32)}
    cots = [rng.standard_normal((b, hq, sq, d), np.float32)]
    got = _torch_grads(lambda q, k, v: aops.flash_sdpa(q, k, v, causal=causal), inputs, cots)
    ref = _jax_grads(lambda q, k, v: j_attention_ref(q, k, v, causal=causal), inputs, cots)
    _grads_close(got, ref)


@pytest.mark.parametrize("shape", [(1, 2, 16, 16), (2, 3, 9, 32)])
def test_rwkv6_wkv_plain_gradients_match_the_reference(shape):
    b, h, s, kd = shape
    rng = np.random.default_rng(SEED + 1)
    inputs = {n: rng.standard_normal(shape, np.float32) for n in ("r", "k", "v")}
    inputs["w"] = (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    inputs["u"] = (0.1 * rng.standard_normal((h, kd))).astype(np.float32)
    cots = [rng.standard_normal(shape, np.float32), rng.standard_normal((b, h, kd, kd), np.float32)]
    got = _torch_grads(lambda r, k, v, w, u: rops.rwkv6_wkv(r, k, v, w, u), inputs, cots)
    ref = _jax_grads(j_wkv_ref, inputs, cots)
    _grads_close(got, ref)


@pytest.mark.parametrize("shape", [(1, 2, 16, 8, 8, 8), (2, 3, 24, 16, 4, 12)])
def test_mamba2_ssd_plain_gradients_match_the_reference(shape):
    b, h, s, p, n, chunk = shape
    rng = np.random.default_rng(SEED + 2)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    inputs = {"x": rng.standard_normal((b, h, s, p), np.float32),
              "da": (-dt * np.exp(0.2 * rng.standard_normal((b, h, s)))).astype(np.float32),
              "dt": dt,
              "b_in": rng.standard_normal((b, s, n), np.float32),
              "c_in": rng.standard_normal((b, s, n), np.float32)}
    cots = [rng.standard_normal((b, h, s, p), np.float32),
            rng.standard_normal((b, h, p, n), np.float32)]
    got = _torch_grads(lambda x, da, dt, b_in, c_in: sops.mamba2_ssd(x, da, dt, b_in, c_in,
                                                                     chunk=chunk), inputs, cots)
    ref = _jax_grads(j_ssd_ref, inputs, cots)
    _grads_close(got, ref)


# ---- launch plans -----------------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 112, 128])
def test_tensor_core_flash_fits_in_shared_memory(d):
    d_pad = akern.tc_head_dim(d)
    assert d_pad in (64, 128) and d <= d_pad
    assert akern.tc_smem_bytes(d_pad) <= akern.SMEM_LIMIT
    # Q and every stage of K and V, 128 rows of d_pad bf16 columns each
    tiles = 1 + 2 * akern.TC_STAGES
    assert akern.tc_smem_bytes(d_pad) >= tiles * akern.TC_ROWS * d_pad * 2


def _bf16(shape, offset=0, pad=0):
    """A bf16 (B, H, S, D) view starting ``offset`` elements into its buffer,
    each row ``pad`` elements longer than D."""
    b, h, s, d = shape
    buf = torch.zeros(b * h * s * (d + pad) + offset, dtype=torch.bfloat16)
    return buf[offset:].view(b, h, s, d + pad)[..., :d]


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_flash_path_rule(d):
    q = _bf16((2, 4, 64, d))
    assert akern.flash_path(q, q, q) == "tensor_core"
    # (B, S, H, D) viewed as (B, H, S, D), as attn_apply passes them
    t = torch.zeros(2, 64, 4, d, dtype=torch.bfloat16).transpose(1, 2)
    assert akern.flash_path(t, t, t) == "tensor_core"
    # f32 at these head dims (multiples of 8) takes the TF32 kernel
    assert akern.flash_path(q.float(), q.float(), q.float()) == "tf32"
    # a batch of one: its stride is never stepped, whatever it is
    one = torch.zeros(4 * 64 * d, dtype=torch.bfloat16).as_strided((1, 4, 64, d),
                                                                   (3, 64 * d, d, 1))
    assert akern.flash_path(one, one, one) == "tensor_core"


@pytest.mark.parametrize("d", [4, 20, 36, 100])
def test_flash_path_keeps_cuda_cores_for_other_bf16_head_dims(d):
    q = _bf16((1, 2, 16, d))
    assert akern.flash_path(q, q, q) == "cuda_core"


def test_flash_path_refuses_what_tma_cannot_take():
    """The tensor-core path refuses a view TMA cannot copy: the call goes to
    the CUDA-core kernel, whose scalar loads take any base and strides."""
    good = _bf16((2, 4, 64, 64))
    # q's base 8 bytes off
    assert not akern.tma_takes(_bf16((2, 4, 64, 64), offset=4))
    assert akern.flash_path(_bf16((2, 4, 64, 64), offset=4), good, good) == "cuda_core"
    # v's rows 136 bytes apart
    assert not akern.tma_takes(_bf16((2, 4, 64, 64), pad=4))
    assert akern.flash_path(good, good, _bf16((2, 4, 64, 64), pad=4)) == "cuda_core"
    # k's rows 144 bytes apart, a multiple of 16
    assert akern.flash_path(good, _bf16((2, 4, 64, 64), pad=8), good) == "tensor_core"


@pytest.mark.parametrize("c", ckern.STREAM_WIDTHS)
@pytest.mark.parametrize("n_rows", [1, 7, 31, 32, 33, 300, 1000, 8 * 1024 + 5])
@pytest.mark.parametrize("grid", [1, 3, 132])
def test_conv1x1_stream_walk_covers_every_row_once(c, n_rows, grid):
    seen = np.zeros(n_rows, np.int64)
    for tiles in ckern.stream_walk(n_rows, c, grid):
        for r0, r1 in tiles:
            assert r0 < r1 <= n_rows and r1 - r0 <= ckern.stream_rows(c)
            seen[r0:r1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("c", ckern.STREAM_WIDTHS)
def test_conv1x1_stream_plan(c):
    out, rpl, warps = ckern.STREAM_PLAN[c]
    # 32 lanes, each ``out`` columns of ``rpl`` whole rows: a tile of whole rows
    assert c % out == 0 and 32 % (c // out) == 0
    assert ckern.stream_rows(c) * c == 32 * out * rpl
    # a tile is a whole number of 16-byte copies in either storage type
    assert ckern.stream_rows(c) * c * 2 % 16 == 0
    # each stream block fits in the shared memory a block may take on the card
    assert ckern.stream_smem_bytes(c, 4) <= akern.SMEM_LIMIT


def test_conv1x1_mm_path_rule():
    for c in ckern.STREAM_WIDTHS:
        assert ckern.mm_path(torch.zeros(2, 5, c)) == "stream"
        assert ckern.mm_path(torch.zeros(2, 5, c, dtype=torch.bfloat16)) == "stream"
        # x 4 bytes off a 16-byte boundary: the panel kernel
        assert ckern.mm_path(torch.zeros(2 * 5 * c + 1)[1:].view(2, 5, c)) == "panel"
    for c in (8, 16, 192):
        assert ckern.mm_path(torch.zeros(2, 5, c)) == "panel"

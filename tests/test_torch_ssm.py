"""The port's state-space mixers against the JAX reference on the CPU: the
plain wkv and SSD scans (the CPU paths of ``rwkv6_wkv`` and ``mamba2_ssd``)
against the reference's Pallas kernels in interpret mode and its oracles,
with and without an initial state against its model-path scans, and the
mixers of ``nn/ssm.py`` (``_causal_conv``, ``_token_shift``, the chunked
wkv, ``mamba2_apply``, ``rwkv6_time_mix``, ``rwkv6_channel_mix``, the state
builders).  Inputs and weights come from numpy with a seed and are handed to
both packages.

Tolerances: the scans at the reference's own kernel bound
(``tests/test_kernels.py:305``: 2e-4 in f32, 5e-2 in bf16, rtol = atol);
the mixers at 1e-5 of each output's largest entry in f32 (sums of width
16-128 in another order) and 3e-2 in bf16 (a few bf16 ulps of the largest
entry, the same bound as the LM logits in ``test_torch_lm.py``); shifts,
conv states and integer-valued bookkeeping exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JSSMConfig
from repro.kernels.rwkv.ops import rwkv6_wkv as j_rwkv6_wkv
from repro.kernels.rwkv.ref import wkv_ref as j_wkv_ref
from repro.kernels.ssd.ops import mamba2_ssd as j_mamba2_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.nn import ssm as jssm
from repro_torch.config import SSMConfig
from repro_torch.kernels.rwkv import rwkv as rwkv_kern
from repro_torch.kernels.rwkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv.ref import wkv_ref
from repro_torch.kernels.ssd import ssd as ssd_kern
from repro_torch.kernels.ssd.ops import mamba2_ssd
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.nn import ssm

torch.set_num_threads(4)
SEED = 20261017
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MAMBA = dict(kind="mamba2", d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
RWKV = dict(kind="rwkv6", expand=1, head_dim=16)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _pair(a, dtype: str = "float32"):
    """One numpy array as a JAX and a torch tensor of ``dtype`` (bf16
    rounded once, in JAX, so both sides hold the same values)."""
    j = jnp.asarray(np.asarray(a, np.float32), DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


def _kernel_tol(dtype: str) -> dict:
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _close(a, b, dtype: str):
    np.testing.assert_allclose(_np(a), _np(b), **_kernel_tol(dtype))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


MIX_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _wkv_inputs(shape, rng, layout="bhsk"):
    """r, k, v (standard normal), w = sigmoid(normal), u (H, K) and a
    nonzero state0, as numpy; ``layout`` "bshk" puts time before heads."""
    b, h, s, kd = shape
    lead = (b, h, s, kd) if layout == "bhsk" else (b, s, h, kd)
    r, k, v = (rng.standard_normal(lead).astype(np.float32) for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal(lead))).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, kd))).astype(np.float32)
    state0 = (0.5 * rng.standard_normal((b, h, kd, kd))).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, state0


def _ssd_inputs(shape, rng, layout="bhs"):
    """x, da (negative), dt (softplus), b_in, c_in and a nonzero state0."""
    b, h, s, p, n = shape
    xs = (b, h, s, p) if layout == "bhs" else (b, s, h, p)
    hs = (b, h, s) if layout == "bhs" else (b, s, h)
    x = rng.standard_normal(xs).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(hs))).astype(np.float32)
    da = (-dt * np.exp(0.2 * rng.standard_normal(hs))).astype(np.float32)
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state0 = (0.5 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    return x, da, dt, b_in, c_in, state0


# ---------------------------------------------------------------------------
# the scans against the reference's kernels and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 16), (2, 4, 64, 32)])
def test_wkv_plain_matches_the_reference_kernel(shape, dtype):
    """``wkv_ref`` and ``rwkv6_wkv``'s CPU path against the reference's
    Pallas ``wkv_scan`` (interpret mode) and its ``wkv_ref``, on the
    reference's kernel-test shapes (``tests/test_kernels.py:363``)."""
    r, k, v, w, u, _ = _wkv_inputs(shape, np.random.default_rng(SEED))
    (jr, tr), (jk, tk), (jv, tv), (jw, tw) = (_pair(a, dtype) for a in (r, k, v, w))
    ju, tu = _pair(u)
    jy, jst = j_rwkv6_wkv(jr, jk, jv, jw, ju, chunk=32)
    jy_ref, jst_ref = j_wkv_ref(jr, jk, jv, jw, ju)
    y, st = rwkv6_wkv(tr, tk, tv, tw, tu, chunk=32)
    y_ref, st_ref = wkv_ref(tr, tk, tv, tw, tu)
    assert y.dtype == torch.float32 and st.shape == (shape[0], shape[1], shape[3], shape[3])
    assert rwkv_kern.wkv_scan.launches == 0
    for a, b in ((y, jy), (st, jst), (y_ref, jy_ref), (st_ref, jst_ref)):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 16, 16), (2, 4, 128, 32, 16)])
def test_ssd_plain_matches_the_reference_kernel(shape, dtype):
    """``ssd_ref`` and ``mamba2_ssd``'s CPU path against the reference's
    Pallas ``ssd_scan`` (interpret mode) and its ``ssd_ref``, on the
    reference's kernel-test shapes (``tests/test_kernels.py:299``); y comes
    back in x's dtype, as the kernel returns it."""
    x, da, dt, b_in, c_in, _ = _ssd_inputs(shape, np.random.default_rng(SEED + 1))
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dtype) for a in (x, b_in, c_in))
    (jda, tda), (jdt, tdt) = _pair(da), _pair(dt)
    jy, jst = j_mamba2_ssd(jx, jda, jdt, jb, jc, chunk=64)
    jy_ref, jst_ref = j_ssd_ref(jx.astype(jnp.float32), jda, jdt, jb.astype(jnp.float32),
                                jc.astype(jnp.float32))
    y, st = mamba2_ssd(tx, tda, tdt, tb, tc, chunk=64)
    y_ref, st_ref = ssd_ref(tx, tda, tdt, tb, tc)
    assert y.dtype == DTYPES[dtype][1] and st.dtype == torch.float32
    assert ssd_kern.ssd_scan.launches == 0
    for a, b in ((y, jy), (st, jst), (y_ref, jy_ref), (st_ref, jst_ref)):
        _close(a, b, dtype)


def test_wkv_with_a_state_matches_the_model_scan():
    """With a nonzero initial state, ``rwkv6_wkv`` (on (B, H, S, K) views)
    and the port's ``_wkv_scan`` against the reference's ``_wkv_scan``."""
    r, k, v, w, u, state0 = _wkv_inputs((2, 3, 24, 16), np.random.default_rng(SEED + 2), "bshk")
    jargs, targs = zip(*(_pair(a) for a in (r, k, v, w, u, state0)))
    jy, jst = jssm._wkv_scan(*jargs)
    y, st = ssm._wkv_scan(*targs)
    _close(y, jy, "float32")
    _close(st, jst, "float32")
    tr, tk, tv, tw, tu, ts = targs
    yk, stk = rwkv6_wkv(*(t.transpose(1, 2) for t in (tr, tk, tv, tw)), tu, state0=ts)
    _close(yk.transpose(1, 2), jy, "float32")
    _close(stk, jst, "float32")


def test_ssd_with_a_state_matches_the_model_scan():
    """With a nonzero initial state, ``mamba2_ssd`` (on (B, H, S, ·) views)
    and the port's ``_ssd_chunk_scan`` against the reference's
    ``_ssd_chunk_scan``."""
    x, da, dt, b_in, c_in, state0 = _ssd_inputs((2, 3, 64, 16, 16),
                                                np.random.default_rng(SEED + 3), "bsh")
    jargs, targs = zip(*(_pair(a) for a in (x, da, dt, b_in, c_in, state0)))
    jy, jst = jssm._ssd_chunk_scan(*jargs, chunk=16)
    y, st = ssm._ssd_chunk_scan(*targs, chunk=16)
    _close(y, jy, "float32")
    _close(st, jst, "float32")
    tx, tda, tdt, tb, tc, ts = targs
    yk, stk = mamba2_ssd(tx.transpose(1, 2), tda.transpose(1, 2), tdt.transpose(1, 2), tb, tc,
                         chunk=16, state0=ts)
    _close(yk.transpose(1, 2), jy, "float32")
    _close(stk, jst, "float32")


def test_ssd_chunk_must_divide_the_sequence_as_in_the_reference():
    x, da, dt, b_in, c_in, state0 = _ssd_inputs((1, 2, 24, 16, 16),
                                                np.random.default_rng(SEED + 4), "bsh")
    jargs, targs = zip(*(_pair(a) for a in (x, da, dt, b_in, c_in, state0)))
    with pytest.raises(AssertionError):
        jssm._ssd_chunk_scan(*jargs, chunk=16)
    with pytest.raises(ValueError, match="not divisible"):
        ssm._ssd_chunk_scan(*targs, chunk=16)
    tx, tda, tdt, tb, tc, _ = targs
    with pytest.raises(ValueError, match="not divisible"):
        mamba2_ssd(tx.transpose(1, 2), tda.transpose(1, 2), tdt.transpose(1, 2), tb, tc, chunk=16)


@pytest.mark.parametrize("s,chunk", [(13, 4), (16, 16), (5, 8)])
def test_chunked_wkv_matches_the_reference(s, chunk):
    """``_wkv_scan_chunked``, S a multiple of the chunk or not (padding with
    w = 1), against the reference's, and against the per-token scan."""
    r, k, v, w, u, state0 = _wkv_inputs((2, 2, s, 16), np.random.default_rng(SEED + s), "bshk")
    jargs, targs = zip(*(_pair(a) for a in (r, k, v, w, u, state0)))
    jy, jst = jssm._wkv_scan_chunked(*jargs, chunk=chunk)
    y, st = ssm._wkv_scan_chunked(*targs, chunk=chunk)
    assert y.shape == (2, s, 2, 16)
    _close(y, jy, "float32")
    _close(st, jst, "float32")
    y1, st1 = ssm._wkv_scan(*targs)
    _close(y, y1, "float32")
    _close(st, st1, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_reference(with_state, dtype):
    rng = np.random.default_rng(SEED + 5)
    jx, tx = _pair(rng.standard_normal((2, 7, 12)), dtype)
    jw, tw = _pair(0.3 * rng.standard_normal((4, 12)))
    jb, tb = _pair(0.1 * rng.standard_normal(12))
    js, ts = _pair(rng.standard_normal((2, 3, 12)), dtype) if with_state else (None, None)
    jy, jnew = jssm._causal_conv(jx, jw, jb, js)
    y, new = ssm._causal_conv(tx, tw, tb, ts)
    assert y.dtype == DTYPES[dtype][1] and new.shape == (2, 3, 12)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=1e-6 if dtype == "float32" else 0)
    np.testing.assert_array_equal(_np(new), _np(jnew))


@pytest.mark.parametrize("with_last", [False, True])
def test_token_shift_matches_the_reference(with_last):
    rng = np.random.default_rng(SEED + 6)
    jx, tx = _pair(rng.standard_normal((2, 5, 8)), "bfloat16")
    jl, tl = _pair(rng.standard_normal((2, 8))) if with_last else (None, None)
    jxx, jlast = jssm._token_shift(jx, jl)
    xx, last = ssm._token_shift(tx, tl)
    assert xx.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(xx), _np(jxx))
    np.testing.assert_array_equal(_np(last), _np(jlast))


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _perturbed(tree: dict, rng, scale: float = 0.05) -> dict:
    """Every leaf plus noise, so the ones, zeros and constants of the init
    (norm gains, lerp weights, decays, biases) take distinct values."""
    return {k: (np.asarray(v) + scale * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


def _params(tree: dict):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _state_pair(jstate, rng, dtype):
    """A nonzero state shaped like the reference's builder, in both packages
    (f32 leaves stay f32; the others take ``dtype``)."""
    def leaf(v):
        a = rng.standard_normal(v.shape).astype(np.float32)
        return _pair(a, dtype if v.dtype == jnp.bfloat16 else "float32")

    def walk(tree):
        out_j, out_t = {}, {}
        for k, v in tree.items():
            out_j[k], out_t[k] = walk(v) if isinstance(v, dict) else leaf(v)
        return out_j, out_t

    return walk(jstate)


def _check_state(new, jnew, dtype):
    for key, jv in jnew.items():
        if isinstance(jv, dict):
            _check_state(new[key], jv, dtype)
            continue
        v = new[key]
        assert v.dtype == (torch.float32 if jv.dtype == jnp.float32 else DTYPES[dtype][1]), key
        assert _rel(v, jv) <= MIX_TOL[dtype], key


MAMBA_CASES = [(16, False), (16, True), (1, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,with_state", MAMBA_CASES)
def test_mamba2_apply_matches_the_reference(s, with_state, dtype):
    """S > 1 without a state (training form), S > 1 from a state (prefill
    after a prefix; two chunks of 8) and S = 1 (the decode recurrence)."""
    rng = np.random.default_rng(SEED + 7 + s)
    jcfg, cfg = JSSMConfig(**MAMBA), SSMConfig(**MAMBA)
    tree = _perturbed(jssm.mamba2_init(jax.random.PRNGKey(1), 32, jcfg), rng)
    jp, tp = _params(tree)
    jx, tx = _pair(rng.standard_normal((2, s, 32)), dtype)
    jstate, tstate = (None, None)
    if with_state:
        jstate, tstate = _state_pair(jssm.mamba2_state(jcfg, 32, 2, DTYPES[dtype][0]), rng, dtype)
    jy, jnew = jssm.mamba2_apply(jp, jx, jcfg, jstate)
    y, new = ssm.mamba2_apply(tp, tx, cfg, tstate)
    assert y.dtype == DTYPES[dtype][1] and _rel(y, jy) <= MIX_TOL[dtype]
    assert (new is None) == (jnew is None)
    if with_state:
        _check_state(new, jnew, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wkv_chunk,s,with_state", [(0, 12, False), (0, 12, True), (0, 1, True),
                                                    (16, 12, True), (16, 1, True)])
def test_rwkv6_time_mix_matches_the_reference(wkv_chunk, s, with_state, dtype):
    """The per-token (``wkv_chunk`` 0) and chunked (16, with S = 12 not a
    multiple of it) scans, without and with a state, and S = 1."""
    rng = np.random.default_rng(SEED + 8 + s + wkv_chunk)
    jcfg = JSSMConfig(**RWKV, wkv_chunk=wkv_chunk)
    cfg = SSMConfig(**RWKV, wkv_chunk=wkv_chunk)
    full = jssm.rwkv6_init(jax.random.PRNGKey(2), 64, jcfg, 128)
    tree = _perturbed({k: full[k] for k in ssm.RWKV_TIME_KEYS}, rng)
    tree["w0"] = tree["w0"] + 5.0 + rng.standard_normal(64).astype(np.float32)  # decays 0.0-0.9
    jp, tp = _params(tree)
    jx, tx = _pair(rng.standard_normal((2, s, 64)), dtype)
    jstate, tstate = (None, None)
    if with_state:
        jstate, tstate = _state_pair(jssm.rwkv6_state(jcfg, 64, 2, DTYPES[dtype][0])["time"],
                                     rng, dtype)
    jy, jnew = jssm.rwkv6_time_mix(jp, jx, jcfg, jstate)
    y, new = ssm.rwkv6_time_mix(tp, tx, cfg, tstate)
    assert y.dtype == DTYPES[dtype][1] and _rel(y, jy) <= MIX_TOL[dtype]
    assert (new is None) == (jnew is None)
    if with_state:
        _check_state(new, jnew, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_the_reference(with_state, dtype):
    rng = np.random.default_rng(SEED + 9)
    full = jssm.rwkv6_init(jax.random.PRNGKey(3), 64, JSSMConfig(**RWKV), 128)
    jp, tp = _params(_perturbed({k: full[k] for k in ssm.RWKV_CHAN_KEYS}, rng))
    jx, tx = _pair(rng.standard_normal((2, 6, 64)), dtype)
    jstate, tstate = (None, None)
    if with_state:
        jstate, tstate = _state_pair({"shift": jnp.zeros((2, 64), DTYPES[dtype][0])}, rng, dtype)
    jy, jnew = jssm.rwkv6_channel_mix(jp, jx, jstate)
    y, new = ssm.rwkv6_channel_mix(tp, tx, tstate)
    assert y.dtype == DTYPES[dtype][1] and _rel(y, jy) <= MIX_TOL[dtype]
    if with_state:
        np.testing.assert_array_equal(_np(new["shift"]), _np(jnew["shift"]))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_builders_and_inits_match_the_reference(dtype):
    """Every state leaf and parameter: the reference's name, shape and
    dtype; the inits' constant leaves equal."""
    jd, td = DTYPES[dtype]
    for kind, cfg_kw in (("mamba2", MAMBA), ("rwkv6", RWKV)):
        jcfg, cfg = JSSMConfig(**cfg_kw), SSMConfig(**cfg_kw)
        if kind == "mamba2":
            jst, st = jssm.mamba2_state(jcfg, 32, 3, jd), ssm.mamba2_state(cfg, 32, 3, td)
            jpar = jssm.mamba2_init(jax.random.PRNGKey(0), 32, jcfg)
            par = ssm.mamba2_init(torch.Generator().manual_seed(0), 32, cfg)
        else:
            jst, st = jssm.rwkv6_state(jcfg, 64, 3, jd), ssm.rwkv6_state(cfg, 64, 3, td)
            jpar = jssm.rwkv6_init(jax.random.PRNGKey(0), 64, jcfg, 128)
            par = ssm.rwkv6_init(torch.Generator().manual_seed(0), 64, cfg, 128)
        jl, tl = _leaves(jst), _leaves(st)
        assert jl.keys() == tl.keys()
        for key in jl:
            assert tuple(tl[key].shape) == jl[key].shape, key
            assert tl[key].dtype == (torch.float32 if jl[key].dtype == jnp.float32 else td), key
            assert not tl[key].any()
        assert jpar.keys() == par.keys()
        for key in jpar:
            assert tuple(par[key].shape) == jpar[key].shape and par[key].dtype == torch.float32
        for key in ("dt_bias", "a_log", "d_skip", "conv_b", "norm", "mu", "w0", "ln", "cm_mu"):
            if key in jpar:
                np.testing.assert_allclose(_np(par[key]), _np(jpar[key]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("call,what", [
    (lambda z: rwkv_kern.wkv_scan(z((1, 2, 8, 48)), z((1, 2, 8, 48)), z((1, 2, 8, 48)),
                                  z((1, 2, 8, 48)), z((2, 48))), "head size 48"),
    (lambda z: rwkv_kern.wkv_scan(z((1, 2, 8, 16)), z((1, 2, 8, 16)), z((1, 2, 8, 16)),
                                  z((1, 2, 8, 16)), z((3, 16))), "u shape"),
    (lambda z: ssd_kern.ssd_scan(z((1, 2, 24, 16)), z((1, 2, 24)), z((1, 2, 24)), z((1, 24, 16)),
                                 z((1, 24, 16)), chunk=16), "chunk"),
    (lambda z: ssd_kern.ssd_scan(z((1, 2, 16, 80)), z((1, 2, 16)), z((1, 2, 16)), z((1, 16, 16)),
                                 z((1, 16, 16)), chunk=16), "head dim 80"),
])
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(call, what):
    """The CUDA wrappers raise before they build or launch anything."""
    with pytest.raises(ValueError):
        call(torch.zeros)
    assert rwkv_kern.wkv_scan.launches == 0 and ssd_kern.ssd_scan.launches == 0, what

"""Layer-by-layer parity of the PyTorch port (``repro_torch``) with the JAX
reference (``repro``).

Inputs are made with numpy from a fixed seed and handed to both sides.
Parameters come from the reference's ``init``; every float leaf is then
perturbed with numpy noise (``init`` zeroes actnorm and the conditioner's last
conv, which would leave every coupling the identity) and the same perturbed
tree goes to both sides through ``repro_torch.bridge``.

Tolerance: 1e-4 absolute per element in f32, the bound the reference holds
its own kernels to (``repro/kernels/flowstep/ref.py``); the two sides sum in
different orders, so bitwise equality is not expected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.actnorm import ActNorm as JActNorm
from repro.core.chain import OnFirst as JOnFirst
from repro.core.chain import Pack as JPack
from repro.core.chain import Split as JSplit
from repro.core.conv1x1 import Conv1x1 as JConv1x1
from repro.core.distributions import flatten_state as j_flatten_state
from repro.core.distributions import std_normal_logpdf as j_logpdf
from repro.core.haar import HaarSqueeze as JHaar
from repro.core.haar import Squeeze as JSqueeze
from repro.nn.nets import CouplingCNN as JCouplingCNN
from repro_torch.bridge import params_from_numpy
from repro_torch.core import (
    ActNorm,
    Conv1x1,
    HaarSqueeze,
    OnFirst,
    Pack,
    Split,
    Squeeze,
    flatten_state,
    std_normal_logpdf,
)
from repro_torch.nn.nets import CouplingCNN

torch.set_num_threads(2)

ATOL = 1e-4  # f32 per element: the reference's own kernel bound
SEED = 20261017


def perturbed(tree, rng, scale=0.1):
    """The reference's parameter tree as numpy, every float leaf perturbed."""
    def bump(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(bump, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def as_np(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(as_np(a), as_np(b), rtol=0, atol=atol)


@pytest.mark.parametrize("jcls,cls", [(JHaar, HaarSqueeze), (JSqueeze, Squeeze)])
@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (3, 6, 2, 5)])
def test_squeeze_matches_reference(jcls, cls, shape):
    x = np.random.default_rng(SEED).standard_normal(shape).astype(np.float32)
    jy, jld = jcls().forward({}, jnp.asarray(x))
    y, ld = cls()(torch.from_numpy(x))
    close(y, jy)
    close(ld, jld)
    close(cls().inverse(y), jcls().inverse({}, jy))
    close(cls().inverse(y), x, atol=1e-6)  # round trip


@pytest.mark.parametrize("cls", [HaarSqueeze, Squeeze])
def test_squeeze_rejects_odd_extent(cls):
    with pytest.raises(ValueError, match="even"):
        cls()(torch.zeros(1, 3, 4, 2))


@pytest.mark.parametrize("shape", [(2, 5, 3, 4), (4, 6)])
def test_actnorm_matches_reference(shape):
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(shape).astype(np.float32)
    tree = perturbed(JActNorm().init(None, jnp.asarray(x)), rng)
    layer = params_from_numpy(ActNorm(shape[-1], device="cpu"), tree)
    jy, jld = JActNorm().forward(to_jax(tree), jnp.asarray(x))
    y, ld = layer(torch.from_numpy(x))
    close(y, jy)
    close(ld, jld)
    close(layer.inverse(y), JActNorm().inverse(to_jax(tree), jy))
    close(layer.inverse(y), x)


def test_actnorm_ddi_matches_reference():
    x = 3.0 + 2.0 * np.random.default_rng(SEED).standard_normal((4, 5, 5, 6)).astype(np.float32)
    ref = JActNorm.ddi(None, jnp.asarray(x))
    got = ActNorm.ddi(torch.from_numpy(x))
    close(got["log_s"], ref["log_s"])
    close(got["b"], ref["b"])
    layer = ActNorm(6, device="cpu")
    layer.load_state_dict(got)
    y, _ = layer(torch.from_numpy(x))
    close(y.mean(dim=(0, 1, 2)), np.zeros(6), atol=1e-4)
    close(y.std(dim=(0, 1, 2), correction=0), np.ones(6), atol=1e-4)


@pytest.mark.parametrize("c", [4, 12])
def test_conv1x1_bridged_matches_reference(c):
    rng = np.random.default_rng(SEED + c)
    x = rng.standard_normal((2, 3, 5, c)).astype(np.float32)
    jl = JConv1x1()
    tree = perturbed(jl.init(jax.random.PRNGKey(c), jnp.asarray(x)), rng)
    layer = params_from_numpy(Conv1x1(c, device="cpu"), tree)
    jy, jld = jl.forward(to_jax(tree), jnp.asarray(x))
    y, ld = layer(torch.from_numpy(x))
    close(y, jy)
    close(ld, jld)
    close(layer.inverse(y), jl.inverse(to_jax(tree), jy))
    close(layer.inverse(y), x)


@pytest.mark.parametrize("c", [2, 12, 48])
def test_conv1x1_own_init_is_a_rotation_in_reference_convention(c):
    """The port's init builds ``inv_perm`` under the reference's convention
    (``W = (L @ U)[inv_perm]``), so ``W`` is the orthogonal draw and
    ``log|det W| = sum(log_s)``."""
    layer = Conv1x1(c, generator=torch.Generator().manual_seed(c), device="cpu")
    assert layer.inv_perm.dtype == torch.int32 and layer.sign_s.dtype == torch.int8
    eye = torch.eye(c)
    w, _ = layer(eye)  # rows of the identity: y = W
    close(w @ w.T, eye, atol=1e-5)
    close(torch.linalg.slogdet(w.double())[1], layer.log_s.sum().double(), atol=1e-5)
    # the reference's forward on the port's parameters gives the same W
    tree = {k: v.numpy() for k, v in layer.state_dict().items()}
    jw, _ = JConv1x1().forward(to_jax(tree), jnp.eye(c))
    close(w.detach(), jw, atol=1e-5)
    close(layer.inverse(w), eye, atol=1e-5)


@pytest.mark.parametrize("c_cond", [0, 3])
def test_coupling_cnn_matches_reference(c_cond):
    rng = np.random.default_rng(SEED)
    c_in, c_out, hidden = 3, 6, 8
    x = rng.standard_normal((2, 5, 4, c_in)).astype(np.float32)
    cond = rng.standard_normal((2, c_cond)).astype(np.float32) if c_cond else None
    jnet = JCouplingCNN(c_out, hidden)
    tree = perturbed(jnet.init(jax.random.PRNGKey(1), c_in, c_cond), rng)
    net = params_from_numpy(CouplingCNN(c_in, c_out, hidden, c_cond, device="cpu"), tree)
    jh = jnet.apply(to_jax(tree), jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    h = net(torch.from_numpy(x), None if cond is None else torch.from_numpy(cond))
    close(h, jh)
    assert float(np.abs(np.asarray(jh)).max()) > 0.1  # the perturbed conv3 is live


def test_flatten_state_and_logpdf_match_reference():
    rng = np.random.default_rng(SEED)
    z = (rng.standard_normal((3, 2, 2, 8)).astype(np.float32),
         rng.standard_normal((3, 4, 4, 2)).astype(np.float32),
         rng.standard_normal((3, 5)).astype(np.float32))
    jz = tuple(jnp.asarray(v) for v in z)
    tz = tuple(torch.from_numpy(v) for v in z)
    close(flatten_state(tz), j_flatten_state(jz), atol=0)
    lp, jlp = std_normal_logpdf(tz), j_logpdf(jz)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6)
    close(std_normal_logpdf(tz[0]), j_logpdf(jz[0]))


def test_pack_split_onfirst_match_reference():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    jstate, _ = JPack().forward({}, jnp.asarray(x))
    state, _ = Pack()(torch.from_numpy(x))
    jstate, _ = JOnFirst(JHaar()).forward({}, jstate)
    state, _ = OnFirst(HaarSqueeze())(state)
    jstate, _ = JSplit().forward({}, jstate)
    state, ld = Split()(state)
    assert len(state) == len(jstate) == 2
    for a, b in zip(state, jstate):
        close(a, b)
    close(ld, np.zeros(2), atol=0)
    back = Pack().inverse(OnFirst(HaarSqueeze()).inverse(Split().inverse(state)))
    close(back, x, atol=1e-6)

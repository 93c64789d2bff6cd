"""``GLOW_SCANNED``'s gradient in the port against the JAX reference at the
config's full depth and width (3 scales x 8 steps, hidden 64) on a small
image, through the ``coupled`` engine with the ``reversible`` backward: the
input of every one of the 24 steps is rebuilt by inversion.  Kept in its own
file: most of its time is the reference's ``init`` and trace.

Parameters as in ``tests/test_torch_engines.py`` (the reference's ``init``
with fan-in-scaled numpy noise, shared by both sides); the loss within 1e-6
and every gradient leaf within 1e-4 absolute, the reference's grad-parity
bound.
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.autodiff import value_and_grad_nll as j_value_and_grad_nll
from repro.core.glow_scan import build_glow_scanned as j_build_glow_scanned
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.flows import GLOW_SCANNED, build_flow
from repro_torch.core import value_and_grad_nll
from torch_parity import grad_errors, make_pair

torch.set_num_threads(2)


def test_full_glow_scanned_reversible_gradient_matches_reference(monkeypatch):
    monkeypatch.delenv("REPRO_COUPLED_BWD", raising=False)
    cfg = dict(n_scales=GLOW_SCANNED.n_scales, k_steps=GLOW_SCANNED.k_steps,
               hidden=GLOW_SCANNED.hidden)
    _, jparams, _, tree = make_pair(cfg, (1, 8, 8, 3))
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 3)).astype(np.float32)
    jflow = j_build_glow_scanned(**cfg, grad_mode="coupled", coupled_bwd="reversible")
    jloss, jgrads = j_value_and_grad_nll(jflow.forward, jparams, jnp.asarray(x))
    flow = params_from_numpy(build_flow(GLOW_SCANNED, coupled_bwd="reversible", channels=3,
                                        device="cpu"), tree)
    assert flow.engine == "coupled"
    loss, grads = value_and_grad_nll(flow, torch.from_numpy(x))
    assert abs(float(loss) - float(jloss)) <= 1e-6
    errs = grad_errors(flow, tree, grads, jgrads)
    assert len(errs) == len(grads) == 3 * 11 and max(errs.values()) <= 1e-4, errs

"""``GLOW_SCANNED`` ``log_prob`` of the port against the JAX reference at the
config's full depth and width (3 scales x 8 steps, hidden 64), on a small
image.  Kept in its own file: most of its time is the reference's ``init``,
and alone it runs beside the other parity files.

Parameters and tolerance as in ``tests/test_torch_glow.py``: the reference's
``init`` with fan-in-scaled numpy noise on every float leaf, shared by both
sides; ``log_prob`` within 1e-5 relative (it scales with the dimension D).
"""

import numpy as np
import jax.numpy as jnp
import torch

from repro.serve.engine import FlowServeEngine as JFlowServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.flows import GLOW_SCANNED, build_flow
from repro_torch.serve.engine import FlowServeEngine
from torch_parity import make_pair

torch.set_num_threads(2)


def test_log_prob_full_glow_scanned_matches_reference():
    """``GLOW_SCANNED`` at its full depth and width (3 scales x 8 steps,
    hidden 64) on a small image."""
    cfg = dict(n_scales=GLOW_SCANNED.n_scales, k_steps=GLOW_SCANNED.k_steps,
               hidden=GLOW_SCANNED.hidden)
    jflow, jparams, _, tree = make_pair(cfg, (1, 8, 8, 3))
    flow = params_from_numpy(
        build_flow(GLOW_SCANNED, channels=3, device="cpu"), tree)
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(JFlowServeEngine(jflow, jparams).log_prob(jnp.asarray(x)))
    got = FlowServeEngine(flow, device="cpu").log_prob(x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)

"""Scanned GLOW: homogeneous flow-step stacks with layer-stacked parameters.

``GlowStepStack`` holds the parameters of one scale's ``k`` identical flow
steps (actnorm -> LU-parameterised 1x1 conv -> affine coupling with a
``CouplingCNN`` conditioner) stacked along a leading ``k`` axis, as the
reference does for ``lax.scan``.  PyTorch runs eagerly, so the scan is a
Python loop over ``k`` (``core/autodiff.py::make_scan_apply``).  Each step is
one fused flow-step launch given the conditioner's raw/t
(``kernels/flowstep``); the conditioner's convolutions stay with cuDNN.

The ``grad_mode="coupled"`` backward of a step (``_step_bwd``) is the two
backward kernels on either side of the conditioner's VJP: ``coupling_bwd``
(on whole rows) rebuilds the conv output x2 and emits its cotangent gx2 and
h's (graw | gt), autograd maps h's through the conditioner, whose cotangent
of the pass-through half is added into gx2 in place, and ``spine_bwd`` walks
back through the 1x1 conv and actnorm.  The stack offers the whole reverse walk as its ``fused_bwd`` hook,
so it keeps that backward inside a coupled multiscale chain.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.autodiff import (
    invertible_step_bwd,
    make_scan_apply,
    scan_backward,
)
from repro_torch.core.chain import InvertibleChain, OnFirst, Pack, Split
from repro_torch.core.conv1x1 import (
    conv1x1_init,
    lu_factors,
    lu_pullback,
    lu_weight,
    lu_weight_inv,
)
from repro_torch.core.haar import HaarSqueeze, Squeeze
from repro_torch.core.types import (
    Invertible,
    ParamTree,
    resolve_device,
    stack_slices,
    stack_trees,
    tree_index,
    tree_leaves,
)
from repro_torch.kernels.common import flatten_bmc
from repro_torch.kernels.coupling.ops import fused_coupling_bwd_rows
from repro_torch.kernels.flowstep.ops import (
    fused_flowstep_fwd,
    fused_flowstep_inv,
    fused_spine_bwd,
)
from repro_torch.nn.nets import coupling_cnn_apply, coupling_cnn_init

COUPLED_BWD = ("auto", "reversible", "stored")


def resolve_coupled_bwd(choice: str = "auto", device=None) -> str:
    """The backward strategy of ``grad_mode="coupled"`` for a flow on
    ``device``:

    * ``"reversible"`` - output-only residuals and the fused reverse walk:
      activation memory flat in depth, the choice where device memory binds
      (a CUDA card);
    * ``"stored"`` - the same forward differentiated by plain autograd,
      which keeps the activations and skips the backward's extra conditioner
      evaluation: the choice on the CPU, where memory is ample.

    ``"auto"`` picks by the device's type, the reference's per-backend rule.
    """
    if choice not in COUPLED_BWD:
        raise ValueError(f"coupled_bwd must be one of {COUPLED_BWD}, got {choice}")
    if choice != "auto":
        return choice
    return "reversible" if torch.device(device).type == "cuda" else "stored"


class GlowStepStack(Invertible):
    """``k_steps`` homogeneous GLOW flow steps on a (B, H, W, C) tensor (wrap
    in ``OnFirst`` for the multiscale tuple state).  Parameters: ``an``
    (log_s, b: (k, C)), ``lu`` (l, u: (k, C, C); log_s: (k, C); integer
    buffers inv_perm, sign_s: (k, C)) and ``net`` (the conditioner's conv1-3,
    each w: (k, kh, kw, c_in, c_out), b: (k, c_out)).

    ``grad_mode`` picks the engine of :meth:`forward`; with ``"coupled"``,
    ``coupled_bwd`` (:func:`resolve_coupled_bwd`, on the stack's device)
    picks the fused reverse walk or plain autograd.  The ``fused_bwd`` hook,
    which an outer coupled chain takes, is the fused walk in every mode.
    ``psum_axis``: the stack's own backward sums each step's gradients over
    that mesh axis (``core/autodiff.py``); the hooks never reduce (the outer
    chain does)."""

    def __init__(self, c: int, k_steps: int, hidden: int = 64, clamp: float = 2.0,
                 grad_mode: str = "invertible", coupled_bwd: str = "auto", *,
                 psum_axis: str | None = None, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        ca = c // 2
        if ca < 1:
            raise ValueError(f"GlowStepStack needs >= 2 channels, got {c}")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.k_steps = k_steps
        self.clamp = clamp
        self.grad_mode = grad_mode
        self.coupled_bwd = resolve_coupled_bwd(coupled_bwd, dev) if grad_mode == "coupled" else None
        self.engine = "autodiff" if self.coupled_bwd == "stored" else grad_mode
        self.psum_axis = psum_axis if self.engine in ("invertible", "coupled") else None
        steps = [
            {
                "an": {"log_s": torch.zeros(c), "b": torch.zeros(c)},
                "lu": conv1x1_init(gen, c),
                "net": coupling_cnn_init(gen, c - ca, 2 * ca, hidden),
            }
            for _ in range(k_steps)
        ]
        stacked = stack_trees(steps)
        self.an = ParamTree(stacked["an"])
        self.lu = ParamTree(stacked["lu"])
        self.net = ParamTree(stacked["net"])
        self.to(dev)

    # -- per-step pieces (p: one step's parameters, as tree_index gives) ----

    @staticmethod
    def _spatial(x) -> int:
        return math.prod(x.shape[1:-1]) if x.ndim > 2 else 1

    def _ld_const(self, p, x) -> torch.Tensor:
        """Per-batch-constant logdet: actnorm + conv1x1 (spatial * sum log_s)."""
        return self._spatial(x) * (torch.sum(p["an"]["log_s"]) + torch.sum(p["lu"]["log_s"])).float()

    def _step_fwd(self, p, x, cond):
        ca = x.shape[-1] // 2
        an_ls, an_b = p["an"]["log_s"], p["an"]["b"]
        w = lu_weight(p["lu"]).float()
        # the conditioner input is the untransformed half after actnorm and
        # the 1x1 conv: a half-width product outside the kernel
        xb = (x.float() * torch.exp(an_ls) + an_b) @ w[:, ca:]
        h = coupling_cnn_apply(p["net"], xb.to(x.dtype), cond)
        y, ld_c = fused_flowstep_fwd(
            flatten_bmc(x.contiguous()), an_ls, an_b, w,
            flatten_bmc(h[..., :ca]), flatten_bmc(h[..., ca:]), clamp=self.clamp,
        )
        return y.reshape(x.shape), ld_c + self._ld_const(p, x)

    def _step_inv(self, p, y, cond):
        ca = y.shape[-1] // 2
        h = coupling_cnn_apply(p["net"], y[..., ca:], cond)
        x = fused_flowstep_inv(
            flatten_bmc(y.contiguous()), p["an"]["log_s"], p["an"]["b"],
            lu_weight_inv(p["lu"]).float(),
            flatten_bmc(h[..., :ca]), flatten_bmc(h[..., ca:]), clamp=self.clamp,
        )
        return x.reshape(y.shape)

    def _step_bwd(self, i, y, gy, gld, cond):
        """The fused reversible backward of step ``i`` from its output side:
        ``coupling_bwd``, the conditioner's VJP, ``spine_bwd``.  Returns
        ``(x, gx, {name: grad of step i's slice}, gcond)``."""
        ca = y.shape[-1] // 2
        y, gy = y.contiguous(), gy.contiguous()
        p = tree_index(self, i, detach=True)
        an_ls, an_b, lu = p["an"]["log_s"], p["an"]["b"], p["lu"]
        factors = lu_factors(lu)  # shared by W, W^-1 and the LU pullback
        w = lu_weight(lu, factors).float()
        w_inv = lu_weight_inv(lu, factors).float()

        net = tree_leaves(p["net"], "net.")
        yb = y[..., ca:]
        with torch.enable_grad():
            yb_ = yb.detach().requires_grad_()
            c_ = cond.detach().requires_grad_() if cond is not None and cond.is_floating_point() else None
            h = coupling_cnn_apply(p["net"], yb_, cond if c_ is None else c_)

        # stage 1: the coupling, rebuilt and differentiated in one pass over
        # whole rows: x2, gx2 (gy's pass-through half) and h's cotangent
        x2, gx2, gh = fused_coupling_bwd_rows(
            flatten_bmc(y), flatten_bmc(h.detach()), flatten_bmc(gy), gld, clamp=self.clamp)
        inputs = [v for _, v in net] + [yb_] + ([c_] if c_ is not None else [])
        grads = torch.autograd.grad(h, inputs, gh.reshape(h.shape).to(h.dtype),
                                    allow_unused=True)
        g_net, gxb = grads[: len(net)], grads[len(net)]
        gcond = grads[-1] if c_ is not None else None
        gx2.view(y.shape)[..., ca:] += gxb.to(gx2.dtype)

        # stage 2: conv1x1 + actnorm from the conv output side
        x, gx, gw, g_an_ls, g_an_b = fused_spine_bwd(x2, gx2, w, w_inv, an_ls, an_b)

        # the per-batch-constant logdets put their cotangent on the log-scales
        s_gld = self._spatial(y) * torch.sum(gld.float())
        g_lu = lu_pullback(lu, factors, gw)
        gp = {
            "an.log_s": g_an_ls + s_gld,
            "an.b": g_an_b,
            "lu.l": g_lu["l"],
            "lu.u": g_lu["u"],
            "lu.log_s": g_lu["log_s"] + s_gld,
            **{name: g for (name, _), g in zip(net, g_net)},
        }
        return x.reshape(y.shape), gx.reshape(y.shape), gp, gcond

    def scan_stacks(self) -> list:
        """The stacks the scan engine walks one step at a time: this one."""
        return [self]

    # -- Invertible surface -------------------------------------------------

    def forward(self, x, cond=None):
        step_bwd = self._step_bwd if self.engine == "coupled" else None
        return make_scan_apply(self, self._step_fwd, self._step_inv, self.engine,
                               step_bwd=step_bwd, psum_axis=self.psum_axis)(x, cond)

    def inverse(self, y, cond=None):
        for i in reversed(range(self.k_steps)):
            y = self._step_inv(tree_index(self, i), y, cond)
        return y

    # -- reverse walks the chain engine takes -------------------------------

    def fused_bwd(self, y, gy, gld, cond=None):
        """The fused reversible backward of the whole stack (the ``coupled``
        hook)."""
        return scan_backward(self._step_bwd, stack_slices(self), y, gy, gld, cond)

    def invertible_bwd(self, y, gy, gld, cond=None):
        """Step by step invert-then-VJP (the ``invertible`` engine's walk)."""
        step_bwd = invertible_step_bwd(self, self._step_fwd, self._step_inv)
        return scan_backward(step_bwd, stack_slices(self), y, gy, gld, cond)


def build_glow_scanned(
    n_scales: int = 3,
    k_steps: int = 8,
    hidden: int = 64,
    grad_mode: str = "invertible",
    haar: bool = True,
    clamp: float = 2.0,
    coupled_bwd: str = "auto",
    psum_axis: str | None = None,
    *,
    channels: int = 3,
    generator: torch.Generator | None = None,
    device=None,
) -> InvertibleChain:
    """Scanned GLOW for (B, H, W, channels) inputs (H, W divisible by
    2**n_scales): per scale, squeeze -> one ``GlowStepStack`` of ``k_steps``
    steps -> split (but after the last scale).  The layer list, and so the
    parameter tree, is the reference's ``build_glow_scanned``.  Parameters
    are drawn from ``generator`` on the CPU, in layer order, then moved to
    ``device``.

    ``coupled_bwd`` is the ``grad_mode="coupled"`` backward strategy
    (:func:`resolve_coupled_bwd`); with ``"stored"`` the whole chain
    differentiates by plain autograd, as in the reference (the chain's
    output-only residuals would drop the stored activations).

    ``psum_axis`` makes the chain's backward sum its parameter gradients over
    that mesh axis (data parallelism, ``dist/flow.py``).  It goes on the
    outermost chain only, as in the reference: the chain reduces every
    layer's gradients once, and a stack-level reduction would reduce the
    stacks' twice.  Under the ``"stored"`` strategy the chain is plain
    autograd and the chain's ``psum_axis`` reads back None: the data-parallel
    helpers reduce the gradients themselves."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    squeeze = HaarSqueeze if haar else Squeeze
    engine = None
    if grad_mode == "coupled" and resolve_coupled_bwd(coupled_bwd, dev) == "stored":
        engine = "autodiff"
    layers: list[Invertible] = [Pack()]
    c = channels
    for scale in range(n_scales):
        c *= 4
        layers.append(OnFirst(squeeze()))
        layers.append(OnFirst(GlowStepStack(c, k_steps, hidden=hidden, clamp=clamp,
                                            grad_mode=grad_mode, coupled_bwd=coupled_bwd,
                                            generator=gen, device=dev)))
        if scale != n_scales - 1:
            layers.append(Split())
            c //= 2
    return InvertibleChain(layers, grad_mode=grad_mode, engine=engine, psum_axis=psum_axis)

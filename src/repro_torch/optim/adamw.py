"""AdamW with the reference's arithmetic (``repro/optim/adamw.py``), which
differs from ``torch.optim.AdamW`` in detail: the global-norm clip divides
by ``norm + 1e-9`` and is folded into the update, weight decay sits inside
the step (``delta = mhat / (sqrt(vhat) + eps) + wd * p``, then
``p -= lr * delta``), and the moments are float32 whatever the parameter's
type.  Integer leaves get no moments and no update.

Parameters and gradients are ``{name: tensor}`` dicts (``named_parameters()``
and the gradients of ``core/autodiff.py::value_and_grad_nll``).  Unlike the
reference, which returns new arrays, the update writes the parameters in
place, a large leaf in slices of its leading axis (the same bits), so the
update's temporaries do not grow with an LM's depth.
"""

from __future__ import annotations

import torch

from repro_torch.config import TrainConfig


def _trainable(v: torch.Tensor) -> bool:
    return v.is_floating_point()


def adamw_init(params: dict) -> dict:
    """Zero f32 moments for every floating parameter, and step 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items() if _trainable(p)}
    return {"mu": zeros, "nu": {n: z.clone() for n, z in zeros.items()}, "step": 0}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: TrainConfig, lr: float,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step: updates ``params`` in place; returns ``(opt_state,
    metrics)`` with the gradient's global norm and the clip scale.
    ``grad_norm``: the whole gradient's norm, given where ``grads`` are this
    rank's blocks of it (a model-sharded mesh, ``dist/model.py``)."""
    step = opt_state["step"] + 1
    if grad_norm is None:
        gs = [grads[n].float() for n, p in params.items() if _trainable(p)]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
    else:
        gnorm = grad_norm
    # a select, not a branch on the norm's value: no host sync, and a meta
    # norm (the dry run) has no value
    scale = (torch.where(gnorm > cfg.grad_clip, cfg.grad_clip / (gnorm + 1e-9),
                         torch.ones_like(gnorm)) if cfg.grad_clip > 0 else torch.ones_like(gnorm))
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    steps = torch.tensor(float(step), dtype=torch.float32)
    c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** steps).item()
    c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** steps).item()
    mu, nu = opt_state["mu"], opt_state["nu"]
    for n, p in params.items():
        if not _trainable(p):
            continue
        # elementwise, so updating a large leaf in slices of its leading axis
        # gives the same bits with temporaries of one slice
        for sl in _slices(p):
            pv, m, v = p[sl], mu[n][sl], nu[n][sl]
            g = grads[n][sl].float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * pv.float()
            pv.copy_((pv.float() - lr * delta).to(p.dtype))
    return {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gnorm, "clip_scale": scale}


#: a leaf past this many elements is updated in slices of its leading axis
#: of about this many elements (an LM's layer-stacked weights, its embedding)
_SLICE_ELEMS = 1 << 24


def _slices(p: torch.Tensor) -> list:
    if p.dim() == 0 or p.numel() <= _SLICE_ELEMS:
        return [slice(None)]
    rows = max(1, _SLICE_ELEMS // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]

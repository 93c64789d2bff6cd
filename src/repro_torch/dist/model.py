"""Model-sharded modules: each rank stores its block of every parameter and
AdamW moment, by the reference's rules (``dist/sharding.py::state_pspecs``:
``params_pspecs``, ``opt_pspecs``), and gathers a leaf whole only where it
is used.

:class:`ModelSharding` lays a module out on a mesh whose ``model`` axis is
more than 1.  Each split parameter's ``.data`` becomes this rank's block,
described by a :class:`ShardInfo`:

* a leaf of a stack the scan engine walks (one that a module's
  ``scan_stacks()`` names: a ``GlowStepStack``, an LM's ``blocks`` and
  ``encoder``) stays a block at rest and for the whole step.  The stack's
  ``step_slices`` accessor (:class:`ShardedStack`, which ``core/types.py``'s
  ``tree_index`` and ``core/autodiff.py``'s ``scan_backward`` go through)
  gathers one step's slice whole each time the scan engine takes it (the
  forward, and again the rebuild of the ``invertible`` / ``coupled``
  backward: the same bits both times), and keeps this rank's block of each
  step's gradient;
* any other split leaf (an LM's embedding and head, a hybrid model's shared
  weights, a front end) is gathered whole for the duration of a step or a
  request (:meth:`ModelSharding.materialized`) and put back to its block
  after.

Every rank of the ``model`` axis runs the same single-device computation on
the same rows: the gathered leaves, the activations and so every cotangent
are the same on each, so the gradient of a gathered slice is this rank's
block of the whole one (:class:`_Gather`'s backward).  The layers that split
work over the ``model`` axis (the experts of ``nn/moe.py``, the sequence of
``nn/attention.py``) gather what they split, in the forward and in the
backward, so that this holds.

1-D leaves and leaves with no divisible axis replicate, as in the reference;
buffers (integer permutations, signs) are never split.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from repro_torch.core.types import StackSlices
from repro_torch.dist import comm
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    entry_index,
    entry_size,
    gather_shard,
    local_shard,
    state_pspecs,
)

class _Gather(torch.autograd.Function):
    """A block gathered whole; its backward keeps this rank's block of the
    cotangent (which every rank of the split axes holds the same)."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_shard(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_shard(g, ctx.spec, ctx.mesh).contiguous(), None, None


@dataclass
class ShardInfo:
    """How one parameter is split: its spec, its whole shape, its mesh, and
    whether it is gathered lazily (a leaf of a scan stack)."""

    spec: tuple
    full_shape: tuple
    mesh: object = field(repr=False)
    lazy: bool = False

    def is_whole(self, t: torch.Tensor) -> bool:
        return tuple(t.shape) == self.full_shape

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of the leaf's shape."""
        return local_shard(t, self.spec, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from a block (no gradient)."""
        return gather_shard(t, self.spec, self.mesh)

    def whole(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` whole, differentiable through the gather."""
        return p if self.is_whole(p) else _Gather.apply(p, self.spec, self.mesh)

    def _stack_split(self) -> bool:
        return bool(self.spec) and self.spec[0] is not None

    def take(self, p: torch.Tensor, i: int, detach: bool) -> torch.Tensor:
        """Step ``i``'s slice of the stacked leaf ``p``, whole: a detached
        leaf that requires grad with ``detach``, else differentiable back to
        ``p``'s block."""
        if self.is_whole(p):
            v = p[i]
        elif self._stack_split():
            v = (self.gather(p.detach()) if detach else self.whole(p))[i]
        elif detach:
            v = gather_shard(p[i].detach(), self.spec[1:], self.mesh)
        else:
            return _Gather.apply(p[i], self.spec[1:], self.mesh)
        return v.detach().requires_grad_() if detach else v

    def put_row(self, g_stacked: torch.Tensor, i: int, g: torch.Tensor):
        """Write this rank's block of step ``i``'s whole gradient ``g`` into
        row ``i`` of ``g_stacked`` (shaped like the parameter as stored)."""
        if self.is_whole(g_stacked):
            g_stacked[i] = g
        elif self._stack_split():
            rows = g_stacked.shape[0]
            lo = entry_index(self.mesh, self.spec[0]) * rows
            if lo <= i < lo + rows:
                g_stacked[i - lo] = g
        else:
            g_stacked[i] = local_shard(g, self.spec[1:], self.mesh)


class ShardedStack(StackSlices):
    """A scan stack's steps on a model-sharded mesh: a split leaf's slice is
    gathered whole where the scan takes it, and a step's gradient row keeps
    this rank's block.  ``infos`` maps the stack's dotted parameter names to
    their :class:`ShardInfo`."""

    def __init__(self, module: torch.nn.Module, infos: dict):
        super().__init__(module)
        self.infos = infos

    def __len__(self) -> int:
        name, p = next(self.module.named_parameters())
        return self.infos[name].full_shape[0] if name in self.infos else p.shape[0]

    def leaf(self, name, p, i, detach):
        info = self.infos.get(name)
        return super().leaf(name, p, i, detach) if info is None else info.take(p, i, detach)

    def put_row(self, name, g_stacked, i, g):
        info = self.infos.get(name)
        if info is None:
            super().put_row(name, g_stacked, i, g)
        else:
            info.put_row(g_stacked, i, g)


def _scan_stacks(module) -> dict:
    """``{dotted prefix: stack}`` of every stack a submodule's
    ``scan_stacks()`` names."""
    prefixes = {id(m): n for n, m in module.named_modules()}
    return {prefixes[id(s)]: s for m in module.modules() if hasattr(m, "scan_stacks")
            for s in m.scan_stacks()}


class ModelSharding:
    """``module``'s parameters laid out on ``mesh`` by ``params_pspecs``
    (see the module docstring).  :meth:`shard` stores the blocks,
    :meth:`unshard` puts every leaf back whole.  The reference's ``fsdp``
    storage (a second split over the data axes) is not offered: only its dry
    run sets it (``dist.ITEM_8``)."""

    def __init__(self, module: torch.nn.Module, mesh):
        self.module, self.mesh = module, mesh
        self.params = dict(module.named_parameters())
        self.stacks = _scan_stacks(module)
        lazy = {f"{prefix}.{n}" if prefix else n for prefix, stack in self.stacks.items()
                for n, _ in stack.named_parameters()}
        floating = {n: p for n, p in self.params.items() if p.is_floating_point()}
        specs = state_pspecs({"params": floating,
                              "opt": {"mu": floating, "nu": floating, "step": 0}}, mesh)
        self.infos = {
            n: ShardInfo(spec, tuple(floating[n].shape), mesh, n in lazy)
            for n, spec in specs["params"].items()
            if any(entry_size(mesh, e) > 1 for e in spec if e)
        }
        #: each AdamW moment's spec (``opt_pspecs``: its parameter's)
        self.moment_specs = specs["opt"]["mu"]
        self.model_group = comm.mesh_group(mesh, MODEL_AXIS)

    def shard(self):
        for n, info in self.infos.items():
            p = self.params[n]
            p.data = info.local(p.data).clone()
        for prefix, stack in self.stacks.items():
            head = f"{prefix}." if prefix else ""
            stack.step_slices = ShardedStack(stack, {
                n[len(head):]: info for n, info in self.infos.items() if n.startswith(head)})
        return self

    def unshard(self):
        """Every leaf whole again (a collective)."""
        for n, info in self.infos.items():
            p = self.params[n]
            if not info.is_whole(p):
                p.data = info.gather(p.data)
        for stack in self.stacks.values():
            del stack.step_slices

    @contextlib.contextmanager
    def materialized(self):
        """Inside, every split leaf outside the scan stacks holds its whole
        value (gathered on entry); on exit each gets its block back."""
        saved = {}
        try:
            for n, info in self.infos.items():
                p = self.params[n]
                if not info.lazy and not info.is_whole(p):
                    saved[n] = p.data
                    p.data = info.gather(p.data)
            yield
        finally:
            for n, block in saved.items():
                self.params[n].data = block

    # -- gradients and state -------------------------------------------------

    def local_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's block of a gradient (a lazy leaf's already is)."""
        info = self.infos.get(name)
        if info is None or not info.is_whole(g):
            return g
        return info.local(g).contiguous()

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The whole gradient's global norm from the blocks: the split
        leaves' squares summed over the ``model`` axis, the replicated
        leaves' counted once."""
        split = [torch.sum(torch.square(grads[n].float())) for n in self.params
                 if n in self.infos and self.params[n].is_floating_point()]
        rep = [torch.sum(torch.square(grads[n].float())) for n, p in self.params.items()
               if n not in self.infos and p.is_floating_point()]
        dev = next(iter(grads.values())).device
        sq = torch.stack(split).sum() if split else torch.zeros((), device=dev)
        comm.all_reduce(sq, self.model_group)
        return torch.sqrt(sq + (torch.stack(rep).sum() if rep else 0.0))

    def whole_tree(self, tree: dict) -> dict:
        """``{name: tensor}`` with every split leaf's block gathered whole (a
        collective: every rank calls it)."""
        return {n: self.infos[n].gather(v) if n in self.infos and not self.infos[n].is_whole(v)
                else v for n, v in tree.items()}

    def local_tree(self, tree: dict) -> dict:
        """``{name: tensor}`` of whole leaves cut to this rank's blocks."""
        return {n: self.infos[n].local(v).clone() if n in self.infos else v
                for n, v in tree.items()}

    def whole_like(self, tree: dict) -> dict:
        """Empty tensors of the whole shapes of ``tree``'s leaves (a restore's
        template)."""
        return {n: torch.empty(self.infos[n].full_shape, dtype=v.dtype, device=v.device)
                if n in self.infos else v for n, v in tree.items()}

    def whole_opt(self, opt: dict) -> dict:
        """The AdamW state with every moment gathered whole (a collective)."""
        def whole(tree):
            return {n: gather_shard(v, self.moment_specs[n], self.mesh) for n, v in tree.items()}

        return {"mu": whole(opt["mu"]), "nu": whole(opt["nu"]), "step": opt["step"]}

    def local_opt(self, opt: dict) -> dict:
        """A whole AdamW state cut to this rank's blocks of its moments."""
        def local(tree):
            return {n: local_shard(v, self.moment_specs[n], self.mesh).clone()
                    for n, v in tree.items()}

        return {"mu": local(opt["mu"]), "nu": local(opt["nu"]), "step": opt["step"]}

    def resident_bytes(self, opt: dict | None = None) -> dict:
        """This rank's parameter (and AdamW moment) bytes as stored, beside
        one process's."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        out = {"params": nbytes(self.params.values()),
               "params_whole": sum(
                   (torch.Size(self.infos[n].full_shape).numel() if n in self.infos
                    else p.numel()) * p.element_size() for n, p in self.params.items())}
        if opt is not None:
            moments = [*opt["mu"].values(), *opt["nu"].values()]
            out["moments"] = nbytes(moments)
            out["moments_whole"] = 2 * sum(
                (torch.Size(self.infos[n].full_shape).numel() if n in self.infos
                 else p.numel()) * 4 for n, p in self.params.items() if p.is_floating_point())
        return out

"""Sharded modules: each rank stores its block of every parameter and AdamW
moment, by the reference's rules (``dist/sharding.py``: ``params_pspecs``,
``opt_pspecs``), and gathers a leaf whole only where it is used.

:class:`ModelSharding` lays a module out on a mesh whose ``model`` axis is
more than 1, or on any mesh with the reference's ``fsdp`` storage (every
leaf split a second time over the data axes) or ``zero1`` moments (each
moment split over the data axes too).  Each split parameter's ``.data``
becomes this rank's block, described by a :class:`ShardInfo`:

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

With ``fsdp`` a gather runs over the data axes first, into the per-layer
spec that ``layer_slice_pspecs`` gives (the reference's ``layer_constraint``
made explicit), then over ``model``; the ranks of a data axis hold
different rows, so a gradient goes back to its block by a reduce-scatter
over the data axes (``reduce_shard``), and the step does not sum such a
leaf's gradient again.  With ``zero1`` the step reduce-scatters a
gradient into its moment's block, updates that block of the parameter and
all-gathers it back (:meth:`ModelSharding.reduce_grads`,
:meth:`ModelSharding.update_views`, :meth:`ModelSharding.regather`).  A
leaf ``fsdp`` already split over the data axes keeps its parameter's spec
for its moments: the reference's rules would name the data axes twice for
it (a ``DuplicateSpecError`` in ``NamedSharding``), and its moment is
already a data block.

1-D leaves and leaves with no divisible axis replicate, as in the reference;
buffers (integer permutations, signs) are never split.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch

from repro_torch.core.types import StackSlices
from repro_torch.dist import comm
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    entry_index,
    entry_names,
    entry_size,
    gather_shard,
    is_data_entry,
    layer_slice_pspecs,
    local_shard,
    model_part,
    opt_pspecs,
    params_pspecs,
    reduce_shard,
)
from repro_torch.optim.adamw import adamw_init


class _Gather(torch.autograd.Function):
    """A block gathered whole; its backward keeps this rank's block of the
    cotangent (which every rank of a ``model`` row holds the same), summed
    over the data axes where the block splits over them."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_shard(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_shard(g, ctx.spec, ctx.mesh), None, None


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

    @property
    def has_data(self) -> bool:
        """The leaf splits over data axes (``fsdp``): its gradient comes back
        summed over them."""
        return any(is_data_entry(e) and entry_size(self.mesh, e) > 1 for e in self.spec)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of the leaf's shape."""
        return local_shard(t, self.spec, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from a block (no gradient)."""
        return gather_shard(t, self.spec, self.mesh)

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's block of a gradient of the whole leaf
        (``reduce_shard``)."""
        return reduce_shard(g, self.spec, self.mesh)

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
            # the data axes first, into the per-layer spec, then the model axis
            v = gather_shard(p[i].detach(), self.spec[1:], self.mesh)
        else:
            return _Gather.apply(p[i], self.spec[1:], self.mesh)
        return v.detach().requires_grad_() if detach else v

    def put_row(self, g_stacked: torch.Tensor, i: int, g: torch.Tensor):
        """Write this rank's block of step ``i``'s whole gradient ``g`` into
        row ``i`` of ``g_stacked`` (shaped like the parameter as stored),
        summed over the data axes where the leaf splits over them."""
        if self.is_whole(g_stacked):
            g_stacked[i] = g
        elif self._stack_split():
            head = self.spec[0]
            row = reduce_shard(g, self.spec[1:], self.mesh)
            if is_data_entry(head):
                # each data rank's g is its rows' part: the row's sum
                comm.all_reduce(row, comm.mesh_group(self.mesh, entry_names(head)))
            rows = g_stacked.shape[0]
            lo = entry_index(self.mesh, head) * rows
            if lo <= i < lo + rows:
                g_stacked[i - lo] = row
        else:
            g_stacked[i] = reduce_shard(g, self.spec[1:], self.mesh)


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
    (``fsdp``: split over the data axes too) and its AdamW moments by
    ``opt_pspecs`` (``zero1``: split over the data axes too); see the module
    docstring.  :meth:`shard` stores the blocks, :meth:`unshard` puts every
    leaf back whole."""

    def __init__(self, module: torch.nn.Module, mesh, fsdp: bool = False, zero1: bool = False):
        self.module, self.mesh, self.fsdp, self.zero1 = module, mesh, fsdp, zero1
        self.params = dict(module.named_parameters())
        self.stacks = _scan_stacks(module)
        lazy = {f"{prefix}.{n}" if prefix else n for prefix, stack in self.stacks.items()
                for n, _ in stack.named_parameters()}
        floating = {n: p for n, p in self.params.items() if p.is_floating_point()}
        p_specs = params_pspecs(floating, mesh, fsdp=fsdp)
        o_specs = opt_pspecs({"mu": floating, "nu": floating, "step": 0}, p_specs, mesh,
                             zero1=zero1)["mu"]
        self.infos = {
            n: ShardInfo(spec, tuple(floating[n].shape), mesh, n in lazy)
            for n, spec in p_specs.items()
            if any(entry_size(mesh, e) > 1 for e in spec if e)
        }
        #: each AdamW moment's spec: its parameter's, with ``zero1``'s split
        #: over the data axes where the parameter has none
        self.moment_specs = {n: p_specs[n] if n in self.infos and self.infos[n].has_data
                             else o_specs[n] for n in floating}
        #: the leaves whose moments split over data axes their parameters do
        #: not: the step reduce-scatters their gradients into the moments'
        #: blocks and all-gathers the updated blocks back
        self.zero1_specs = {n: _extra(self.moment_specs[n], p_specs[n], mesh)
                            for n in floating}
        self.zero1_specs = {n: e for n, e in self.zero1_specs.items() if e}
        self.model_group = comm.mesh_group(mesh, MODEL_AXIS)
        for prefix, stack in self.stacks.items():
            _check_layer_specs(stack, prefix, self.infos, mesh)

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
        """This rank's block of a gradient (a lazy leaf's already is),
        summed over the data axes where the leaf splits over them."""
        info = self.infos.get(name)
        if info is None or not info.is_whole(g):
            return g
        return info.reduce(g) if info.has_data else info.local(g).contiguous()

    def zero_grad(self, name: str) -> torch.Tensor:
        """Zeros of the shape a gradient of ``name`` takes as stored."""
        p = self.params[name]
        info = self.infos.get(name)
        shape = p.shape if info is None else local_shard(
            torch.empty(info.full_shape, device="meta"), info.spec, self.mesh).shape
        return torch.zeros(shape, dtype=p.dtype, device=p.device)

    def data_reduced(self, name: str) -> bool:
        """The leaf's gradient comes back summed over the data axes
        (``fsdp``'s reduce-scatter)."""
        info = self.infos.get(name)
        return info is not None and info.has_data

    def reduce_grads(self, grads: dict, axis) -> dict:
        """The data-parallel sum of this rank's gradient blocks: a leaf
        ``fsdp`` split already is one; a ``zero1`` leaf's gradient is
        reduce-scattered into its moment's block; the rest are all-reduced
        whole (asynchronously, as they come)."""
        out, reducer = dict(grads), comm.GradReducer(axis)
        for n, g in grads.items():
            if self.data_reduced(n):
                continue
            if n in self.zero1_specs:
                out[n] = reduce_shard(g, self.zero1_specs[n], self.mesh)
            else:
                reducer.add([g])
        reducer.wait()
        return out

    def update_views(self) -> dict:
        """``{name: the parameter, or its block in its moment's layout}``: a
        ``zero1`` leaf's view of the block its moments cover (AdamW updates
        it in place)."""
        return {n: local_shard(p, self.zero1_specs[n], self.mesh) if n in self.zero1_specs
                else p for n, p in self.params.items()}

    def regather(self):
        """All-gather each ``zero1`` leaf's updated block back into the
        parameter as stored (a collective on the data axes)."""
        with torch.no_grad():
            for n, spec in self.zero1_specs.items():
                p = self.params[n]
                p.copy_(gather_shard(local_shard(p, spec, self.mesh).contiguous(), spec,
                                     self.mesh))

    def init_opt(self) -> dict:
        """Zero AdamW moments in their blocks, and step 0."""
        return adamw_init({n: local_shard(p.detach(), self.zero1_specs[n], self.mesh)
                           if n in self.zero1_specs else p for n, p in self.params.items()})

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The whole gradient's global norm from the blocks: the split
        leaves' squares summed over the ``model`` axis, the replicated
        leaves' counted once (with ``fsdp`` or ``zero1``: each block's
        squares over the ranks holding it, summed over the mesh)."""
        if self.fsdp or self.zero1:
            return self._grad_norm_blocks(grads)
        split = [torch.sum(torch.square(grads[n].float())) for n in self.params
                 if n in self.infos and self.params[n].is_floating_point()]
        rep = [torch.sum(torch.square(grads[n].float())) for n, p in self.params.items()
               if n not in self.infos and p.is_floating_point()]
        dev = next(iter(grads.values())).device
        sq = torch.stack(split).sum() if split else torch.zeros((), device=dev)
        comm.all_reduce(sq, self.model_group)
        return torch.sqrt(sq + (torch.stack(rep).sum() if rep else 0.0))

    def _grad_norm_blocks(self, grads: dict) -> torch.Tensor:
        """Each block's squares divided by the number of ranks holding it,
        summed over the whole mesh."""
        names = tuple(self.mesh.mesh_dim_names)
        n_ranks = self.mesh.size()
        terms = []
        for n, p in self.params.items():
            if not p.is_floating_point():
                continue
            holders = n_ranks // math.prod(entry_size(self.mesh, e)
                                           for e in self.moment_specs[n] if e)
            terms.append(torch.sum(torch.square(grads[n].float())) / holders)
        sq = torch.stack(terms).sum()
        comm.all_reduce(sq, comm.mesh_group(self.mesh, names))
        return torch.sqrt(sq)

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

    def stored_bytes(self, opt: dict) -> int:
        """This rank's parameter and AdamW moment bytes as stored."""
        ts = [*self.params.values(), *opt["mu"].values(), *opt["nu"].values()]
        return sum(t.numel() * t.element_size() for t in ts)

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


def _extra(moment_spec, param_spec, mesh) -> tuple:
    """The data-axis entries of ``moment_spec`` that ``param_spec`` lacks,
    as a spec (``()`` when there are none)."""
    entries = list(moment_spec) + [None] * max(0, len(param_spec) - len(moment_spec))
    ps = list(param_spec) + [None] * (len(entries) - len(param_spec))
    out = [e if e is not None and p is None and is_data_entry(e) and entry_size(mesh, e) > 1
           else None for e, p in zip(entries, ps)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _check_layer_specs(stack, prefix: str, infos: dict, mesh):
    """A stacked leaf's slice, once its data axes are gathered, is in the
    spec ``layer_slice_pspecs`` gives (where the stack axis is not split;
    a 1-D slice, which the rule keeps whole, is gathered whole)."""
    head = f"{prefix}." if prefix else ""
    params = dict(stack.named_parameters())
    layer = layer_slice_pspecs(params, mesh)
    for n, p in params.items():
        info = infos.get(head + n)
        if info is None or info._stack_split() or p.dim() < 3:
            continue
        if model_part(info.spec[1:]) != layer[n]:
            raise AssertionError(f"{head + n}: slice spec {model_part(info.spec[1:])} is not "
                                 f"layer_slice_pspecs' {layer[n]}")

"""What one step costs, reckoned from eager's own operations: the port's
counterpart of the reference's ``utils/hlo.py``, which walks a compiled
XLA program.  The port runs no compiler, so nothing here reads HLO: the HLO
text parser (``_parse`` and its regexes) and ``xla_cost_analysis`` are not
ported.  What is ported is what they measure, read from the operations
themselves:

* :class:`CostCounter`, a ``TorchDispatchMode`` over one step: flops by
  ``torch.utils.flop_counter``'s rules (the products, convolutions and
  attention; elementwise work counts none); bytes as each operation's
  tensor inputs plus outputs (eager's operation boundaries, the reading of
  what eager moves; views and bare allocations move none); the peak of live
  tensor bytes allocated during the step, above what it was handed
  (``temp_bytes``), with the scratch the softmax kernels allocate while
  they run (contiguous copies of non-contiguous operands; the backward's
  ``grad * output`` product), which no dispatched operation shows; and
  every collective ``dist/comm.py`` issues, by kind under the reference's
  names (``COLLECTIVE_KINDS``), with its bytes;
* :class:`Cost`, the record of ``HloCost``: flops, bytes, collectives by
  kind, ``coll_count`` and ``coll_total``, and the kernels' launches
  (:func:`record_launch`: a kernel's meta route adds the bytes and
  operations ``PERF.md``'s bound column reckons for it);
* :func:`collective_bytes` (kinds, then ``total`` and ``count``),
  :func:`collective_calls` (the flat list of collective calls, the
  counterpart of ``parse_hlo_collectives``) and :func:`top_collectives`;
* :func:`trips` and :func:`trip_range`, the counterpart of the walker's
  trip-count scaling: a loop body traced once counts ``n`` times.

Trip scaling keeps eager's arithmetic exact.  ``trip_range(n)`` on meta
tensors under a counter yields step 0, then step 1 inside ``trips(n - 3)``,
then steps ``n - 2`` and ``n - 1``: the first step (whose state may need no
gradient) and the last two are traced as themselves, and the middle one
stands for the ``n - 3`` alike.  The middle step's operations count
``n - 3`` times, and so do the operations of every autograd node created
in it, and the gradient sums the engine adds after such a node, when the
backward runs (``torch._C._current_autograd_node``).  The backward meets
the steps last to first, and the engine stores the first gradient a shared
tensor receives and adds each later one; the last step's state gets no
gradient in training, so its inputs that feed only the state receive none
from it, and step ``n - 2``'s gradient is the one stored.  With the last
two steps traced, the sums come out as unrolled either way.
:func:`full_stack` and :func:`full_cat` make the loop's outputs at their
full shapes from the four traced steps, counting the stack or
concatenation of ``n`` pieces.  Tensors made in the middle step that
outlive it (saved for the backward) weigh ``n - 3`` times in the live
bytes until they are freed.
"""

from __future__ import annotations

import bisect
import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``dist/comm.py``'s collectives under the reference's kinds
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "send": "collective-permute"}

#: allocations that write nothing
_ALLOC_ONLY = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like"}
#: kernels that allocate scratch inside the call, beside their output:
#: PyTorch's softmax kernels run on contiguous copies of non-contiguous
#: operands (``.contiguous()``), and its CUDA softmax backward first forms
#: the product ``grad * output`` at the gradient's size and layout
_SOFTMAX = {"_softmax", "_log_softmax"}
_SOFTMAX_BACKWARD = {"_softmax_backward_data", "_log_softmax_backward_data"}


def _scratch(name: str, ins) -> int:
    """The scratch bytes a softmax kernel allocates inside the call."""
    copies = sum(_nbytes(t) for t in ins if not t.is_contiguous())
    if name in _SOFTMAX_BACKWARD:
        return _nbytes(ins[0]) + copies  # the product, then the copies
    return copies if name in _SOFTMAX else 0


@dataclass
class CollectiveOp:
    """One collective call: its kind, the bytes it handed to the wire, and
    a line naming it (the collective, dtype, shape and group size)."""

    kind: str
    bytes_in: int
    line: str = field(repr=False, default="")


@dataclass
class Cost:
    """One step's cost (the reference's ``HloCost``, with the kernels'
    launches and the memory reading beside it)."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = field(default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})
    coll_count: int = 0
    launches: Counter = field(default_factory=Counter)
    calls: list = field(default_factory=list)
    temp_bytes: int = 0
    output_bytes: int = 0

    @property
    def coll_total(self) -> int:
        return sum(self.collectives[k] for k in COLLECTIVE_KINDS)


def collective_bytes(cost: Cost) -> dict:
    """Collective bytes by kind, then ``total`` and ``count``."""
    out = dict(cost.collectives)
    out["total"] = cost.coll_total
    out["count"] = cost.coll_count
    return out


def collective_calls(cost: Cost) -> list[CollectiveOp]:
    """The flat list of collective calls, one entry a call (a trip-scaled
    call once, with its bytes scaled)."""
    return list(cost.calls)


def top_collectives(cost: Cost, n: int = 10) -> list[tuple[float, int, str, str]]:
    """``(total_bytes, scale, kind, line)`` of the ``n`` largest collectives,
    calls alike (the same line) taken together: ``scale`` is how many."""
    groups: dict = {}
    for op in cost.calls:
        total, scale = groups.get((op.kind, op.line), (0.0, 0))
        groups[(op.kind, op.line)] = (total + op.bytes_in, scale + 1)
    rows = [(total, scale, kind, line) for (kind, line), (total, scale) in groups.items()]
    rows.sort(key=lambda r: -r[0])
    return rows[:n]


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_ACTIVE: list = []


def active() -> "CostCounter | None":
    """The innermost running counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Storage:
    """A tracked allocation: its bytes and its weight (trip-scaled ones
    stand for several)."""

    __slots__ = ("nbytes", "weight", "op", "__weakref__")

    def __init__(self, nbytes: int, op: str = ""):
        self.nbytes, self.weight, self.op = nbytes, 1, op


class CostCounter(TorchDispatchMode):
    """Counts one step (``with CostCounter() as c: ...``; then ``c.cost``).
    See the module docstring for what is counted; ``trip_scaling=False``
    traces every loop step (the reckoning trip scaling must equal)."""

    def __init__(self, trip_scaling: bool = True, peak_by_op: bool = False):
        super().__init__()
        self.trip_scaling = trip_scaling
        #: with ``peak_by_op``: the live bytes at the peak, by the operation
        #: that made them (a reading of where the peak comes from)
        self.peak_by_op: Counter | None = Counter() if peak_by_op else None
        self.cost = Cost()
        self._live = 0
        self._storages: dict = {}  # id(storage) -> _Storage
        self._forward_mult = [1]
        self._ranges: list = []  # sorted (lo, hi, mult) of autograd sequence numbers
        self._body: list = []  # per open trips(): the storages made in it
        self._paused = 0

    # -- scale ---------------------------------------------------------------

    def multiplier(self) -> int:
        mult = self._forward_mult[-1]
        node = torch._C._current_autograd_node()
        if node is not None and self._ranges:
            seq = node._sequence_nr()
            i = bisect.bisect_right(self._ranges, (seq, float("inf"))) - 1
            if i >= 0 and self._ranges[i][0] <= seq < self._ranges[i][1]:
                mult *= self._ranges[i][2]
        return mult

    def _seq_marker(self) -> int:
        """The autograd sequence number the next node will take."""
        self._paused += 1
        try:
            with torch.enable_grad():
                x = torch.empty((), device="meta", requires_grad=True)
                return (x * 1).grad_fn._sequence_nr() + 1
        finally:
            self._paused -= 1

    # -- memory --------------------------------------------------------------

    def _track(self, outs, op: str = ""):
        for t in outs:
            st = t.untyped_storage()
            if id(st) in self._storages:
                continue
            rec = _Storage(st.nbytes(), op)
            self._storages[id(st)] = rec
            weakref.finalize(st, self._free, id(st))
            self._live += rec.nbytes
            for body in self._body:
                body.append(weakref.ref(rec))
            self._peak()

    def _peak(self, scratch: int = 0, op: str = ""):
        if self._live + scratch > self.cost.temp_bytes:
            self.cost.temp_bytes = self._live + scratch
            if self.peak_by_op is not None:
                self.peak_by_op = Counter()
                for r in self._storages.values():
                    self.peak_by_op[r.op] += r.nbytes * r.weight
                if scratch:
                    self.peak_by_op[f"scratch of {op}"] += scratch

    def _free(self, key):
        rec = self._storages.pop(key, None)
        if rec is not None:
            self._live -= rec.nbytes * rec.weight

    # -- counting ------------------------------------------------------------

    def add(self, flops: float = 0.0, nbytes: float = 0.0):
        m = self.multiplier()
        self.cost.flops += m * flops
        self.cost.bytes += m * nbytes

    def launch(self, name: str, nbytes: float, flops: float):
        self.cost.launches[name] += self.multiplier()
        self.add(flops, nbytes)

    def collective(self, op: str, t: torch.Tensor):
        m = self.multiplier()
        kind = _KIND[op]
        nbytes = _nbytes(t) * m
        self.cost.collectives[kind] += nbytes
        self.cost.coll_count += m
        line = f"{op} {str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
        self.cost.calls.extend(CollectiveOp(kind, _nbytes(t), line) for _ in range(m))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            # an op with a composite decomposition (matmul, einsum under
            # inference mode) is counted by the ops it decomposes into, as
            # autograd mode dispatches it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func._overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) if packet in flop_registry \
            else 0
        nbytes = 0
        view = _aliases(ins, outs)
        if packet.__name__ not in _ALLOC_ONLY and (func._schema.is_mutable or not view):
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.add(flops, nbytes)
        if not view:  # a view of a tensor the step was handed allocates nothing
            self._track(outs, str(func))
        scratch = _scratch(packet.__name__, ins)
        if scratch:
            self._peak(scratch, str(func))
        return out

    def __enter__(self):
        from repro_torch.dist import comm

        _ACTIVE.append(self)
        comm.add_listener(self.collective)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.dist import comm

        comm.remove_listener(self.collective)
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def outputs(self, tree) -> int:
        """Record the bytes of ``tree``'s tensors made during the step
        (``output_bytes``); returns them."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) in self._storages and id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        self.cost.output_bytes = total
        return total


def _aliases(ins, outs) -> bool:
    """True when an output shares an input's storage (a view)."""
    if not outs or not ins:
        return False
    storages = {id(t.untyped_storage()) for t in ins}
    return any(id(t.untyped_storage()) in storages for t in outs)


def record_launch(name: str, nbytes: float, flops: float):
    """A kernel's launch on the meta route, with the bytes it must move and
    the operations it does (no-op without a running counter)."""
    c = active()
    if c is not None:
        c.launch(name, nbytes, flops)


# ---------------------------------------------------------------------------
# trip scaling
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trips(n: int):
    """Inside, every operation counts ``n`` times, and so, in the backward,
    does every operation of an autograd node made inside (see the module
    docstring).  Without a running counter it does nothing."""
    c = active()
    if c is None or n == 1:
        yield
        return
    lo = c._seq_marker()
    c._forward_mult.append(c._forward_mult[-1] * n)
    c._body.append([])
    try:
        yield
    finally:
        body = c._body.pop()
        c._forward_mult.pop()
        bisect.insort(c._ranges, (lo, c._seq_marker(), n))
        for ref in body:
            rec = ref()
            if rec is not None:
                c._live += (n - 1) * rec.nbytes * rec.weight
                rec.weight *= n
        c._peak()


#: the steps a trip-scaled loop traces, by their place in the loop
_TRACED = (0, 1, -2, -1)


def trip_range(n: int, device: torch.device):
    """``range(n)``; on meta tensors under a counter that scales, for four
    or more steps, step 0, step 1 inside ``trips(n - 3)``, then steps
    ``n - 2`` and ``n - 1`` (module docstring)."""
    c = active()
    if device.type != "meta" or n < 4 or c is None or not c.trip_scaling:
        yield from range(n)
        return
    yield 0
    with trips(n - 3):
        yield 1
    yield n - 2
    yield n - 1


class _Full(torch.autograd.Function):
    """The stack (or concatenation) of ``n`` pieces from the four traced
    ones: the operation runs on ``n`` meta pieces (the middle one repeated),
    so it counts as unrolled; the backward hands each traced piece its
    slice."""

    @staticmethod
    def forward(ctx, dim, n, cat, *pieces):
        ctx.dim, ctx.n, ctx.cat = dim, n, cat
        ctx.ext = pieces[0].shape[dim] if cat else 1
        many = [pieces[0]] + [pieces[1]] * (n - 3) + list(pieces[2:])
        return torch.cat(many, dim) if cat else torch.stack(many, dim)

    @staticmethod
    def backward(ctx, g):
        dim, n, e = ctx.dim, ctx.n, ctx.ext
        places = [i % n for i in _TRACED]
        if ctx.cat:
            slices = [g.narrow(dim, i * e, e) for i in places]
        else:
            slices = [g.select(dim, i) for i in places]
        return (None, None, None, *slices)


def full_stack(pieces: list, dim: int, n: int) -> torch.Tensor:
    """``torch.stack`` of a loop's ``n`` outputs: of ``pieces`` itself when
    the loop ran unrolled, else from its four traced steps."""
    if len(pieces) == n:
        return torch.stack(pieces, dim)
    return _Full.apply(dim, n, False, *pieces)


def full_cat(pieces: list, dim: int, n: int) -> torch.Tensor:
    """``torch.cat`` of a loop's ``n`` outputs (as :func:`full_stack`)."""
    if len(pieces) == n:
        return torch.cat(pieces, dim)
    return _Full.apply(dim, n, True, *pieces)

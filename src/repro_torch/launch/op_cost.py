"""Work and bytes of one step, counted as it runs: the port's counterpart of
the reference's ``launch/hlo_cost.py``.

The reference re-derives costs from optimized HLO text because XLA's
``cost_analysis`` counts a loop body once.  The port has no HLO.  It runs
the step eagerly (on the card, on the CPU, or on fake tensors, which compute
nothing), and :class:`OpCounter`, a ``TorchDispatchMode``, sees every op of
every loop iteration, so no trip count has to be recovered.  It returns the
reference's keys:

  * ``flops``: the products (mm, bmm, addmm, baddbmm, convolution,
    attention), each counted as ``torch.utils.flop_counter`` counts it, plus
    ``2·M·K·N`` for each ternary matmul.  The hand kernels launch through
    ``ctypes``, where no dispatch mode sees them, so
    ``dispatch.ternary_matmul`` and ``grouped_ternary_matmul`` report each
    call to the active counter (:meth:`OpCounter.ternary_matmul`) and the
    counter pauses while the selected kernel runs: on the CPU the plain
    versions are torch ops, which would otherwise count a second time.
  * ``bytes``: the roofline bytes, which depend on the algorithm only.
    Each tensor the step did not create (parameters, the cache, inputs)
    counts once, when an op first reads it, and only the part it reads (a
    slice, the rows a gather takes); each write to such a tensor, state
    that outlives the step, counts once, an in-place update by the bytes it
    updates; each tensor the step returns counts once.
  * ``collectives`` (the reference's five kinds) and ``collective_bytes``:
    0 on one card.
  * ``bytes_materialized``: the reference's HBM proxy, kept beside them so
    a step can be set beside ``hlo_cost``'s ``bytes``: every non-view op's
    result counts once; a view (an op whose schema marks its result an
    alias) counts nothing; an in-place update counts the bytes it updates.

A size that only the data fixes (a boolean index on fake tensors: an
unbacked size) counts at its upper bound.  A step's ``flops`` and ``bytes``
do not depend on the kernel dispatch selects: a ternary matmul counts as
the function it computes.

    counter = OpCounter()
    with counter:
        out = step(*args)
    counter.returned(out)
    counter.result()   # {"flops", "bytes", "collectives", ...}

or ``analyze(step, *args)``.
"""

from __future__ import annotations

import bisect
import itertools
import math
from collections import Counter
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dispatch

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: a strided read of more contiguous runs than this is counted by the span
#: from its first to its last byte
MAX_RUNS = 4096

_aten = torch.ops.aten
#: ops whose first argument is read only where the index points: they read
#: as many bytes of it as they return
_GATHERS = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather,
            _aten.take}
#: in-place ops that overwrite their destination without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.index_put_,
               _aten._index_put_impl_, _aten.index_copy_, _aten.scatter_,
               _aten.masked_fill_}
#: in-place ops that write where an index points: they update as many
#: bytes as their values (or source) argument holds
_SCATTERS = {_aten.index_put_: "values", _aten._index_put_impl_: "values",
             _aten.index_copy_: "source", _aten.index_add_: "source",
             _aten.scatter_: "src", _aten.scatter_add_: "src",
             _aten.scatter_reduce_: "src"}
#: ops that bring a tensor made outside dispatch (``torch.tensor``) into
#: the step: their result is the step's own
_LIFTS = {_aten.lift_fresh, _aten.lift_fresh_copy}


def _num(x) -> int:
    """An int from a size: its value, or for an unbacked symbolic size (a
    boolean index's count on fake tensors) its upper bound."""
    if isinstance(x, (torch.SymInt, torch.SymFloat)):
        node = x.node
        if not node.has_hint():
            return int(node.shape_env.bound_sympy(node.expr).upper)
        return int(node.hint)
    return int(x)


def _nbytes(t: torch.Tensor) -> int:
    return math.prod(_num(s) for s in t.shape) * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _runs(t: torch.Tensor) -> list[tuple[int, int]]:
    """The byte intervals of ``t``'s storage that ``t`` covers: its
    dimensions ordered by stride, the innermost contiguous ones merged into
    runs, one interval a run (or one span when there are more than
    :data:`MAX_RUNS`)."""
    size = t.element_size()
    dims = [(_num(n), _num(s)) for n, s in zip(t.shape, t.stride())]
    if any(n == 0 for n, _ in dims):
        return []
    dims = sorted(((n, s) for n, s in dims if n > 1 and s != 0),
                  key=lambda d: -d[1])
    run = expect = 1
    while dims and dims[-1][1] == expect:
        n, s = dims.pop()
        run *= n
        expect = n * s
    base = _num(t.storage_offset())
    if math.prod(n for n, _ in dims) > MAX_RUNS:
        span = sum((n - 1) * s for n, s in dims) + run
        return [(base * size, (base + span) * size)]
    starts = [base + sum(i * s for i, (_, s) in zip(idx, dims))
              for idx in itertools.product(*(range(n) for n, _ in dims))]
    return [(o * size, (o + run) * size) for o in starts]


class _Cover:
    """Disjoint sorted byte intervals of one storage already counted."""

    def __init__(self):
        self.starts: list[int] = []
        self.ends: list[int] = []

    def add(self, a: int, b: int) -> int:
        """Cover ``[a, b)``; return how many of its bytes were new."""
        i = bisect.bisect_left(self.ends, a)
        j = bisect.bisect_right(self.starts, b)
        old = sum(max(0, min(e, b) - max(s, a))
                  for s, e in zip(self.starts[i:j], self.ends[i:j]))
        lo = min(a, self.starts[i]) if i < j else a
        hi = max(b, self.ends[j - 1]) if i < j else b
        self.starts[i:j] = [lo]
        self.ends[i:j] = [hi]
        return (b - a) - old


def _schema(func):
    """``(is_view, mutated argument positions and names)`` of an op."""
    schema = func._schema
    mutated = [(i, a.name) for i, a in enumerate(schema.arguments)
               if a.alias_info is not None and a.alias_info.is_write]
    aliased = any(r.alias_info is not None for r in schema.returns)
    return aliased and not mutated, mutated


def _arg(args, kwargs, i: int, name: str):
    return args[i] if i < len(args) else kwargs.get(name)


def _arg_named(func, args, kwargs, name: str | None):
    """The argument of ``func`` called ``name`` (None if it has none)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return _arg(args, kwargs, i, name)
    return None


def _updated_bytes(func, args, kwargs, dest: torch.Tensor) -> int | None:
    """The bytes of ``dest`` an in-place scatter updates (None for an
    update of the whole of ``dest``): an ``index_put_`` updates as many
    elements as ``dest[indices]`` holds, the others as many as their
    source."""
    src = _arg_named(func, args, kwargs, _SCATTERS.get(func.overloadpacket))
    if not isinstance(src, torch.Tensor):
        return None
    size = dest.element_size()
    indices = _arg_named(func, args, kwargs, "indices")
    if indices is None or any(i is not None and i.dtype == torch.bool
                              for i in indices):
        return _nbytes(src) // src.element_size() * size
    taken = [i for i in indices if i is not None]
    rows = math.prod(_num(d) for d in torch.broadcast_shapes(
        *(i.shape for i in taken)))
    rest = [_num(d) for d, i in itertools.zip_longest(dest.shape, indices)
            if i is None]
    return rows * math.prod(rest) * size


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts one step's FLOPs and bytes (see the module docstring).  Enter
    it around the step; inside, ``dispatch`` reports each ternary matmul to
    it and takes fake or meta tensors (it selects as a fresh card would and
    returns an empty product).  Pass what the step returned to
    :meth:`returned`, then read :meth:`result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.bytes_returned = 0
        self.bytes_materialized = 0
        self.ops = 0
        self.flops_by_op: Counter = Counter()
        #: (kernel, E, M, K, N) -> the summed report of those calls
        self.matmuls: dict[tuple, dict] = {}
        self._created: set[int] = set()
        self._reads: dict[int, _Cover] = {}
        self._writes: dict[int, _Cover] = {}
        self._paused = 0
        self._scopes = []
        self._schemas: dict = {}

    # -- scope -------------------------------------------------------------

    def __enter__(self):
        scope = dispatch.cost_scope(self)
        scope.__enter__()
        self._scopes.append(scope)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._scopes.pop().__exit__(*exc)

    @contextmanager
    def paused(self):
        """Ops inside count nothing (the tensors they make are still the
        step's own)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- accounting --------------------------------------------------------

    def _external(self, t: torch.Tensor) -> bool:
        return _key(t) not in self._created

    def _read(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        """Count a read of ``t`` if the step did not make it: the part of
        its storage not read before, or ``nbytes`` (a gather's rows)."""
        if not self._external(t):
            return
        if nbytes is not None:
            self.bytes_read += nbytes
            return
        cover = self._reads.setdefault(_key(t), _Cover())
        self.bytes_read += sum(cover.add(a, b) for a, b in _runs(t))

    def _write(self, t: torch.Tensor, nbytes: int | None) -> int:
        """Count an in-place update of ``t`` (of ``nbytes`` where an index
        says where, else of ``t``'s own bytes not written before); return
        the bytes it updates."""
        updated = _nbytes(t) if nbytes is None else nbytes
        if self._external(t):
            if nbytes is not None:
                self.bytes_written += nbytes
            else:
                cover = self._writes.setdefault(_key(t), _Cover())
                self.bytes_written += sum(cover.add(a, b) for a, b in _runs(t))
        return updated

    def _note_made(self, out) -> None:
        for t in _tensors(out):
            self._created.add(_key(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func not in self._schemas:
            self._schemas[func] = _schema(func)
        is_view, mutated = self._schemas[func]
        packet = func.overloadpacket
        if packet in _LIFTS:
            self._note_made(out)
            return out
        if is_view or not (mutated or _tensors(out)):
            # a view, or a query of metadata (``prim.device``, sizes)
            return out
        if self._paused:
            if not mutated:
                self._note_made(out)
            return out
        self.ops += 1
        dests = {id(t) for i, name in mutated
                 for t in _tensors(_arg(args, kwargs, i, name))}
        for t in _tensors((args, kwargs)):
            if id(t) in dests and packet in _OVERWRITES:
                continue
            if packet in _GATHERS and t is _arg(args, kwargs, 0, ""):
                self._read(t, _nbytes(out) if isinstance(out, torch.Tensor)
                           else None)
            else:
                self._read(t)
        updated = set()
        for i, name in mutated:
            for t in _tensors(_arg(args, kwargs, i, name)):
                n = _updated_bytes(func, args, kwargs, t)
                self.bytes_materialized += self._write(t, n)
                updated.add(_key(t))
        for t in _tensors(out):
            if _key(t) not in updated:
                self._created.add(_key(t))
                self.bytes_materialized += _nbytes(t)
        formula = flop_registry.get(packet)
        if formula is not None:
            f = _num(formula(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] += f
        return out

    def ternary_matmul(self, spec, x: torch.Tensor, w, mu: int,
                       e: int | None = None) -> None:
        """A ternary matmul of ``x [M, K]`` (grouped: ``[E, C, K]``)
        against ``w`` through ``spec``, reported by dispatch: ``2·M·K·N``
        FLOPs (times E), the activation and the weight bytes the served
        tree stores read as any op's would be, the f32 product
        materialized.  The kernel's own weight stream
        (``spec.weight_bytes``) is kept beside them."""
        m, k = _num(x.shape[-2]), _num(x.shape[-1])
        n = w.out_features
        experts = e or 1
        stored = w.stored()
        flops = 2 * experts * m * k * n
        out_bytes = 4 * experts * m * n
        self.flops += flops
        self.flops_by_op["ternary_matmul"] += flops
        self._read(x)
        self._read(stored)
        self.bytes_materialized += out_bytes
        rec = self.matmuls.setdefault(
            (spec.name, e, m, k, n),
            {"kernel": spec.name, "E": e, "M": m, "K": k, "N": n, "calls": 0,
             "flops": 0, "x_bytes": 0, "out_bytes": 0, "weight_bytes": 0,
             "kernel_weight_bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["x_bytes"] += _nbytes(x)
        rec["out_bytes"] += out_bytes
        rec["weight_bytes"] += _nbytes(stored)
        rec["kernel_weight_bytes"] += experts * int(spec.weight_bytes(k, n,
                                                                      mu))

    def returned(self, out) -> None:
        """Count the tensors the step returned that it made itself."""
        seen = set()
        for t in _tensors(out):
            if not self._external(t) and _key(t) not in seen:
                seen.add(_key(t))
                self.bytes_returned += _nbytes(t)

    # -- result ------------------------------------------------------------

    @property
    def bytes(self) -> int:
        return self.bytes_read + self.bytes_written + self.bytes_returned

    def result(self) -> dict:
        """The reference's keys (``flops``, ``bytes``, ``collectives``,
        ``collective_bytes``), ``bytes_materialized`` beside them, and the
        parts: bytes read, written and returned, ops counted, FLOPs by op,
        and the ternary matmuls by (kernel, E, M, K, N)."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": {k: 0.0 for k in COLLECTIVE_KINDS},
                "collective_bytes": 0.0,
                "bytes_materialized": float(self.bytes_materialized),
                "bytes_read": float(self.bytes_read),
                "bytes_written": float(self.bytes_written),
                "bytes_returned": float(self.bytes_returned),
                "ops": self.ops,
                "flops_by_op": dict(self.flops_by_op),
                "ternary_matmuls": list(self.matmuls.values())}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter` and return
    its :meth:`~OpCounter.result`."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    counter.returned(out)
    return counter.result()

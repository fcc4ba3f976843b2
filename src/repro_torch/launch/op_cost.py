"""FLOP and byte accounting of a traced torch program, with loop
multipliers: the port's twin of the reference's jaxpr walker
(`launch/jaxpr_cost.py`; there is no jaxpr here, hence the name).

`traced_cost(fn, *args)` runs `fn` under a `TorchDispatchMode` (on
`meta` tensors in the dry run: shapes only, no storage, no device) and
counts every aten op it dispatches, the backward's included:

  * flops: the matrix products (`mm`, `addmm`, `bmm`, `baddbmm`,
    convolutions, and `einsum` / `matmul` as they decompose into them)
    as `torch.utils.flop_counter` counts them (2 * M * N * K * batch,
    the reference's `dot_general` rule), plus one flop per output
    element of every other op that computes;
  * bytes: the reference's fusion-aware model of memory traffic: the
    outputs of every op, the inputs too of the matrix products and of
    the memory-bound set (gathers, scatters, index ops, sort, top-k,
    cat / stack); views and fresh allocations are free.

Loop scaling (`scale_loops=True`, the default): the reference scales a
`lax.scan` body by its length; the port unrolls those scans as Python
loops (`nn/scan.py::scan`), so while counting it installs a hook there
under which a loop of n > 3 trips runs its first, one middle and its
last trip, the middle trip's ops counted n - 2 times.  The backward
follows: the trip's autograd nodes are tagged with the multiplier, an
op the engine runs for a node (its backward, and the gradient sums into
its inputs) counts at the node's multiplier
(`torch._C._current_autograd_node`), and the sums a full loop makes
where every trip sends a gradient to one input from outside the loop
are charged at the trip.  A region recomputed by
`torch.utils.checkpoint` counts at the trips of the loops it was called
in (`nn/scan.py::remat_context`).  With `scale_loops=False` every trip
runs and counts once: at SMOKE size the two counts are equal
(`tests/test_torch_dryrun.py`).

Counted on the global program; per-device numbers divide by the chip
count (`launch/analysis.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.nn import scan as scan_mod

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other):
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


# ops whose inputs are charged as memory traffic too (the reference's
# _MEM_IN_PRIMS: gather, scatter, dynamic slices, sort, concatenate)
_MEM_IN_OPS = {
    aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.index_select, aten.index_add, aten.index_add_, aten.index_copy,
    aten.index_copy_, aten.gather, aten.scatter, aten.scatter_,
    aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
    aten.embedding, aten.embedding_dense_backward, aten.sort, aten.topk,
    aten.cat, aten.stack, aten.searchsorted, aten.take,
    aten.slice_scatter, aten.select_scatter, aten.select_backward,
    aten.slice_backward, aten.index_select_backward,
}

# allocations and metadata: no flops, no traffic (the reference's
# broadcast_in_dim / iota / reshape are free)
_FREE_OPS = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.zeros, aten.zeros_like, aten.new_zeros,
    aten.ones, aten.ones_like, aten.new_ones, aten.full, aten.full_like,
    aten.new_full, aten.arange, aten.scalar_tensor, aten.lift_fresh,
    aten.lift_fresh_copy, aten.detach, aten.alias, aten._unsafe_view,
    aten.clone,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
    aten.is_same_size, aten._local_scalar_dense, aten.set_,
}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


class _CountMode(TorchDispatchMode):
    """Counts every dispatched op into `total` and `by_op`, each at the
    current loop multiplier."""

    def __init__(self):
        super().__init__()
        self.total = Cost()
        self.by_op: Dict[str, Cost] = {}
        self._stack = [1.0]          # forward loop multipliers (products)
        self._recompute = 0          # > 0 inside a checkpoint recompute
        self.node_mult: Dict[int, float] = {}
        self._tracked = set()        # nodes whose gradient sums we place
        self._arrivals: Dict[Any, int] = {}
        self._pending = (None, [])   # (node, multipliers of its sums)
        self._slot_times: Dict[Any, float] = {}   # a trip's own xs inputs

    # ------------------------------------------------------ multipliers
    def _mult(self, func=None) -> float:
        if not self._recompute:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                at, sums = self._pending
                if func is aten.add.Tensor and at == seq and sums:
                    # the engine summing this node's gradient into an
                    # input that already holds one: that sum belongs to
                    # the input's node
                    return sums.pop(0)
                return self.node_mult.get(seq, 1.0)
        return self._stack[-1]

    def _target_mult(self, node) -> float:
        if type(node).__name__ == "AccumulateGrad":
            return 1.0
        return self.node_mult.get(node._sequence_nr(), 1.0)

    def _track(self, node) -> None:
        """After `node` runs, the engine adds each gradient it sends to
        an input that already holds one: note which, at the input's
        node's multiplier."""
        seq = node._sequence_nr()
        if seq in self._tracked:
            return
        self._tracked.add(seq)
        edges = node.next_functions

        def hook(grad_inputs, grad_outputs):
            sums = []
            for (nxt, nr), g in zip(edges, grad_inputs):
                if nxt is None or g is None:
                    continue
                key = self._edge_key(nxt, nr)
                self._arrivals[key] = self._arrivals.get(key, 0) + 1
                if self._arrivals[key] > 1:
                    sums.append(self._target_mult(nxt)
                                * self._slot_times.get(key, 1.0))
            self._pending = (seq, sums)
        node.register_hook(hook)

    @contextlib.contextmanager
    def scaled(self, n: int, inputs):
        """The scan hook: one trip counted n times, forward and
        backward.  `inputs` (the carry and the trip's xs) are the
        edges into the trip that a full loop would not sum over."""
        start = None
        if torch.is_grad_enabled() and not self._recompute:
            start = self._seq_now()
        outer = self._stack[-1]
        self._stack.append(outer * n)
        try:
            yield lambda outputs: self._tag(outputs, inputs, start, n, outer)
        finally:
            self._stack.pop()

    @staticmethod
    def stand_in(y):
        """The ys of the trips that did not run: y without its graph, so
        the backward of a loop's stacked ys reaches the middle trip's
        nodes once, as each trip's nodes are reached once in a full
        loop."""
        return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                        else t, y)

    def _seq_now(self) -> int:
        probe = torch.empty((), device="meta", requires_grad=True).view(())
        return probe.grad_fn._sequence_nr()

    @staticmethod
    def _edge_key(node, nr):
        if type(node).__name__ == "AccumulateGrad":
            return ("leaf", id(node.variable))
        return (node._sequence_nr(), nr)

    def _tag(self, outputs, inputs, start, n: int, outer: float) -> None:
        """Multiply every autograd node created since `start` and
        reachable from `outputs` by n.  A gradient such a node sends to
        a node from before the trip, other than along the carry or the
        trip's xs, reaches the same input from every trip of a full
        loop and is summed there n - 1 more times: each such edge is
        charged those sums (at the multiplier around the loop)."""
        if start is None:
            return
        own = set()
        carry, xs = inputs
        for t in _tensors(carry) + _tensors(xs):
            if t.grad_fn is not None:
                own.add((t.grad_fn._sequence_nr(), t.output_nr))
            elif t.requires_grad:
                own.add(("leaf", id(t)))
        for t in _tensors(xs):
            # each trip has its own slot of the xs' node: sums there are
            # the trip's
            if t.grad_fn is not None:
                key = (t.grad_fn._sequence_nr(), t.output_nr)
                self._slot_times[key] = self._slot_times.get(key, 1.0) * n
        seen = set()
        todo = [t.grad_fn for t in _tensors(outputs)
                if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            seq = node._sequence_nr()
            if seq in seen:
                continue
            seen.add(seq)
            self.node_mult[seq] = self.node_mult.get(seq, 1.0) * n
            self._track(node)
            shared = []
            for i, (nxt, nr) in enumerate(node.next_functions):
                if nxt is None:
                    continue
                before = (type(nxt).__name__ == "AccumulateGrad"
                          or nxt._sequence_nr() <= start)
                if not before:
                    todo.append(nxt)
                elif self._edge_key(nxt, nr) not in own:
                    shared.append(i)
            if shared:
                node.register_hook(self._sums_hook(shared, (n - 1) * outer))

    def _sums_hook(self, shared, times: float):
        def hook(grad_inputs, grad_outputs):
            for i in shared:
                g = grad_inputs[i]
                if g is not None:
                    c = Cost(float(g.numel()),
                             float(g.numel() * g.element_size())
                             ).scaled(times)
                    self.total += c
                    self.by_op.setdefault("add", Cost()).__iadd__(c)
        return hook

    def remat_contexts(self):
        mult = self._mult()

        @contextlib.contextmanager
        def recompute():
            self._recompute += 1
            self._stack.append(mult)
            try:
                yield
            finally:
                self._stack.pop()
                self._recompute -= 1

        return contextlib.nullcontext(), recompute()

    # ------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in _FREE_OPS or func.is_view:
            return
        outs = _tensors(out)
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            nbytes = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        elif packet in _MEM_IN_OPS:
            flops = 0.0
            nbytes = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        else:
            flops = float(_numel(outs))
            nbytes = _nbytes(outs)
        c = Cost(flops, float(nbytes)).scaled(self._mult(func))
        self.total += c
        self.by_op.setdefault(packet.__name__, Cost()).__iadd__(c)


def _run(fn, args, kwargs, scale_loops: bool) -> _CountMode:
    mode = _CountMode()
    if scan_mod._HOOK is not None:
        raise RuntimeError("traced_cost does not nest")
    if scale_loops:
        scan_mod._HOOK = mode
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        scan_mod._HOOK = None
    return mode


def traced_cost(fn, *args, scale_loops: bool = True, **kwargs) -> Cost:
    """Cost of fn(*args, **kwargs) (args may be `meta` tensors)."""
    return _run(fn, args, kwargs, scale_loops).total


def traced_cost_breakdown(fn, *args, scale_loops: bool = True,
                          **kwargs) -> Dict[str, Cost]:
    """Per-op {flops, bytes} breakdown, keyed by the aten op's name (the
    matrix products under "mm", "bmm", "addmm", ...)."""
    return _run(fn, args, kwargs, scale_loops).by_op


MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
              "_convolution")


def matmul_flops(breakdown: Dict[str, Any]) -> float:
    """The matrix products' FLOPs of a breakdown (the reference's
    `dot_general` entry)."""
    return sum(breakdown[k].flops for k in MATMUL_OPS if k in breakdown)

"""The port's twin of `lax.scan`: a Python loop, and the cost counter's
rule for it.

The reference runs its stacks as scans (periods, loss chunks, q-chunks,
Mamba chunks and time steps); the port unrolls them eagerly (ROADMAP §C
divergence 11).  Eager unrolling is what the card wants, but it makes a
traced count of a full-size cell cost one Python trip per scan step
(64 layers x 32,768 time steps for falcon-mamba at prefill_32k).  The
reference's cost walker instead scales a scan body by its length
(`launch/jaxpr_cost.py`), and `launch/op_cost.py` gives the port the
same rule: while it counts with loop scaling it installs a hook here,
and a `scan` of more than 3 trips then runs its first trip, one middle
trip and its last, the middle one's cost (forward, and backward through
its autograd nodes) scaled by n - 2 and its `y` standing for every
middle trip's.  `remat_context` is the `context_fn` the
port's `torch.utils.checkpoint` calls pass, so a recomputed region is
counted at the trips of the loops around it.  Outside the counter
nothing changes (ROADMAP §C divergence 18).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

# set by launch/op_cost.py while it counts with loop scaling: an object
# with `scaled(n, inputs)` (a context manager whose value `tag(outputs)`
# marks the trip's autograd nodes as run n times), `stand_in(y)` (y for
# the trips that did not run) and `remat_contexts()`
_HOOK = None


def scan(body: Callable[[Any, Any], Tuple[Any, Any]], carry,
         n: Optional[int] = None, xs: Optional[Sequence] = None
         ) -> Tuple[Any, List[Any]]:
    """(carry, [y_0, ..., y_{n-1}]) of `carry, y_i = body(carry, x_i)`,
    as `lax.scan` returns them (ys as a list): x_i is `xs[i]` (n =
    len(xs)) or, without `xs`, the trip index i."""
    if xs is not None:
        n = len(xs)
    hook = _HOOK
    if hook is None or n <= 3:
        ys = []
        for i in range(n):
            carry, y = body(carry, i if xs is None else xs[i])
            ys.append(y)
        return carry, ys
    # under the counter: the first trip, one middle trip standing for
    # the n - 2 middle ones, and the last (each has its own neighbours
    # in a full loop: no carry in / a carry out to the next trip / a
    # carry out of the loop)
    ys = []
    for i, times in ((0, 1), (1, n - 2), (n - 1, 1)):
        x_i = i if xs is None else xs[i]
        with hook.scaled(times, (carry, x_i)) as tag:
            carry, y = body(carry, x_i)
            tag((carry, y))
        ys.append(y)
    return carry, ([ys[0], ys[1]] + [hook.stand_in(ys[1])] * (n - 3)
                   + [ys[2]])


def remat_context():
    """`context_fn` for `torch.utils.checkpoint(..., use_reentrant=False)`:
    no-op contexts, or the counter's pair for the forward and the
    recomputation."""
    if _HOOK is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return _HOOK.remat_contexts()

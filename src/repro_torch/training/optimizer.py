"""AdamW with decoupled weight decay and global-norm clipping, as plain
functions over the reference's parameter layout (a list of per-layer
dicts of tensors; any nesting of dicts, lists and tuples works).

The reference's exact formula, which `torch.optim.AdamW` with default
parameter groups does not give: b2 = 0.95, weight decay only on tensors
with more than one dimension, bias correction on the step count.  By
default the updates return new tensors and never write into their
arguments, so a checkpoint or a caller's reference stays as it was;
`inplace=True` writes the same values into them instead (the LM
launcher's step, whose state would not fit twice on one card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's flattening order (dict keys sorted,
    sequences in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of
    `rest`), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in flattening order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def init_opt_state(params) -> Dict[str, Any]:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float, inplace: bool = False):
    """(clipped grads, global norm).  `inplace` scales the gradient
    tensors themselves (the caller owns them) and returns the same tree."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    if inplace:
        for g in tree_leaves(grads):
            g.copy_(g * scale)
        return grads, norm
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, lr,
                 inplace: bool = False):
    """Returns (new_params, new_opt_state).  With `inplace` the same
    formula is written into the parameter and moment tensors themselves
    (the counterpart of the reference launcher's donated buffers: no
    second copy of the state), and the same trees are returned with the
    new count."""
    count = opt_state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() > 1 else 0.0
        newp = p - lr * (step + decay * p.to(torch.float32))
        return newp.to(p.dtype), m, v

    if inplace:
        with torch.no_grad():
            for g, m, v, p in zip(
                    tree_leaves(grads), tree_leaves(opt_state["m"]),
                    tree_leaves(opt_state["v"]), tree_leaves(params)):
                newp, newm, newv = upd(g, m, v, p)
                m.copy_(newm)
                v.copy_(newv)
                p.copy_(newp)
                del newp, newm, newv
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "count": count}
    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}

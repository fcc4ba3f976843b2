"""Parameter descriptors: one definition drives init, abstract shapes and
sharding-spec construction, so parameters and their PartitionSpecs can
never drift apart.

Each leaf is declared with logical axes per dimension; the mesh-rule
table maps logical axes to mesh axes (with divisibility fallback to
replication), following the 2-D sharding scheme of DESIGN.md S5:
    embed   -> "data"   (FSDP-style: gathered just-in-time)
    mlp/heads/vocab/experts -> "model" (tensor/expert parallel)

The reference's module over torch: `ParamSpec.initialize` draws from an
explicit `torch.Generator`, `tree_shapes` builds `meta` tensors, and a
`PartitionSpec` is the port's own tuple type (`tuple(P("data", None))`
is `("data", None)`, as for the reference's).  Trees are nested dicts
(and lists or tuples) whose leaves are specs, in the reference's
flattening order: dict keys sorted, sequences in order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


def _normalized(axis):
    """An entry as the reference's PartitionSpec stores it: a one-axis
    tuple is that axis, an empty tuple is None."""
    if isinstance(axis, tuple) and len(axis) <= 1:
        return axis[0] if axis else None
    return axis


class PartitionSpec(tuple):
    """Mesh axes per dimension (None: replicated), as `jax.sharding.
    PartitionSpec`: `PartitionSpec("data", None)`, entries normalised as
    the reference's are (`("data",)` is `"data"`)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_normalized(a) for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def map_tree(fn: Callable, tree, *, is_leaf: Callable = lambda x: False):
    """`fn` over the leaves of a tree of dicts / lists / tuples, keeping
    its structure; `is_leaf` stops the descent (a `PartitionSpec` is a
    tuple, so a tree of them passes `is_leaf`)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, is_leaf=is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree, *, is_leaf: Callable = lambda x: False):
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf=is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf=is_leaf)]
    return [tree]


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"          # "normal" | "zeros" | "ones"
    scale: float = 1.0
    dtype: Any = torch.float32

    def initialize(self, generator: torch.Generator,
                   device=None) -> torch.Tensor:
        """The leaf drawn from `generator` (on its device unless
        `device` is given)."""
        dev = generator.device if device is None else torch.device(device)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        s = self.scale / np.sqrt(max(fan_in, 1))
        out = torch.randn(self.shape, generator=generator,
                          dtype=torch.float32, device=dev)
        return out.mul_(float(s)).to(self.dtype)


# default logical-axis -> mesh-axis rules (DESIGN.md S5)
DEFAULT_RULES = {
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "batch": ("pod", "data"),
    "seq": "model",
}


def _axis_size(mesh_shape: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([mesh_shape.get(a, 1) for a in axis]))
    return mesh_shape.get(axis, 1)


def spec_to_pspec(spec: ParamSpec, mesh_shape: dict,
                  rules=None) -> PartitionSpec:
    """Logical axes -> PartitionSpec with divisibility fallback."""
    rules = rules or DEFAULT_RULES
    out = []
    for dim, ax in zip(spec.shape, spec.logical_axes):
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None or dim % _axis_size(mesh_shape, mesh_ax) != 0:
            out.append(None)
        else:
            out.append(mesh_ax)
    return PartitionSpec(*out)


def tree_initialize(spec_tree, generator: torch.Generator, device=None):
    """Every leaf drawn from `generator` in flattening order."""
    def draw(node):
        if _is_spec(node):
            return node.initialize(generator, device)
        if isinstance(node, dict):
            drawn = {k: draw(node[k]) for k in sorted(node)}
            return {k: drawn[k] for k in node}
        return type(node)(draw(v) for v in node)
    return draw(spec_tree)


def tree_shapes(spec_tree):
    """A tree of `meta` tensors (shape and dtype, no storage): the
    reference's ShapeDtypeStruct tree."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    spec_tree, is_leaf=_is_spec)


def tree_pspecs(spec_tree, mesh_shape: dict, rules=None):
    return map_tree(lambda s: spec_to_pspec(s, mesh_shape, rules),
                    spec_tree, is_leaf=_is_spec)


def stack_specs(spec_tree, n: int):
    """Stack a per-layer spec tree n times along a new leading (layer) axis."""
    return map_tree(
        lambda s: ParamSpec((n,) + s.shape, (None,) + s.logical_axes,
                            s.init, s.scale, s.dtype),
        spec_tree, is_leaf=_is_spec)


def param_count(spec_tree) -> int:
    leaves = tree_leaves(spec_tree, is_leaf=_is_spec)
    return int(sum(np.prod(s.shape) for s in leaves))


__all__ = ["DEFAULT_RULES", "P", "ParamSpec", "PartitionSpec", "map_tree",
           "param_count", "spec_to_pspec", "stack_specs", "tree_initialize",
           "tree_leaves", "tree_pspecs", "tree_shapes"]

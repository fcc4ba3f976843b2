"""Input stand-ins and sharding specs per (arch x shape).

The four assigned input shapes:
    train_4k    seq=4096   global_batch=256   -> train_step
    prefill_32k seq=32768  global_batch=32    -> prefill_step
    decode_32k  seq=32768  global_batch=128   -> serve_step (1 new token)
    long_500k   seq=524288 global_batch=1     -> serve_step, sub-quadratic
                                                 archs only

A stand-in is a `meta` tensor: the reference's ShapeDtypeStruct, shape
and dtype without storage; `decode_state_specs` is `init_decode_state`
on `meta`, where the reference `jax.eval_shape`s it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import (batch_pspec, make_rules,
                                             mesh_shape_dict)
from repro_torch.nn import transformer as T
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import PartitionSpec as P
from repro_torch.nn.param import _axis_size

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "skipped: full-attention arch (quadratic at 500k)"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------- inputs
def train_batch_specs(cfg: ModelConfig, seq: int, batch: int):
    """The train batch's stand-in tree (tokens, labels, and the stub
    frontends' embeddings for vlm / encdec)."""
    b = {
        "tokens": sds((batch, seq), torch.int32),
        "labels": sds((batch, seq), torch.int32),
    }
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = sds((batch, cfg.n_patches, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "encdec":
        extras["frames"] = sds((batch, seq, cfg.d_model), torch.bfloat16)
    if extras:
        b["extras"] = extras
    return b


def train_batch_pspecs(cfg: ModelConfig, mesh, rules=None):
    rules = rules or make_rules(mesh)
    b = {
        "tokens": batch_pspec(mesh, 2, seq_axis=1, rules=rules),
        "labels": batch_pspec(mesh, 2, seq_axis=1, rules=rules),
    }
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = batch_pspec(mesh, 3, rules=rules)
    if cfg.family == "encdec":
        extras["frames"] = batch_pspec(mesh, 3, seq_axis=1, rules=rules)
    if extras:
        b["extras"] = extras
    return b


def _pspec_from_logical(shape, logical, mesh_shape, rules):
    used = set()
    out = []
    for dim, ax in zip(shape, logical):
        mesh_ax = rules.get(ax) if ax is not None else None
        key = tuple(mesh_ax) if isinstance(mesh_ax, tuple) else mesh_ax
        if (mesh_ax is None or dim % _axis_size(mesh_shape, mesh_ax) != 0
                or key in used):
            out.append(None)
        else:
            out.append(mesh_ax)
            used.add(key)
    return P(*out)


def decode_state_logical(cfg: ModelConfig):
    """Logical axes per decode-state leaf kind."""
    return {
        "k": (None, "batch", "seq", None, None),
        "v": (None, "batch", "seq", None, None),
        "mk": (None, "batch", "seq", None, None),
        "mv": (None, "batch", "seq", None, None),
        "conv": (None, "batch", None, "mlp"),
        "ssm": (None, "batch", "mlp", None),
        "pos": (),
    }


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode state's stand-in tree (`meta` tensors)."""
    return T.init_decode_state(cfg, batch, max_len, device="meta")


def decode_state_pspecs(cfg: ModelConfig, state_sds, mesh, rules=None):
    """A PartitionSpec per decode-state leaf, keyed by the leaf's name
    (as the reference's `tree_map_with_path` keys it)."""
    rules = rules or make_rules(mesh)
    ms = mesh_shape_dict(mesh)
    logical = decode_state_logical(cfg)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        la = logical.get(name)
        if la is None or node.dim() == 0:
            return P()
        return _pspec_from_logical(tuple(node.shape), la, ms, rules)

    return walk(state_sds, None)

"""Input stand-ins and sharding specs per (arch x shape), the training
half (the decode-state specs are ROADMAP A12b).

The four assigned input shapes:
    train_4k    seq=4096   global_batch=256   -> train_step
    prefill_32k seq=32768  global_batch=32    -> prefill_step
    decode_32k  seq=32768  global_batch=128   -> serve_step (1 new token)
    long_500k   seq=524288 global_batch=1     -> serve_step, sub-quadratic
                                                 archs only

A stand-in is a `meta` tensor: the reference's ShapeDtypeStruct, shape
and dtype without storage.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import batch_pspec, make_rules
from repro_torch.nn.config import ModelConfig

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

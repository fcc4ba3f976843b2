"""Composable model definition covering all assigned architecture
families, the training half (prefill, decode and their state are
ROADMAP A12b).

A model is a stack of `num_layers` blocks whose kinds repeat with
period `cfg.period()` (dense: 1; jamba: 8; vlm: 5; ...).  Parameters
for one period are declared as a dict of slots; the full stack is the
period tree stacked `num_layers / period` times.  The parameters are
the reference's tree: nested dicts of tensors keyed as `model_specs`
keys them, stacked leaves leading with the period index.

Where the reference runs the periods under one `lax.scan` with the body
under `jax.checkpoint`, the port loops over the periods on the stacked
weights (each stacked leaf unbound once, so the backward stacks its
gradient in one piece) with each period under `torch.utils.checkpoint`.

Entry points:
    model_specs / init_params / abstract_params / param_count
    forward_hidden, chunked_ce_loss, forward_train -> mean CE loss
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import layers as L
from repro_torch.nn import mamba as S
from repro_torch.nn import moe as M
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import (ParamSpec, stack_specs, tree_initialize,
                                  tree_leaves, tree_shapes)

Constrainer = L.Constrainer
no_sc = L.no_sc


# ======================================================================
# Parameter trees
# ======================================================================

def _block_specs(cfg: ModelConfig, kind: str, is_moe: bool,
                 decoder_cross: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    sp: Dict[str, Any] = {"norm1": L.rmsnorm_specs(d)}
    if kind == "attn":
        sp["attn"] = L.attention_specs(cfg)
    elif kind == "cross":
        sp["cross"] = L.attention_specs(cfg, kv_dim=cfg.frontend_dim or d)
    elif kind == "mamba":
        sp["mamba"] = S.mamba_specs(cfg)
    else:
        raise ValueError(kind)
    if decoder_cross:
        sp["norm_cross"] = L.rmsnorm_specs(d)
        sp["crossdec"] = L.attention_specs(cfg)
    if kind != "mamba" or cfg.family == "hybrid":
        # mamba-only archs (falcon) have no FFN; hybrid (jamba) does
        if cfg.d_ff > 0 or is_moe:
            sp["norm2"] = L.rmsnorm_specs(d)
            sp["ffn"] = (M.moe_specs(cfg) if is_moe
                         else L.mlp_specs(d, cfg.d_ff))
    return sp


def _period_specs(cfg: ModelConfig, decoder_cross: bool = False):
    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    p = cfg.period()
    return {f"slot{i}": _block_specs(cfg, kinds[i], moes[i], decoder_cross)
            for i in range(p)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, cfg.padded_vocab
    nper = cfg.num_layers // cfg.period()
    sp: Dict[str, Any] = {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), scale=1.0),
        "layers": stack_specs(_period_specs(cfg), nper),
        "final_norm": L.rmsnorm_specs(d),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, vp), ("embed", "vocab"))
    if cfg.family == "encdec":
        sp["encoder"] = {
            "layers": stack_specs(
                {"slot0": _block_specs(cfg, "attn", False)}, cfg.enc_layers),
            "final_norm": L.rmsnorm_specs(d),
        }
        # decoder blocks additionally carry cross-attention
        sp["layers"] = stack_specs(_period_specs(cfg, decoder_cross=True),
                                   nper)
    return sp


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Every leaf drawn from one `torch.Generator` seeded `seed`, on
    `device` (`cuda` unless the caller passes "cpu")."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return tree_initialize(model_specs(cfg), gen)


def abstract_params(cfg: ModelConfig):
    return tree_shapes(model_specs(cfg))


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.nn.param import param_count as pc
    return pc(model_specs(cfg))


# ======================================================================
# Blocks
# ======================================================================

def _apply_block(cfg: ModelConfig, kind: str, is_moe: bool, p, x,
                 cos, sin, sc: Constrainer, extras: Dict[str, Any],
                 q_chunk: int, decoder_cross: bool = False):
    """Training-mode block.  Returns (x, kv_or_None)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    h = sc(h, ("batch", "seq", None))
    h = sc(h, ("batch", "gathered_seq", None))
    kv = None
    if kind == "attn":
        a, kv = L.attention_train(cfg, p["attn"], h, cos, sin, sc,
                                  causal=extras.get("causal", True),
                                  q_chunk=q_chunk)
        x = x + a
    elif kind == "cross":
        mk, mv = L.cross_kv(cfg, p["cross"], extras["image_embeds"], sc)
        x = x + L.attention_cross(cfg, p["cross"], h, mk, mv, sc, q_chunk)
    elif kind == "mamba":
        x = x + S.mamba_train(cfg, p["mamba"], h, sc)
    if decoder_cross:
        h = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        mk, mv = (extras["memory_kv"] if "memory_kv" in extras
                  else L.cross_kv(cfg, p["crossdec"], extras["memory"], sc))
        x = x + L.attention_cross(cfg, p["crossdec"], h, mk, mv, sc, q_chunk)
    if "ffn" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        if is_moe:
            x = x + M.moe_ffn(cfg, p["ffn"], h, sc)
        else:
            x = x + L.mlp(p["ffn"], h, sc)
    x = sc(x, ("batch", "seq", None))
    return x, kv


# ======================================================================
# Forward (train)
# ======================================================================

def _unstack(tree, n: int):
    """n trees of per-period slices of a stacked tree (each leaf unbound
    once along its leading period axis)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    return list(tree.unbind(0))


def _stack_scan(cfg: ModelConfig, params_layers, x, cos, sin, sc, extras,
                q_chunk, decoder_cross: bool = False, remat: bool = True):
    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    per = cfg.period()
    nper = tree_leaves(params_layers)[0].shape[0]

    def period_body(x, slot_params, extras):
        for i in range(per):
            x, _ = _apply_block(cfg, kinds[i], moes[i],
                                slot_params[f"slot{i}"], x, cos, sin, sc,
                                extras, q_chunk, decoder_cross)
        return x

    for slot_params in _unstack(params_layers, nper):
        if remat and torch.is_grad_enabled():
            x = checkpoint(period_body, x, slot_params, extras,
                           use_reentrant=False)
        else:
            x = period_body(x, slot_params, extras)
    return x


def forward_hidden(cfg: ModelConfig, params, tokens, extras=None,
                   sc: Constrainer = no_sc, q_chunk: int = 512,
                   remat: bool = True):
    """tokens (B, S) -> final hidden states (B, S, D)."""
    extras = dict(extras or {})
    dt = cfg.compute_dtype
    x = F.embedding(tokens.long(), params["embed"].to(dt))
    x = sc(x, ("batch", "seq", None))
    s = tokens.shape[1]
    cos, sin = L.rope_tables(torch.arange(s, device=x.device), cfg.hd,
                             cfg.rope_theta)

    if cfg.family == "encdec":
        # encoder over stub frame embeddings (bidirectional)
        mem = extras["frames"].to(dt)
        mem = sc(mem, ("batch", "seq", None))
        sm = mem.shape[1]
        cose, sine = L.rope_tables(torch.arange(sm, device=x.device),
                                   cfg.hd, cfg.rope_theta)
        mem = _stack_scan(cfg, params["encoder"]["layers"], mem, cose, sine,
                          sc, {"causal": False}, q_chunk, remat=remat)
        mem = L.rmsnorm(params["encoder"]["final_norm"], mem, cfg.norm_eps)
        extras["memory"] = mem
        x = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
                        q_chunk, decoder_cross=True, remat=remat)
    else:
        x = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
                        q_chunk, remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _lm_head(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _chunk_loss(h_c, l_c, w):
    logits = (h_c @ w.to(h_c.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(l_c, 0).long()
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    mask = (l_c >= 0).to(torch.float32)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_ce_loss(cfg: ModelConfig, params, hidden, labels,
                    sc: Constrainer = no_sc, chunk: int = 256):
    """Cross-entropy without materialising (B, S, V) logits: loop over
    sequence chunks, recompute logits in the backward (checkpoint)."""
    b, s, d = hidden.shape
    w = _lm_head(cfg, params)
    chunk = min(chunk, s)
    assert s % chunk == 0
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h_c, l_c = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            tl, tm = checkpoint(_chunk_loss, h_c, l_c, w,
                                use_reentrant=False)
        else:
            tl, tm = _chunk_loss(h_c, l_c, w)
        tot, cnt = tot + tl, cnt + tm
    return tot / torch.clamp_min(cnt, 1.0)


def forward_train(cfg: ModelConfig, params, batch, sc: Constrainer = no_sc,
                  q_chunk: int = 512, loss_chunk: int = 256,
                  remat: bool = True):
    hidden = forward_hidden(cfg, params, batch["tokens"], batch.get("extras"),
                            sc, q_chunk, remat)
    return chunked_ce_loss(cfg, params, hidden, batch["labels"], sc,
                           loss_chunk)

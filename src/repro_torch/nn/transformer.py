"""Composable model definition covering all assigned architecture
families.

A model is a stack of `num_layers` blocks whose kinds repeat with
period `cfg.period()` (dense: 1; jamba: 8; vlm: 5; ...).  Parameters
for one period are declared as a dict of slots; the full stack is the
period tree stacked `num_layers / period` times.  The parameters are
the reference's tree: nested dicts of tensors keyed as `model_specs`
keys them, stacked leaves leading with the period index.

Where the reference runs the periods under one `lax.scan` with the body
under `jax.checkpoint`, the port loops over the periods on the stacked
weights (`nn/scan.py::scan`; each stacked leaf unbound once, so the
backward stacks its gradient in one piece) with each period under
`torch.utils.checkpoint` when grad is enabled.

Entry points:
    model_specs / init_params / abstract_params / param_count
    forward_hidden, chunked_ce_loss, forward_train -> mean CE loss
    prefill        -> last-token logits + decode state
    decode_step    -> next-token logits + the state, updated in place
    init_decode_state / fill_cross_kv

Decode keeps `state["pos"]` a 0-d int32 tensor on the state's device
and never reads it on the host.  `decode_step` writes the token's K/V,
conv and SSM state into the given state's tensors (the reference
donates its state to the jitted step): the state passed in is the state
returned, with a new `pos`.  Prefill and decode are inference: call
them under `torch.no_grad()`.
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
from repro_torch.nn.scan import remat_context, scan

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
    """Training/prefill-mode block.  Returns (x, kv_or_None)."""
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


def _decode_block(cfg: ModelConfig, kind: str, is_moe: bool, p, x, state,
                  pos, cos_t, sin_t, sc: Constrainer, decoder_cross):
    """One-token block.  state: dict for this slot (one period's slice of
    each leaf), written in place.  Returns x."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        a, _, _ = L.attention_decode(cfg, p["attn"], h, state["k"],
                                     state["v"], pos, cos_t, sin_t, sc)
        x = x + a
    elif kind == "cross":
        x = x + L.attention_cross(cfg, p["cross"], h, state["mk"],
                                  state["mv"], sc)
    elif kind == "mamba":
        y, cs, ss = S.mamba_decode(cfg, p["mamba"], h, state["conv"],
                                   state["ssm"], sc)
        state["conv"].copy_(cs)
        state["ssm"].copy_(ss)
        x = x + y
    if decoder_cross:
        h = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        x = x + L.attention_cross(cfg, p["crossdec"], h, state["mk"],
                                  state["mv"], sc)
    if "ffn" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + (M.moe_ffn(cfg, p["ffn"], h, sc) if is_moe
                 else L.mlp(p["ffn"], h, sc))
    return sc(x, ("batch", None, None))


# ======================================================================
# Forward (train / prefill)
# ======================================================================

def _unstack(tree, n: int):
    """n trees of per-period slices of a stacked tree (each leaf unbound
    once along its leading period axis)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    return list(tree.unbind(0))


def _stack_scan(cfg: ModelConfig, params_layers, x, cos, sin, sc, extras,
                q_chunk, collect_kv: bool = False,
                decoder_cross: bool = False, remat: bool = True):
    """The period loop.  Returns (x, kvs): with `collect_kv`, kvs maps
    each attention slot to its {"k", "v"} stacked over periods as
    (nper, B, S, KV, hd); else None."""
    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    per = cfg.period()
    nper = tree_leaves(params_layers)[0].shape[0]
    periods = _unstack(params_layers, nper)

    def period_body(x, slot_params, extras):
        kvs = {}
        for i in range(per):
            x, kv = _apply_block(cfg, kinds[i], moes[i],
                                 slot_params[f"slot{i}"], x, cos, sin, sc,
                                 extras, q_chunk, decoder_cross)
            if collect_kv and kv is not None:
                kvs[f"slot{i}"] = kv
        return x, kvs

    def body(x, slot_params):
        if remat and torch.is_grad_enabled():
            return checkpoint(period_body, x, slot_params, extras,
                              use_reentrant=False,
                              context_fn=remat_context)
        return period_body(x, slot_params, extras)

    x, kv_list = scan(body, x, xs=periods)
    if not collect_kv:
        return x, None
    return x, {slot: {"k": torch.stack([kv[slot][0] for kv in kv_list]),
                      "v": torch.stack([kv[slot][1] for kv in kv_list])}
               for slot in kv_list[0]}


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
        mem, _ = _stack_scan(cfg, params["encoder"]["layers"], mem, cose,
                             sine, sc, {"causal": False}, q_chunk,
                             remat=remat)
        mem = L.rmsnorm(params["encoder"]["final_norm"], mem, cfg.norm_eps)
        extras["memory"] = mem
        x, _ = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
                           q_chunk, decoder_cross=True, remat=remat)
    else:
        x, _ = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
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
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)

    def body(acc, c):
        c0 = c * chunk
        h_c, l_c = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            tl, tm = checkpoint(_chunk_loss, h_c, l_c, w,
                                use_reentrant=False,
                                context_fn=remat_context)
        else:
            tl, tm = _chunk_loss(h_c, l_c, w)
        return (acc[0] + tl, acc[1] + tm), None

    (tot, cnt), _ = scan(body, (zero, zero), s // chunk)
    return tot / torch.clamp_min(cnt, 1.0)


def forward_train(cfg: ModelConfig, params, batch, sc: Constrainer = no_sc,
                  q_chunk: int = 512, loss_chunk: int = 256,
                  remat: bool = True):
    hidden = forward_hidden(cfg, params, batch["tokens"], batch.get("extras"),
                            sc, q_chunk, remat)
    return chunked_ce_loss(cfg, params, hidden, batch["labels"], sc,
                           loss_chunk)



# ======================================================================
# Serving: prefill + decode
# ======================================================================

def _state_device(device) -> torch.device:
    """`meta` for shape-only stand-ins (the dry run), else the port's
    device rule."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    from repro_torch.device import resolve_device
    return resolve_device(device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None):
    """Zero decode state for every slot of every period, on `device`
    (`cuda` unless the caller passes "cpu"; "meta" gives stand-ins)."""
    dt = dtype or cfg.compute_dtype
    dev = _state_device(device)
    kinds = cfg.layer_kinds()
    per = cfg.period()
    nper = cfg.num_layers // per
    kv, hd = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    slots = {}
    for i in range(per):
        k = kinds[i]
        st = {}
        if k == "attn":
            st["k"] = zeros((nper, batch, max_len, kv, hd))
            st["v"] = zeros((nper, batch, max_len, kv, hd))
        elif k == "cross":
            np_ = cfg.n_patches
            st["mk"] = zeros((nper, batch, np_, kv, hd))
            st["mv"] = zeros((nper, batch, np_, kv, hd))
        elif k == "mamba":
            st["conv"] = zeros((nper, batch, cfg.d_conv - 1, cfg.d_inner))
            st["ssm"] = zeros((nper, batch, cfg.d_inner, cfg.ssm_state),
                              torch.float32)
        if cfg.family == "encdec":
            sm = max_len  # memory length == prompt frame length
            st["mk"] = zeros((nper, batch, sm, kv, hd))
            st["mv"] = zeros((nper, batch, sm, kv, hd))
        slots[f"slot{i}"] = st
    return {"layers": slots, "pos": zeros((), torch.int32)}


def decode_step(cfg: ModelConfig, params, state, tokens,
                sc: Constrainer = no_sc):
    """tokens (B, 1) -> (logits (B, Vp) fp32, state): the state's tensors
    updated in place, `pos` advanced by one."""
    dt = cfg.compute_dtype
    pos = state["pos"]
    x = F.embedding(tokens.long(), params["embed"].to(dt))
    x = sc(x, ("batch", None, None))
    cos_t, sin_t = L.rope_tables(pos[None], cfg.hd, cfg.rope_theta)

    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    per = cfg.period()
    nper = tree_leaves(params["layers"])[0].shape[0]
    decoder_cross = cfg.family == "encdec"
    periods = _unstack(params["layers"], nper)
    states = _unstack(state["layers"], nper)

    def body(x, period):
        slot_params, slot_state = period
        for i in range(per):
            x = _decode_block(cfg, kinds[i], moes[i],
                              slot_params[f"slot{i}"], x,
                              slot_state[f"slot{i}"], pos, cos_t, sin_t, sc,
                              decoder_cross)
        return x, None

    x, _ = scan(body, x, xs=list(zip(periods, states)))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ _lm_head(cfg, params).to(dt)).to(torch.float32)
    logits = sc(logits, ("batch", "vocab"))
    return logits, {"layers": state["layers"], "pos": pos + 1}


def prefill(cfg: ModelConfig, params, tokens, extras=None,
            sc: Constrainer = no_sc, q_chunk: int = 512, max_len=None):
    """Run the prompt, return (last-token logits, decode state) on the
    tokens' device."""
    extras = dict(extras or {})
    dt = cfg.compute_dtype
    b, s = tokens.shape
    max_len = max_len or s
    dev = tokens.device
    x = F.embedding(tokens.long(), params["embed"].to(dt))
    x = sc(x, ("batch", "seq", None))
    cos, sin = L.rope_tables(torch.arange(s, device=dev), cfg.hd,
                             cfg.rope_theta)

    if cfg.family == "encdec":
        mem = extras["frames"].to(dt)
        sm = mem.shape[1]
        cose, sine = L.rope_tables(torch.arange(sm, device=dev), cfg.hd,
                                   cfg.rope_theta)
        mem, _ = _stack_scan(cfg, params["encoder"]["layers"], mem, cose,
                             sine, sc, {"causal": False}, q_chunk)
        mem = L.rmsnorm(params["encoder"]["final_norm"], mem, cfg.norm_eps)
        extras["memory"] = mem
        x, kvs = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
                             q_chunk, collect_kv=True, decoder_cross=True)
    else:
        x, kvs = _stack_scan(cfg, params["layers"], x, cos, sin, sc, extras,
                             q_chunk, collect_kv=True)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, -1] @ _lm_head(cfg, params).to(dt)).to(torch.float32)

    # assemble the decode state: the prompt's K/V in the first s slots
    state = init_decode_state(cfg, b, max_len, device=dev)
    state["pos"] = torch.full((), s, dtype=torch.int32, device=dev)
    for slot, st in (kvs or {}).items():
        for name in ("k", "v"):
            state["layers"][slot][name][:, :, :s] = st[name]
    if cfg.family == "encdec":
        state = fill_cross_kv(cfg, params, state, extras["memory"], sc)
    if cfg.family == "vlm" and "image_embeds" in extras:
        state = fill_cross_kv(cfg, params, state, extras["image_embeds"], sc)
    return logits, state


def fill_cross_kv(cfg: ModelConfig, params, state, memory,
                  sc: Constrainer = no_sc):
    """Precompute per-layer cross-attention K/V from the memory (encoder
    output or image patch embeddings) into the decode state: each slot's
    `mk` / `mv` become (nper, B, Sm, KV, hd) in the memory's dtype (the
    reference `vmap`s over periods; the port loops over them)."""
    kinds = cfg.layer_kinds()
    per = cfg.period()
    nper = tree_leaves(params["layers"])[0].shape[0]
    layers = dict(state["layers"])
    for i in range(per):
        key = None
        if cfg.family == "encdec":
            key = "crossdec"
        elif kinds[i] == "cross":
            key = "cross"
        if key is None:
            continue
        kv = [L.cross_kv(cfg, pl[key], memory, sc)
              for pl in _unstack(params["layers"][f"slot{i}"], nper)]
        st = dict(layers[f"slot{i}"])
        st["mk"] = torch.stack([k for k, _ in kv])
        st["mv"] = torch.stack([v for _, v in kv])
        layers[f"slot{i}"] = st
    return {**state, "layers": layers}

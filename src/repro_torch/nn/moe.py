"""Mixture-of-Experts FFN with sorted, capacity-bounded dispatch.

Edge-centric note (DESIGN.md S6): token->expert routing is a bipartite
graph whose edges are the top-k assignments; the dispatch below is the
EnGN aggregate stage on that graph — group edges by destination
(expert), reduce with dense matmuls, scatter back to sources.  Capacity
bounding is the power-law / DAVC insight: hot experts (hubs) would
otherwise blow up the dense compute buffer, so overflow tokens are
dropped exactly as the paper bounds its on-chip working set.

The reference's dense dispatch, op for op (stable sort by expert,
capacity ceil(T k / E * capacity_factor), drops past it); on a mesh
whose model axis is above 1 the dispatcher takes the expert-parallel
all-to-all path (`moe_a2a.py`), as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import Constrainer, mlp, no_sc
from repro_torch.nn.param import ParamSpec


def moe_specs(cfg: ModelConfig):
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    sp = {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, ff), ("experts", "embed", None)),
        "w_up": ParamSpec((e, d, ff), ("experts", "embed", None)),
        "w_down": ParamSpec((e, ff, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        sp["shared"] = {
            "w_gate": ParamSpec((d, sff), ("embed", "mlp")),
            "w_up": ParamSpec((d, sff), ("embed", "mlp")),
            "w_down": ParamSpec((sff, d), ("mlp", "embed")),
        }
    return sp


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, sc: Constrainer = no_sc,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Dispatcher: the expert-parallel all-to-all path when the
    constrainer carries a mesh with a model axis > 1, else the
    single-device dense dispatch."""
    mesh = getattr(sc, "mesh", None)
    rules = getattr(sc, "rules", None)
    if mesh is not None and rules is not None:
        from repro_torch.nn.moe_a2a import model_axis_size, moe_ffn_a2a
        if model_axis_size(mesh, rules) > 1:
            return moe_ffn_a2a(cfg, p, x, mesh, rules,
                               capacity_factor=capacity_factor)
    return moe_ffn_dense(cfg, p, x, sc, capacity_factor)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor,
          capacity_factor: float = 1.25, cap: Optional[int] = None):
    """The routing of xf (..., T, D), each leading index a block routed
    on its own: a dict of the top-k probabilities and experts (..., T,
    k), the capacity `cap` (ceil(T k / E * capacity_factor) unless
    given: the all-to-all path passes its per-block one), and per routed
    token in expert order (..., T*k) its expert `ge`, token `gt`, weight
    `gp`, position in its group `pos`, `keep` (pos < cap) and buffer
    `slot` (e * cap for a drop)."""
    t = xf.shape[-2]
    lead = xf.shape[:-2]
    e, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)               # (..., T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    if cap is None:
        cap = int(np.ceil(t * k / e * capacity_factor))
    flat_e = top_i.reshape(lead + (t * k,))                    # (..., T*k)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_p = top_p.reshape(lead + (t * k,))

    order = torch.argsort(flat_e, dim=-1, stable=True)         # by expert
    ge = torch.take_along_dim(flat_e, order, dim=-1)
    gt = flat_t[order]
    gp = torch.take_along_dim(flat_p, order, dim=-1)
    experts = torch.arange(e, device=dev).expand(lead + (e,)).contiguous()
    group_start = torch.searchsorted(ge.contiguous(), experts)
    pos = (torch.arange(t * k, device=dev)
           - torch.take_along_dim(group_start, ge, dim=-1))
    keep = pos < cap
    slot = torch.where(keep, ge * cap + pos,
                       torch.full_like(pos, e * cap))
    return {"top_p": top_p, "top_i": top_i, "cap": cap, "ge": ge,
            "gt": gt, "gp": gp, "pos": pos, "keep": keep, "slot": slot}


def moe_ffn_dense(cfg: ModelConfig, p, x: torch.Tensor,
                  sc: Constrainer = no_sc,
                  capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    xf = x.reshape(t, d)
    r = route(cfg, p["router"], xf, capacity_factor)
    cap, gt, gp, keep, slot = r["cap"], r["gt"], r["gp"], r["keep"], r["slot"]

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype,
                      device=x.device).index_put((slot,), xf[gt])
    buf = buf[:-1].reshape(e, cap, d)
    buf = sc(buf, ("experts", None, None))

    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(x.dtype)))
         * torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(x.dtype)))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(x.dtype))
    out_buf = sc(out_buf, ("experts", None, None))

    contrib = out_buf.reshape(e * cap, d)[torch.clamp_max(slot, e * cap - 1)]
    contrib = contrib * (gp * keep).to(x.dtype)[:, None]
    out = torch.zeros((t, d), dtype=x.dtype,
                      device=x.device).index_add(0, gt, contrib)

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf, no_sc)
    return out.reshape(b, s, d)


def aux_load_balance_loss(cfg: ModelConfig, p,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction-routed * mean-prob per expert)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(torch.float32)
    probs = torch.softmax(xf @ p["router"].to(torch.float32), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(top1, cfg.n_experts).to(torch.float32), dim=0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))

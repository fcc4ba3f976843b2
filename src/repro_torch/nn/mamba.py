"""Mamba-1 selective SSM block (falcon-mamba, jamba hybrid layers):
training / prefill over a sequence, and one-token decode as a single
state update.  The recurrence (per channel c, state dim n):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = <C_t, h_t> + D * x_t

The reference scans time in chunks of at most 256 steps, each chunk
rematerialised (`jax.checkpoint`) so the backward keeps only the chunk
boundary states; here each chunk runs under `torch.utils.checkpoint`
and both loops are `nn/scan.py::scan`s, as the reference's are XLA
scans.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import Constrainer, no_sc
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.scan import remat_context, scan


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, int(np.ceil(cfg.d_model / 16)))


def mamba_specs(cfg: ModelConfig):
    d, di, n, kc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    r = dt_rank(cfg)
    return {
        "w_in": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((kc, di), (None, "mlp")),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros"),
        "w_x": ParamSpec((di, r + 2 * n), ("mlp", None)),
        "w_dt": ParamSpec((r, di), (None, "mlp")),
        "dt_bias": ParamSpec((di,), ("mlp",), init="ones"),
        "a_log": ParamSpec((di, n), ("mlp", None), init="ones"),
        "d_skip": ParamSpec((di,), ("mlp",), init="ones"),
        "w_out": ParamSpec((di, d), ("mlp", "embed")),
    }


def _ssm_params(cfg, p, xc, weights=None):
    """xc: (..., di) post-conv activations -> dt (..., di), B/C (..., n).

    `weights` lets the caller pass pre-cast (w_x, w_dt, dt_bias) so a
    chunked caller does not re-cast them per chunk."""
    r, n = dt_rank(cfg), cfg.ssm_state
    if weights is None:
        weights = (p["w_x"].to(xc.dtype), p["w_dt"].to(xc.dtype),
                   p["dt_bias"].to(xc.dtype))
    w_x, w_dt, dt_bias = weights
    dbc = xc @ w_x
    dt_low, bmat, cmat = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(dt_low @ w_dt + dt_bias)
    return dt, bmat, cmat


def _causal_conv(p, x):
    """Depthwise causal conv over seq: x (B, S, di)."""
    kc = p["conv_w"].shape[0]
    w = p["conv_w"].to(x.dtype)                        # (kc, di)
    xpad = F.pad(x, (0, 0, kc - 1, 0))
    out = sum(xpad[:, i:i + x.shape[1], :] * w[i] for i in range(kc))
    return out + p["conv_b"].to(x.dtype)


def _scan_chunk(cfg, p, a, ssm_w, h, x1_chunk):
    """One chunk of the time scan: x1_chunk (chunk, B, di), carry h
    (B, di, n) fp32 -> (h, ys (chunk, B, di))."""
    dt_c, b_c, c_c = _ssm_params(cfg, p, x1_chunk, ssm_w)   # (chunk, B, *)

    def step(h, xs_t):
        xt, dtt, bt, ct = xs_t
        da = torch.exp(dtt.to(torch.float32)[:, :, None] * a[None])
        h = (h * da + (dtt * xt).to(torch.float32)[:, :, None]
             * bt.to(torch.float32)[:, None, :])
        y = torch.einsum("bdn,bn->bd", h, ct.to(torch.float32))
        return h, y.to(xt.dtype)

    h, ys = scan(step, h, xs=list(zip(x1_chunk.unbind(0), dt_c.unbind(0),
                                      b_c.unbind(0), c_c.unbind(0))))
    return h, torch.stack(ys)


def mamba_train(cfg: ModelConfig, p, x, sc: Constrainer = no_sc,
                remat: bool = True):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = x @ p["w_in"].to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1 = sc(x1, ("batch", None, "mlp"))
    x1 = F.silu(_causal_conv(p, x1))
    a = -torch.exp(p["a_log"].to(torch.float32))       # (di, n)

    chunk = min(256, s)
    while s % chunk:
        chunk //= 2
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    x1_t = x1.transpose(0, 1)                          # (S, B, di)
    ssm_w = (p["w_x"].to(x.dtype), p["w_dt"].to(x.dtype),
             p["dt_bias"].to(x.dtype))

    def chunk_body(h, c):
        args = (cfg, p, a, ssm_w, h, x1_t[c * chunk:(c + 1) * chunk])
        if remat and torch.is_grad_enabled():
            return checkpoint(_scan_chunk, *args, use_reentrant=False,
                              context_fn=remat_context)
        return _scan_chunk(*args)

    _, ys = scan(chunk_body, h, s // chunk)
    y = torch.cat(ys).transpose(0, 1) + x1 * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    y = sc(y, ("batch", None, "mlp"))
    return y @ p["w_out"].to(x.dtype)


def mamba_decode(cfg: ModelConfig, p, x, conv_state, ssm_state,
                 sc: Constrainer = no_sc):
    """One-token decode.  x: (B, 1, D); conv_state: (B, d_conv-1, di) in
    the compute dtype; ssm_state: (B, di, n) fp32.  Returns (y,
    conv_state, ssm_state), the states new tensors."""
    xz = x[:, 0] @ p["w_in"].to(x.dtype)               # (B, 2di)
    x1, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([conv_state, x1[:, None, :].to(conv_state.dtype)],
                       dim=1)                          # (B, kc, di)
    conv_state = window[:, 1:]
    w = p["conv_w"].to(x.dtype)
    xc = F.silu(torch.einsum("bkd,kd->bd", window.to(x.dtype), w)
                + p["conv_b"].to(x.dtype))
    dt, bmat, cmat = _ssm_params(cfg, p, xc)
    a = -torch.exp(p["a_log"].to(torch.float32))
    da = torch.exp(dt.to(torch.float32)[:, :, None] * a[None])
    ssm_state = (ssm_state * da + (dt * xc).to(torch.float32)[:, :, None]
                 * bmat.to(torch.float32)[:, None, :])
    y = torch.einsum("bdn,bn->bd", ssm_state,
                     cmat.to(torch.float32)).to(x.dtype)
    y = y + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    return (y @ p["w_out"].to(x.dtype))[:, None, :], conv_state, ssm_state

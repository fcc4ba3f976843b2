"""Core transformer layers: RMSNorm, RoPE, GQA attention (full
sequence, cross, and one-token decode against a KV cache), SwiGLU MLP.

All functions are pure over tensors; parameters are declared via
ParamSpec trees so init / abstract shapes / PartitionSpecs derive from
one definition.  Every activation passes through an optional
`sc(x, logical_axes)` sharding constrainer (identity when not
distributed).  The reference's attention is an einsum formulation run
by XLA, not a kernel, so this one is plain PyTorch: scores in fp32 (the
compute-dtype products accumulated in fp32) and `-1e30` masking, as the
reference has them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.scan import scan

Constrainer = Callable[[torch.Tensor, tuple], torch.Tensor]


def no_sc(x, axes):
    return x


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_specs(d: int):
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    """Variance in fp32; the (B, S, D) output is produced by
    compute-dtype multiplies, only the (B, S, 1) inverse rms is fp32."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * p["scale"].to(dt)


# ---------------------------------------------------------------- RoPE
def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """positions: (S,) -> cos/sin (S, hd/2), fp32."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, H, hd); cos/sin: (S, hd/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- Attention
def attention_specs(cfg: ModelConfig, kv_dim: Optional[int] = None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kd = kv_dim or d
    sp = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((kd, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((kd, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((h, hd), ("heads", None), init="zeros")
        sp["bk"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
        sp["bv"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
    return sp


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(cfg: ModelConfig, p, x, x_kv, sc: Constrainer):
    q = _proj(x, p["wq"])
    k = _proj(x_kv, p["wk"])
    v = _proj(x_kv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = sc(q, ("batch", None, "heads", None))
    k = sc(k, ("batch", None, "kv_heads", None))
    v = sc(v, ("batch", None, "kv_heads", None))
    return q, k, v


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * k, d)


def _sdpa(cfg: ModelConfig, q, k, v, mask_fn, q_offset, sc: Constrainer,
          q_chunk: int = 512):
    """Grouped-query attention, q-chunked to bound the score tensor.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).  mask_fn(qpos, kpos) -> bool.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / np.sqrt(hd)
    kpos = torch.arange(sk, device=q.device)
    k32 = k.to(torch.float32)

    def chunk_attn(qc, qstart):
        cq = qc.shape[1]
        qg = qc.reshape(b, cq, kv, g, hd).to(torch.float32)
        scores = torch.einsum("bqkgh,bskh->bqkgs", qg, k32) * scale
        qpos = q_offset + qstart + torch.arange(cq, device=q.device)
        m = torch.broadcast_to(mask_fn(qpos[:, None], kpos[None, :]),
                               (cq, sk))                     # (cq, sk)
        scores = torch.where(m[None, :, None, None, :], scores,
                             torch.full((), -1e30, device=q.device))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bqkgs,bskh->bqkgh", w.to(v.dtype), v)
        return out.reshape(b, cq, h, hd)

    if sq <= q_chunk:
        out = chunk_attn(q, 0)
    else:
        assert sq % q_chunk == 0, (sq, q_chunk)

        def body(_, i):
            i0 = i * q_chunk
            return None, chunk_attn(q[:, i0:i0 + q_chunk], i0)

        _, outs = scan(body, None, sq // q_chunk)
        out = torch.cat(outs, dim=1)
    return sc(out, ("batch", None, "heads", None))


def _causal(qp, kp):
    return kp <= qp


def _everything(qp, kp):
    return torch.ones((), dtype=torch.bool, device=qp.device)


def attention_train(cfg: ModelConfig, p, x, cos, sin, sc: Constrainer = no_sc,
                    causal: bool = True, q_chunk: int = 512):
    """Self-attention over a full sequence (training / encoder)."""
    q, k, v = _qkv(cfg, p, x, x, sc)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _sdpa(cfg, q, k, v, _causal if causal else _everything, 0, sc,
                q_chunk)
    return _out_proj(out, p["wo"]), (k, v)


def attention_decode(cfg: ModelConfig, p, x, cache_k, cache_v, pos,
                     cos_t, sin_t, sc: Constrainer = no_sc):
    """One-token decode: x (B, 1, D); cache (B, S, KV, hd); pos a 0-d
    int tensor (never read on the host).  The token's k / v are written
    into the caches in place at `pos`, clamped to the last slot as
    `dynamic_update_slice` clamps its start (so `pos >= S` overwrites
    slot S - 1 and does not fail); returns (out, cache_k, cache_v)."""
    q, k, v = _qkv(cfg, p, x, x, sc)
    q = apply_rope(q, cos_t, sin_t)
    k = apply_rope(k, cos_t, sin_t)
    at = torch.clamp(pos, 0, cache_k.shape[1] - 1).reshape(1).long()
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    cache_k = sc(cache_k, ("batch", "seq", None, None))
    cache_v = sc(cache_v, ("batch", "seq", None, None))
    out = _sdpa(cfg, q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                lambda qp, kp: kp <= pos, pos, sc)
    return _out_proj(out, p["wo"]), cache_k, cache_v


def attention_cross(cfg: ModelConfig, p, x, mem_k, mem_v,
                    sc: Constrainer = no_sc, q_chunk: int = 512):
    """Cross-attention against precomputed memory K/V (B, Sm, KV, hd).
    No RoPE on cross-attention (memory has its own positions)."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = sc(q, ("batch", None, "heads", None))
    out = _sdpa(cfg, q, mem_k.to(x.dtype), mem_v.to(x.dtype), _everything,
                0, sc, q_chunk)
    return _out_proj(out, p["wo"])


def cross_kv(cfg: ModelConfig, p, memory, sc: Constrainer = no_sc):
    """Precompute cross-attention K/V from memory (B, Sm, D_mem)."""
    k = _proj(memory, p["wk"])
    v = _proj(memory, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
    return (sc(k, ("batch", None, "kv_heads", None)),
            sc(v, ("batch", None, "kv_heads", None)))


# ---------------------------------------------------------------- MLP
def mlp_specs(d: int, ff: int):
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, ff), ("embed", "mlp")),
        "w_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def mlp(p, x, sc: Constrainer = no_sc):
    h = (F.silu(x @ p["w_gate"].to(x.dtype))
         * (x @ p["w_up"].to(x.dtype)))
    h = sc(h, ("batch", None, "mlp"))
    return h @ p["w_down"].to(x.dtype)

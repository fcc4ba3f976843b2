"""Unified model configuration covering every assigned architecture family.

The reference's `ModelConfig`, field for field; `compute_dtype` is a
`torch.dtype`."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | vlm | ssm | encdec
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int                # raw; access padded_vocab for tables
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # layer l is MoE iff l % moe_every == moe_every-1
    moe_d_ff: Optional[int] = None # expert hidden dim (defaults to d_ff)
    n_shared_experts: int = 0
    # --- Mamba / hybrid ---
    attn_every: int = 0            # hybrid: l % attn_every == 0 is attention
    ssm_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    # --- VLM ---
    cross_attn_every: int = 0      # l % cross_attn_every == cross_attn_every-1
    n_patches: int = 0             # stub frontend: precomputed patch embeddings
    frontend_dim: Optional[int] = None
    # --- enc-dec ---
    enc_layers: int = 0
    # --- numerics / schedule ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    # full-attention archs skip long_500k (see DESIGN.md S6)
    subquadratic: bool = False
    # WSD schedule flag (minicpm)
    wsd_schedule: bool = False

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind: 'attn' | 'mamba' | 'cross'."""
        kinds = []
        for li in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("mamba")
            elif self.family == "hybrid":
                kinds.append("attn" if (self.attn_every and li % self.attn_every == 0)
                             else "mamba")
            elif (self.family == "vlm" and self.cross_attn_every
                  and li % self.cross_attn_every == self.cross_attn_every - 1):
                kinds.append("cross")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def layer_is_moe(self) -> Tuple[bool, ...]:
        return tuple(
            self.n_experts > 0 and (li % self.moe_every == self.moe_every - 1)
            for li in range(self.num_layers))

    def period(self) -> int:
        """Smallest repeating pattern of (kind, is_moe) — the scan body
        processes one period so heterogeneous stacks still scan."""
        kinds, moes = self.layer_kinds(), self.layer_is_moe()
        n = self.num_layers
        for p in range(1, n + 1):
            if n % p:
                continue
            if all(kinds[i] == kinds[i % p] and moes[i] == moes[i % p]
                   for i in range(n)):
                return p
        return n

    def active_params_per_token_factor(self) -> float:
        """Fraction of FFN params active per token (MoE top-k / E)."""
        if self.n_experts == 0:
            return 1.0
        return ((self.top_k + self.n_shared_experts)
                / (self.n_experts + self.n_shared_experts))

"""Jamba-1.5-Large [arXiv:2403.19887]: 72L d_model=8192 64H GQA(kv=8)
d_ff=24576 vocab=65536; Mamba:attention 7:1 interleave (1 attn per 8
layers), MoE 16 experts top-2 every other layer.  Hybrid -> runs
long_500k (attention layers decode 1 token against the KV cache —
linear — and Mamba layers are O(1)/token)."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, rope_theta=1_000_000.0,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, ssm_state=16, d_conv=4, mamba_expand=2,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    n_experts=4, top_k=2, moe_every=2,
    attn_every=8, ssm_state=8, d_conv=4, mamba_expand=2,
    subquadratic=True,
)

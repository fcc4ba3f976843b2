"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E, unverified]:
48L d_model=5120 40H GQA(kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 with a shared expert, every layer."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, rope_theta=500_000.0,
    n_experts=16, top_k=1, moe_every=1, n_shared_experts=1,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    n_experts=4, top_k=1, moe_every=1, n_shared_experts=1,
)

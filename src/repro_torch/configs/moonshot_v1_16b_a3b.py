"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H GQA(kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts top-6
(+ shared expert), dense FFN uses 4*1408."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, rope_theta=50_000.0,
    n_experts=64, top_k=6, moe_every=1, n_shared_experts=2,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, moe_d_ff=32, vocab_size=256,
    n_experts=8, top_k=2, moe_every=1, n_shared_experts=1,
)

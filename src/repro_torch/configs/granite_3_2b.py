"""Granite-3.0-2B-base [hf:ibm-granite/granite-3.0-2b-base]: 40L
d_model=2048 32H GQA(kv=8) d_ff=8192 vocab=49155."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155, rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
)

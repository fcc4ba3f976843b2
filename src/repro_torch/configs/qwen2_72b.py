"""Qwen2-72B [arXiv:2407.10671]: 80L d_model=8192 64H GQA(kv=8)
d_ff=29568 vocab=152064, QKV bias."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, qkv_bias=True,
)

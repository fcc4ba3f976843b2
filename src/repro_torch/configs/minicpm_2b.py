"""MiniCPM-2B [arXiv:2404.06395]: 40L d_model=2304 36H GQA(kv=36)
d_ff=5760 vocab=122753.  Llama-like arch; trained with the WSD schedule
(warmup-stable-decay), which training/schedule.py implements."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, rope_theta=10_000.0,
    tie_embeddings=True, wsd_schedule=True,
)

SMOKE = ModelConfig(
    name="minicpm-smoke", family="dense",
    num_layers=2, d_model=48, n_heads=6, n_kv_heads=6,
    d_ff=96, vocab_size=256, wsd_schedule=True,
)

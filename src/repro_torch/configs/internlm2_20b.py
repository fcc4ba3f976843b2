"""InternLM2-20B [arXiv:2403.17297]: 48L d_model=6144 48H GQA(kv=8)
d_ff=16384 vocab=92544."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
)

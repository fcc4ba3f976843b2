"""Falcon-Mamba-7B [arXiv:2410.05355]: 64L d_model=4096, attention-free
Mamba-1, ssm_state=16, vocab=65024.  Pure-SSM -> runs long_500k."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, d_conv=4, mamba_expand=2,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="falcon-smoke", family="ssm",
    num_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=8, d_conv=4, mamba_expand=2,
    subquadratic=True,
)

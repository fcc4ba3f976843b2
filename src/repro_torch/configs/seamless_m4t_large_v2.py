"""SeamlessM4T-Large-v2 [arXiv:2308.11596]: enc-dec, 24L each side,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  The speech/text
modality frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (B, S_frames, d_model) for the encoder."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
)

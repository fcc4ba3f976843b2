"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision, unverified]:
40L d_model=4096 32H GQA(kv=8) d_ff=14336 vocab=128256; every 5th layer is
a cross-attention layer over image patch embeddings.  The vision frontend
is a STUB per the brief: input_specs() provides precomputed patch
embeddings (B, n_patches, d_model)."""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
    cross_attn_every=5, n_patches=1601,
)

SMOKE = ModelConfig(
    name="llama32v-smoke", family="vlm",
    num_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    cross_attn_every=5, n_patches=16,
)

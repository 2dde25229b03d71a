"""qwen3-32b — dense LM with qk_norm + GQA (hf:Qwen/Qwen3-32B family),
copied from the JAX package's ``repro/configs/qwen3_32b.py``.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = TransformerConfig(
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=False,
    attn_block_q=32,
    attn_block_kv=32,
)

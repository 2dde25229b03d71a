"""gemma2-9b — local+global alternating attention, logit softcaps
(arXiv:2408.00118), copied from the JAX package's
``repro/configs/gemma2_9b.py``.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern="local_global",
    sandwich_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="gemma2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=64,
    layer_pattern="local_global",
    sandwich_norm=True,
    attn_block_q=32,
    attn_block_kv=32,
)

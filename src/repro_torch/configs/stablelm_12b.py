"""stablelm-12b — dense GQA LM (hf:stabilityai/stablelm-2-12b family),
copied from the JAX package's ``repro/configs/stablelm_12b.py``.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
StableLM-2 uses partial rotary embeddings (rotary_pct=0.25).
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rotary_pct=0.25,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = TransformerConfig(
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    rotary_pct=0.25,
    tie_embeddings=False,
    attn_block_q=32,
    attn_block_kv=32,
)

"""moonshot-v1-16b-a3b — Moonlight-style MoE LM
(hf:moonshotai/Moonlight-16B-A3B), copied from the JAX package's
``repro/configs/moonshot_v1_16b_a3b.py``.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=0,
    rope_theta=50_000.0,
    tie_embeddings=True,
    moe_impl="shard_map",  # optimized EP dispatch; baseline="pjit" (§Perf)
)

SMOKE = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    moe=True,
    n_experts=8,
    top_k=2,
    d_ff_expert=96,
    attn_block_q=32,
    attn_block_kv=32,
)

"""llama4-scout-17b-a16e — MoE with early fusion
(hf:meta-llama/Llama-4-Scout-17B-16E), copied from the JAX package's
``repro/configs/llama4_scout_17b_a16e.py``.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
Early fusion: the vision frontend is a STUB — the caller passes
precomputed patch embeddings (``prefill(patches=)``), which are linearly
projected and take the first ``fused_patches`` positions.
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=True,
    n_experts=16,
    top_k=1,
    d_ff_expert=8192,
    n_shared_experts=1,  # Llama-4 routed top-1 + always-on shared expert
    rope_theta=500_000.0,
    tie_embeddings=False,
    fused_patches=144,  # early-fusion stub: 144 patch embeddings per sample
    patch_dim=1408,
    moe_impl="shard_map",  # optimized EP dispatch; baseline="pjit" (§Perf)
)

SMOKE = TransformerConfig(
    name="llama4-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    moe=True,
    n_experts=4,
    top_k=1,
    d_ff_expert=128,
    n_shared_experts=1,
    tie_embeddings=False,
    fused_patches=4,
    patch_dim=32,
    attn_block_q=32,
    attn_block_kv=32,
)

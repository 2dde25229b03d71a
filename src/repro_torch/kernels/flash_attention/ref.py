"""Plain PyTorch version of the flash-attention kernel's function: the
scores materialized in f32, as the JAX package's ``kernels/flash_attention/
ref.py`` computes them, with ``kernel.py::_fa_kernel``'s arithmetic
(``scale`` multiplied in, then ``softcap * tanh(s / softcap)``).

The CPU path of ``ops.flash_attention``, and what ``chip_smoke.py`` holds
the CUDA kernel against on the card. It keeps B * H * Sq * Skv f32 scores
in memory: a reference, not a serving path.
"""
from __future__ import annotations

import math

import torch

NEG = -0.7 * torch.finfo(torch.float32).max


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H = KVH * G (query
    head h reads kv head h // G) -> (B, Sq, H, D) in q's dtype.

    Attend iff k <= q (``causal``) and q - k < ``window`` (``window > 0``).
    Masked weights are exactly 0; a row with nothing to attend is 0."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KVH, G, D).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= q_pos - k_pos < window
    s = torch.where(ok, s, NEG)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)

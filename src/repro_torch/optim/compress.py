"""int8 gradient compression with error feedback, the JAX package's
``repro/optim/compress.py`` in PyTorch.

Per-tensor symmetric int8 quantization; the quantization residual is kept
locally and added to the next step's gradient (error feedback, Seide et
al. / Karimireddy et al.), which restores convergence to uncompressed
rates. The JAX package meant it for a cross-pod gradient reduction; the
port has no such reduction yet (``ROADMAP.md``: the LM's device mesh).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def quantize_int8(x: torch.Tensor):
    scale = torch.max(torch.abs(x)) / torch.tensor(
        127.0, dtype=x.dtype, device=x.device) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def init_error_state(params):
    return T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)


def compress_grads(grads, error_state):
    """Returns (a tree of (q, scale) pairs, the new error state)."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        return (q, scale), g32 - dequantize_int8(q, scale)
    out = [one(g, e) for g, e in zip(T.leaves(grads),
                                     T.leaves(error_state))]
    return (T.unflatten(grads, [o[0] for o in out]),
            T.unflatten(grads, [o[1] for o in out]))


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 \
        and all(isinstance(t, torch.Tensor) for t in x)


def decompress_grads(comp):
    if _is_pair(comp):
        return dequantize_int8(*comp)
    if isinstance(comp, dict):
        return {k: decompress_grads(v) for k, v in comp.items()}
    return type(comp)(decompress_grads(v) for v in comp)


def compressed_bytes(comp) -> int:
    return sum(x.numel() * x.element_size() for x in T.leaves(comp))

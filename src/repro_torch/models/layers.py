"""Shared layers of the LM, plain PyTorch (the serving subset of the JAX
package's ``repro/models/layers.py``).

Params are plain nested dicts of tensors; every init function takes an
explicit ``torch.Generator``. Compute follows the JAX package's
mixed-precision convention: params in ``param_dtype`` (fp32), matmuls in
``compute_dtype`` (bf16), softmax and norm statistics in fp32. Where the
JAX package asks a bf16 product for an f32 result
(``preferred_element_type``), the port upcasts the bf16 operands to f32
first: the products of bf16 values are exact in f32, so it is the same
sum.

Prefill attention is the flash-attention kernel
(``kernels/flash_attention``); ``blockwise_attention``, the training loss
and the recsys MLPs are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_NEG = -0.7 * torch.finfo(torch.float32).max


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, stddev=None,
                stack: int = 0):
    """N(0, stddev) in f32, cast to ``dtype``; ``stddev`` defaults to
    1/sqrt(fan_in) of ``shape`` (the JAX rule: for a 3-D ``(E, d, ff)``
    expert leaf, fan_in = E * d). ``stack > 0`` draws ``stack`` such
    tensors, one at a time into a preallocated ``(stack, *shape)``
    tensor of ``dtype`` (one per layer), so no f32 copy of the whole
    stack exists at once."""
    if stddev is None:  # fan-in scaling
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
        stddev = 1.0 / math.sqrt(max(fan_in, 1))

    def draw():
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return x.mul_(stddev).to(dtype)
    if not stack:
        return draw()
    out = torch.empty((stack, *shape), dtype=dtype, device=gen.device)
    for i in range(stack):
        out[i] = draw()
    return out


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm_init(d, dtype, device=None, stack: int = 0):
    """Gemma convention: weight = 1 + scale, scale initialized at 0."""
    shape = (stack, d) if stack else (d,)
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    out = normed * (1.0 + params["scale"].to(torch.float32))
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (partial rotary supported, StableLM-2 style)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     device=None):
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), exponent)
    return inv_freq, rot_dim


def apply_rope(x, positions, inv_freq, rot_dim):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Pairs are
    interleaved (``x[..., ::2]``, ``x[..., 1::2]``); the last D - rot_dim
    features pass through."""
    if rot_dim == 0:
        return x
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    xf1 = x_rot[..., ::2].to(torch.float32)
    xf2 = x_rot[..., 1::2].to(torch.float32)
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    if rot_dim < x.shape[-1]:
        return torch.cat([rotated, x_pass], dim=-1)
    return rotated


# --------------------------------------------------------------------------
# decode attention (one new position against the KV cache)
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, length, *, window=0, softcap=0.0):
    """q: (B, H, D); k_cache/v_cache: (B, S, KVH, D); length: (B,) number
    of valid cache positions (the new token's slot already written).
    Position ``pos`` is attended iff pos < length and, with window > 0,
    pos >= length - window (the band the kernel codes as q - k < window).
    """
    B, S, KVH, D = k_cache.shape
    H = q.shape[1]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KVH, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=k_cache.device)
    lens = torch.as_tensor(length, device=k_cache.device)
    lens = lens[..., None] if lens.ndim else lens
    ok = pos < lens  # (B, S)
    if window > 0:
        ok = ok & (pos >= lens - window)
    ok = torch.broadcast_to(ok, (B, S))[:, None, None, :]
    m = torch.where(ok, s, _NEG).amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def swiglu_init(gen, d, ff, dtype, stack: int = 0):
    return {
        "w_gate": normal_init(gen, (d, ff), dtype, stack=stack),
        "w_up": normal_init(gen, (d, ff), dtype, stack=stack),
        "w_down": normal_init(gen, (ff, d), dtype, stack=stack),
    }


def swiglu(params, x, compute_dtype):
    """silu in f32, cast to the compute dtype, times the up projection."""
    xc = x.to(compute_dtype)
    g = xc @ params["w_gate"].to(compute_dtype)
    u = xc @ params["w_up"].to(compute_dtype)
    h = F.silu(g.to(torch.float32)).to(compute_dtype) * u
    return h @ params["w_down"].to(compute_dtype)

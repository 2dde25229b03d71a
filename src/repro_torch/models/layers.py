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
(``kernels/flash_attention``). Training attends through
``blockwise_attention`` and ends in ``chunked_softmax_xent``: plain,
differentiable PyTorch, as the JAX package computes both outside any
Pallas kernel (its flash kernel is forward-only). The recsys MLPs are not
ported yet (ROADMAP.md).
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
# blockwise (flash-style) attention, plain PyTorch: the training step's
# attention (the JAX package's ``blockwise_attention`` and the
# traced-window variant its training step uses, which is the same
# function here: the port's window is a Python int)
# --------------------------------------------------------------------------

def _block_mask(q_pos, k_pos, *, causal, window):
    """(block_q, block_kv) boolean, True = attend."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window:
        ok &= dq - dk < window
    return ok


def _block_live(q_lo: int, q_hi: int, k_lo: int, k_hi: int, *, causal,
                window) -> bool:
    """Whether any (q, k) with q in [q_lo, q_hi], k in [k_lo, k_hi] is
    attended: a block with none adds exactly nothing (its probabilities
    are 0, its correction exp(0) = 1), so it is skipped."""
    lo, hi = q_lo - k_hi, q_hi - k_lo  # the range of q - k
    if causal:
        lo = max(lo, 0)
    if window:
        hi = min(hi, window - 1)
    return lo <= hi


def blockwise_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, block_q=512, block_kv=1024):
    """Online-softmax attention over (block_q, block_kv) tiles.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H = G * KVH. Scores and
    the running max, sum and output are f32 (bf16 operands are upcast:
    their products are exact in f32, the JAX package's
    ``preferred_element_type``); the probabilities are cast to v's dtype
    before p.v, as there. Ragged tails are padded and masked. Masked
    positions contribute exactly zero probability. Returns (B, Sq, H, D)
    in q's dtype.

    Differentiable as it stands, with two departures from the JAX
    graph that leave the values unchanged: the running max only shifts
    the exponent, so it is taken out of the graph (its gradient terms
    cancel, and its block need not be kept for the backward); and masked
    scores enter the exponential as -inf, where the JAX function takes
    exp of every score and zeroes the masked ones after it. There a row
    whose first tile holds no attended key (a window shorter than the
    sequence) overflows exp to inf under a zero cotangent, and its
    gradient is NaN; here it is finite.
    """
    B, Sq, H, D = q.shape
    _, Skv0, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv0)
    Sq_pad = -(-Sq // block_q) * block_q
    Skv = -(-Skv0 // block_kv) * block_kv
    if Sq_pad != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq_pad - Sq))
    if Skv != Skv0:
        k = F.pad(k, (0, 0, 0, 0, 0, Skv - Skv0))
        v = F.pad(v, (0, 0, 0, 0, 0, Skv - Skv0))
    nq, nk = Sq_pad // block_q, Skv // block_kv
    dev = q.device
    outs = []
    for qi in range(nq):
        q_lo = q_offset + qi * block_q
        q_blk = q[:, qi * block_q:(qi + 1) * block_q].reshape(
            B, block_q, KVH, G, D).to(torch.float32)
        q_pos = q_lo + torch.arange(block_q, device=dev)
        m = torch.full((B, KVH, G, block_q), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KVH, G, block_q), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, KVH, G, block_q, D), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            k_lo = kj * block_kv
            if not _block_live(q_lo, q_lo + block_q - 1, k_lo,
                               min(k_lo + block_kv, Skv0) - 1,
                               causal=causal, window=window):
                continue
            k_blk = k[:, k_lo:k_lo + block_kv].to(torch.float32)
            v_blk = v[:, k_lo:k_lo + block_kv]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            k_pos = k_lo + torch.arange(block_kv, device=dev)
            ok = _block_mask(q_pos, k_pos, causal=causal, window=window)
            ok &= (k_pos < Skv0)[None, :]  # ragged kv tail
            okb = ok[None, None, None]
            with torch.no_grad():
                m_new = torch.maximum(m, torch.where(okb, s, _NEG).amax(-1))
            p = torch.exp(torch.where(okb, s - m_new[..., None],
                                      -math.inf))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd",
                              p.to(v.dtype).to(torch.float32),
                              v_blk.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.movedim(3, 1).reshape(B, block_q, H, D)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


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


# --------------------------------------------------------------------------
# the training loss
# --------------------------------------------------------------------------

def chunked_softmax_xent(x, emb, targets, mask, *, chunk=512, softcap=0.0):
    """LM head + cross-entropy, chunked over the sequence to bound the
    (B, chunk, V) f32 logits. x: (B, S, d); emb: (V, d), the head (tied or
    untied), cast once to x's dtype; targets/mask: (B, S). Logits are f32
    sums of the products of x and the cast head, softcapped where
    ``softcap``. Returns (total_loss, total_weight), f32 scalars."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    head = emb.to(x.dtype).to(torch.float32)
    targets = targets.to(torch.int64)
    mask = mask.to(torch.float32)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    weight = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = x[:, sl].to(torch.float32) @ head.T
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, sl, None])[..., 0]
        nll = (lse - gold) * mask[:, sl]
        loss = loss + nll.sum()
        weight = weight + mask[:, sl].sum()
    return loss, weight

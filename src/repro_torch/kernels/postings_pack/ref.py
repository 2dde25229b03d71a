"""Plain PyTorch version of lane-blocked PFor packing (the CPU path and the
oracle ``chip_smoke.py`` holds the CUDA kernel against).

Format (the JAX package's ``kernels/postings_pack/ref.py``):
  * the delta stream is grouped into blocks of 128 lanes;
  * each block is packed at one bit width bw = bits(max(block));
  * packed layout per block: 32 bit-planes x 4 words of 32 lanes each —
    plane j, word w holds bit j of lanes [32w, 32w+32) (bit t of the word
    is lane 32w+t); planes >= bw are zero.

Words are uint32 bit patterns stored in ``torch.int32`` tensors (the same
bits; the CUDA kernel reads them as ``uint32_t``). PyTorch's CPU build has
no shift, sum, max or comparison on ``uint32``, so this version computes
in ``int64`` and converts back at the end.
"""
from __future__ import annotations

import torch

BLOCK = 128
WORDS_PER_PLANE = BLOCK // 32  # 4
_CHUNK = 2048  # blocks per step: bounds the (chunk, 32, 128) int64 temporaries
_MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _MASK32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the low 32 bits)."""
    x = x & _MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def bit_width(block_max: torch.Tensor) -> torch.Tensor:
    """ceil(log2(max+1)) = 32 - clz(max), with bw(0) = 0 (store nothing
    for an all-zero block)."""
    m = as_u32(block_max)
    pow2 = torch.ones(32, dtype=torch.int64, device=m.device) << torch.arange(
        32, device=m.device)
    return (m[..., None] >= pow2).sum(-1).to(torch.int32)


def pack_ref(deltas: torch.Tensor):
    """deltas: (nb, 128) -> (packed (nb, 32, 4) int32 words, bw (nb,) int32).
    Planes >= bw are zero, so the compacted stream is
    ``packed[b, :bw[b], :]``."""
    assert deltas.shape[-1] == BLOCK, deltas.shape
    d_all = as_u32(deltas)
    nb = d_all.shape[0]
    dev = d_all.device
    planes = torch.arange(32, device=dev)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << planes
    packed = torch.empty((nb, 32, WORDS_PER_PLANE), dtype=torch.int32,
                         device=dev)
    bw = bit_width(d_all.max(dim=-1).values if nb else d_all[:, 0])
    for s in range(0, nb, _CHUNK):
        d = d_all[s:s + _CHUNK]
        bits = (d[:, None, :] >> planes[None, :, None]) & 1  # (c, 32, 128)
        lanes = bits.reshape(d.shape[0], 32, WORDS_PER_PLANE, 32)
        words = (lanes * weights).sum(dim=-1)                # (c, 32, 4)
        mask = planes[None, :, None] < bw[s:s + _CHUNK, None, None]
        packed[s:s + _CHUNK] = wrap_i32(torch.where(mask, words, 0))
    return packed, bw


def unpack_ref(packed: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """(nb, 32, 4) words + (nb,) bit widths -> (nb, 128) int32 bit
    patterns of the uint32 lanes."""
    nb = packed.shape[0]
    dev = packed.device
    lane = torch.arange(BLOCK, device=dev)
    word_idx, bit_idx = lane // 32, lane % 32
    planes = torch.arange(32, device=dev)
    out = torch.empty((nb, BLOCK), dtype=torch.int32, device=dev)
    for s in range(0, nb, _CHUNK):
        w = as_u32(packed[s:s + _CHUNK])[:, :, word_idx]     # (c, 32, 128)
        bits = (w >> bit_idx[None, None, :]) & 1
        valid = planes[None, :, None] < bw[s:s + _CHUNK, None, None]
        vals = torch.where(valid, bits, 0) << planes[None, :, None]
        out[s:s + _CHUNK] = wrap_i32(vals.sum(dim=1))
    return out


def compact_planes(packed: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Keep only the ``bw[b]`` live planes of each block: (nb, 32, 4) +
    (nb,) -> (sum(bw), 4) rows, block-major then plane-major — the byte
    stream a storage codec writes at flush."""
    mask = torch.arange(32, device=packed.device)[None, :] < bw[:, None]
    return packed[mask]


def expand_planes(rows: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Inverse of ``compact_planes``: scatter the (sum(bw), 4) rows back
    into the fixed-stride (nb, 32, 4) buffer; dead planes are zero."""
    rows = rows.reshape(-1, WORDS_PER_PLANE)
    mask = torch.arange(32, device=bw.device)[None, :] < bw[:, None]
    if rows.shape[0] != int(mask.sum()):
        raise ValueError(f"compacted stream holds {rows.shape[0]} plane rows"
                         f", bit widths require {int(mask.sum())}")
    full = torch.zeros((bw.shape[0], 32, WORDS_PER_PLANE), dtype=rows.dtype,
                       device=rows.device)
    full[mask] = rows
    return full


def packed_bytes(bw: torch.Tensor) -> float:
    """Compacted size in bytes: bw planes x 4 words x 4 bytes + a 1-byte
    bit-width header per block."""
    return float((bw.to(torch.float64) * 16 + 1).sum())

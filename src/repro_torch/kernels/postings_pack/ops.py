"""Public ops for postings packing: on CUDA tensors they launch the
hand-written kernels of ``csrc/postings_pack.cu``; on CPU tensors they run
the plain PyTorch version in ``ref.py``. Nothing falls back: a CUDA tensor
gets the kernel or an exception.

Words are uint32 bit patterns held in ``torch.int32`` tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.postings_pack import ref

BLOCK = ref.BLOCK
WORDS_PER_PLANE = ref.WORDS_PER_PLANE
bit_width = ref.bit_width
packed_bytes = ref.packed_bytes
compact_planes = ref.compact_planes
expand_planes = ref.expand_planes


def pad_to_blocks(stream: torch.Tensor, fill: int = 0):
    """(n,) -> ((nb, 128), n), padding the tail with ``fill``."""
    n = stream.shape[0]
    nb = -(-n // BLOCK)
    padded = torch.full((nb * BLOCK,), fill, dtype=stream.dtype,
                        device=stream.device)
    padded[:n] = stream
    return padded.reshape(nb, BLOCK), n


def pack(deltas: torch.Tensor):
    """deltas (nb, 128) -> (packed (nb, 32, 4) int32 words, bw (nb,) int32).
    On CUDA the deltas must be int32 holding the uint32 bit patterns."""
    if not deltas.is_cuda:
        return ref.pack_ref(deltas)
    nb = deltas.shape[0]
    _build.check_tensor(deltas, torch.int32, (nb, BLOCK), "deltas")
    packed = torch.empty((nb, 32, ref.WORDS_PER_PLANE), dtype=torch.int32,
                         device=deltas.device)
    bw = torch.empty((nb,), dtype=torch.int32, device=deltas.device)
    rc = _build.lib("postings_pack").pp_pack(
        deltas.data_ptr(), packed.data_ptr(), bw.data_ptr(), nb,
        _build.stream_ptr(deltas))
    _build.check(rc, "pack")
    _build.count_launch("pack")
    return packed, bw


def unpack(packed: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """(nb, 32, 4) words + (nb,) bit widths -> (nb, 128) int32 bit
    patterns. On CUDA ``packed`` must be 16-byte aligned."""
    if not packed.is_cuda:
        return ref.unpack_ref(packed, bw)
    nb = packed.shape[0]
    _build.check_tensor(packed, torch.int32, (nb, 32, ref.WORDS_PER_PLANE),
                        "packed")
    _build.check_aligned(packed, "packed")
    _build.check_tensor(bw, torch.int32, (nb,), "bw")
    out = torch.empty((nb, BLOCK), dtype=torch.int32, device=packed.device)
    rc = _build.lib("postings_pack").pp_unpack(
        packed.data_ptr(), bw.data_ptr(), out.data_ptr(), nb,
        _build.stream_ptr(packed))
    _build.check(rc, "unpack")
    _build.count_launch("unpack")
    return out

"""Public op: fused attention. On CUDA tensors it launches the
hand-written kernel of ``csrc/flash_attention.cu``; on CPU tensors it
runs the plain version in ``ref.py``. Nothing falls back: a CUDA tensor
gets the kernel or an exception.

The LM's prefill attention (``models/transformer.py::_attention``) calls
it once per layer with that layer's window and the config's softcap.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype. f32 or bf16 inputs (all three alike); on CUDA, D a multiple of 8
    up to 256 and every tensor contiguous."""
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q is {q.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    if D % 8 or D > MAX_HEAD_DIM or H % KVH or B * H > 65535:
        raise ValueError(f"flash_attention: unsupported shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (D a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, H a multiple"
                         f" of KVH, B * H <= 65535)")
    _build.check_tensor(q, q.dtype, (B, Sq, H, D), "q")
    _build.check_tensor(k, q.dtype, (B, Skv, KVH, D), "k")
    _build.check_tensor(v, q.dtype, (B, Skv, KVH, D), "v")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v on different devices")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _build.lib("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
        Skv, H, KVH, D, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D), _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out

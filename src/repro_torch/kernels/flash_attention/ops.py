"""Public op: fused attention. On CUDA tensors it launches one of two
hand-written kernels, chosen by ``route`` from the dtype and the head dim
alone: the tensor-core kernel of ``csrc/flash_attention_tc.cu`` (bf16,
wgmma + TMA) or the SIMT kernel of ``csrc/flash_attention.cu`` (f32, and
bf16 at the head dims the tensor-core kernel does not take). On CPU
tensors it runs the plain version in ``ref.py``. Nothing falls back: a
CUDA tensor gets the kernel of its route or an exception.

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
# route -> (source in csrc/, C entry point); the route is also the
# kernel's name in ``_build.LAUNCHES``
ROUTES = {"flash_attention_tc": ("flash_attention_tc",
                                 "flash_attention_tc_fwd"),
          "flash_attention": ("flash_attention", "flash_attention_fwd")}


def route(dtype, D: int) -> str:
    """The kernel a CUDA call takes: ``"flash_attention_tc"`` (tensor
    cores) for bf16 with D a multiple of 16 from 64 to 256, else
    ``"flash_attention"`` (SIMT; f32 everywhere, since the f32 checks ask
    2e-5, which bf16 products cannot meet)."""
    if dtype == torch.bfloat16 and D % 16 == 0 and 64 <= D <= MAX_HEAD_DIM:
        return "flash_attention_tc"
    return "flash_attention"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype. f32 or bf16 inputs (all three alike); on CUDA, D a multiple of 8
    up to 256 and every tensor contiguous."""
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    return launch(route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                  window=window, softcap=softcap)


def launch(kernel: str, q, k, v, *, causal: bool = True, window: int = 0,
           softcap: float = 0.0):
    """Launch the kernel ``kernel`` (a key of ``ROUTES``) on CUDA tensors
    and count it. ``flash_attention`` calls it with ``route``'s choice;
    ``chip_smoke.py`` also times the SIMT kernel on the tensor-core
    route's inputs through it."""
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
    tc = kernel == "flash_attention_tc"
    if tc and route(q.dtype, D) != kernel:
        raise ValueError(f"flash_attention_tc takes bf16 with D a multiple "
                         f"of 16 in [64, {MAX_HEAD_DIM}], got {q.dtype} "
                         f"D={D}")
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
    source, entry = ROUTES[kernel]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if not tc:
        # the SIMT kernel's persistent CTAs pull work items from this
        # counter
        counter = torch.zeros(1, dtype=torch.int32, device=q.device)
        args.append(counter.data_ptr())
    args += [B, Sq, Skv, H, KVH, D, int(causal), int(window),
             float(softcap), 1.0 / math.sqrt(D)]
    if not tc:
        args.append(_DTYPES[q.dtype])
    rc = getattr(_build.lib(source), entry)(*args, _build.stream_ptr(q))
    _build.check(rc, kernel)
    _build.count_launch(kernel)
    return out

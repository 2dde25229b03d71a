"""PyTorch/CUDA port of the ``repro`` inverted-indexing system.

Mirrors the layout of the JAX package (``repro_torch/core/query.py`` is
the counterpart of ``repro/core/query.py``) and imports nothing of it.
Entry points run on CUDA unless the caller passes ``device="cpu"``; on
CUDA tensors every kernel op launches its hand-written sm_90a kernel, on
CPU tensors it runs the plain PyTorch version beside it.
"""

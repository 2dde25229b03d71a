"""Dispatch for the fused BM25 block scoring ops.

``bm25_blocks`` receives the block array the evaluation selected — the
full candidate grid on the dense exhaustive path, or the compacted,
bucket-padded survivor array on the pruned path (``core/query.py``) — and
returns per-lane (docids, tf, num). ``bm25_blocks_midgrid`` adds the
in-grid theta tightening. ``bm25_blocks_compact`` reads the selected
blocks' planes from the compact layout's rows (fused decompress-and-score).
On CUDA tensors each op launches its kernel in
``csrc/bm25_blockmax.cu``; on CPU tensors it runs ``ref.py``. There is no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bm25_blockmax import ref

BLOCK = ref.BLOCK


def _check_blocks(packed_docs, bw_docs, first_doc, packed_tf, bw_tf, idf,
                  active) -> int:
    S = packed_docs.shape[0]
    _build.check_tensor(packed_docs, torch.int32, (S, 32, 4), "packed_docs")
    _build.check_tensor(packed_tf, torch.int32, (S, 32, 4), "packed_tf")
    for t, name in ((bw_docs, "bw_docs"), (bw_tf, "bw_tf"),
                    (first_doc, "first_doc"), (active, "active")):
        _build.check_tensor(t, torch.int32, (S,), name)
    _build.check_tensor(idf, torch.float32, (S,), "idf")
    return S


def _f32(x: float) -> float:
    """Round a Python float to f32 once, as JAX does for a weakly typed
    scalar in f32 arithmetic (ctypes.c_float would round it the same)."""
    return float(torch.tensor(x, dtype=torch.float32))


def bm25_blocks(packed_docs, bw_docs, first_doc, packed_tf, bw_tf, idf,
                active, *, k1: float = 0.9, b: float = 0.4,
                partials: bool = False):
    """-> (docids (S,128) int32, tf (S,128) f32, num (S,128) f32), plus the
    (1, 128) per-lane max of num / (tf + k1(1-b)) with ``partials``. On
    CUDA the packed planes must be 16-byte aligned."""
    if not packed_docs.is_cuda:
        if partials:
            return ref.bm25_blocks_partials_ref(
                packed_docs, bw_docs, first_doc, packed_tf, bw_tf, idf,
                active, k1, b)
        return ref.bm25_blocks_ref(packed_docs, bw_docs, first_doc,
                                   packed_tf, bw_tf, idf, active, k1)
    S = _check_blocks(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                      idf, active)
    _build.check_aligned(packed_docs, "packed_docs")
    _build.check_aligned(packed_tf, "packed_tf")
    dev = packed_docs.device
    doc = torch.empty((S, BLOCK), dtype=torch.int32, device=dev)
    tf = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    num = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    part = None
    if partials:   # the entry point zeroes it before the kernel folds in
        part = torch.empty((1, BLOCK), dtype=torch.float32, device=dev)
    rc = _build.lib("bm25_blockmax").bm25_blocks(
        packed_docs.data_ptr(), bw_docs.data_ptr(), first_doc.data_ptr(),
        packed_tf.data_ptr(), bw_tf.data_ptr(), idf.data_ptr(),
        active.data_ptr(), _f32(k1 + 1.0), _f32(k1 * (1.0 - b)),
        doc.data_ptr(), tf.data_ptr(), num.data_ptr(),
        None if part is None else part.data_ptr(), S,
        _build.stream_ptr(packed_docs))
    _build.check(rc, "bm25_blocks")
    _build.LAUNCHES["bm25_blocks"] += 1
    return (doc, tf, num, part) if partials else (doc, tf, num)


def bm25_blocks_compact(cplanes_docs, coff_docs, bw_docs, first_doc,
                        cplanes_tf, coff_tf, bw_tf, idf, active, *,
                        k1: float = 0.9):
    """-> (docids, tf, num) each (S, 128) for the S selected blocks, whose
    planes are read from the compact rows ``cplanes_*`` (P, 4) at row
    offsets ``coff_*`` (S,) — equal to ``bm25_blocks`` over the expanded
    planes. On CUDA the rows must be 16-byte aligned."""
    if not cplanes_docs.is_cuda:
        return ref.bm25_blocks_compact_ref(
            cplanes_docs, coff_docs, bw_docs, first_doc, cplanes_tf, coff_tf,
            bw_tf, idf, active, k1)
    S = coff_docs.shape[0]
    for t, name in ((cplanes_docs, "cplanes_docs"), (cplanes_tf,
                                                     "cplanes_tf")):
        _build.check_tensor(t, torch.int32, (t.shape[0], 4), name)
        _build.check_aligned(t, name)
    for t, name in ((coff_docs, "coff_docs"), (bw_docs, "bw_docs"),
                    (first_doc, "first_doc"), (coff_tf, "coff_tf"),
                    (bw_tf, "bw_tf"), (active, "active")):
        _build.check_tensor(t, torch.int32, (S,), name)
    _build.check_tensor(idf, torch.float32, (S,), "idf")
    dev = cplanes_docs.device
    doc = torch.empty((S, BLOCK), dtype=torch.int32, device=dev)
    tf = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    num = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    rc = _build.lib("bm25_blockmax").bm25_compact(
        cplanes_docs.data_ptr(), cplanes_docs.shape[0], coff_docs.data_ptr(),
        bw_docs.data_ptr(), first_doc.data_ptr(), cplanes_tf.data_ptr(),
        cplanes_tf.shape[0], coff_tf.data_ptr(), bw_tf.data_ptr(),
        idf.data_ptr(), active.data_ptr(), _f32(k1 + 1.0), doc.data_ptr(),
        tf.data_ptr(), num.data_ptr(), S, _build.stream_ptr(cplanes_docs))
    _build.check(rc, "bm25_blocks_compact")
    _build.LAUNCHES["bm25_blocks_compact"] += 1
    return doc, tf, num


def bm25_blocks_partials(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                         idf, active, *, k1: float = 0.9, b: float = 0.4):
    """``bm25_blocks`` with the running per-lane top-partial bound."""
    return bm25_blocks(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                       idf, active, k1=k1, b=b, partials=True)


def bm25_blocks_midgrid(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                        idf, active, rows, ubf, theta_lanes, norm_max, *,
                        k: int, k1: float = 0.9, block_rows: int = 8):
    """Midgrid theta-tightening block scoring: (docids, tf, num, skip) with
    the blocks whose stored full-score bound fell below the running
    per-row k-th-best carry zeroed and flagged. ``norm_max`` is a float or
    a 0-d f32 tensor on the blocks' device."""
    if not packed_docs.is_cuda:
        return ref.bm25_blocks_midgrid_ref(
            packed_docs, bw_docs, first_doc, packed_tf, bw_tf, idf, active,
            rows, ubf, theta_lanes, norm_max, k1=k1, k=k,
            block_rows=block_rows)
    S = _check_blocks(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                      idf, active)
    dev = packed_docs.device
    _build.check_tensor(rows, torch.int32, (S,), "rows")
    _build.check_tensor(ubf, torch.float32, (S,), "ubf")
    _build.check_tensor(theta_lanes, torch.float32, (1, BLOCK),
                        "theta_lanes")
    nmax = torch.as_tensor(norm_max, dtype=torch.float32,
                           device=dev).reshape(1).contiguous()
    block_rows = min(block_rows, S)
    if S % block_rows or block_rows > 128:
        raise ValueError(f"block_rows {block_rows} must divide S={S} and be "
                         f"at most 128")
    doc = torch.empty((S, BLOCK), dtype=torch.int32, device=dev)
    tf = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    num = torch.empty((S, BLOCK), dtype=torch.float32, device=dev)
    skip = torch.empty((S,), dtype=torch.int32, device=dev)
    kth = torch.empty((S,), dtype=torch.float32, device=dev)
    rc = _build.lib("bm25_blockmax").bm25_midgrid(
        packed_docs.data_ptr(), bw_docs.data_ptr(), first_doc.data_ptr(),
        packed_tf.data_ptr(), bw_tf.data_ptr(), idf.data_ptr(),
        active.data_ptr(), rows.data_ptr(), ubf.data_ptr(),
        theta_lanes.data_ptr(), nmax.data_ptr(), _f32(k1 + 1.0), int(k),
        int(block_rows), kth.data_ptr(), doc.data_ptr(), tf.data_ptr(),
        num.data_ptr(), skip.data_ptr(), S, _build.stream_ptr(packed_docs))
    _build.check(rc, "bm25_blocks_midgrid")
    _build.LAUNCHES["bm25_blocks_midgrid"] += 1
    return doc, tf, num, skip

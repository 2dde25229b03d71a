"""Plain PyTorch version of the fused block-max BM25 scoring kernels (the
CPU path and the oracle ``chip_smoke.py`` holds the CUDA kernels against).

Per postings block (128 lanes): unpack the doc-id gaps (lane-blocked PFor),
prefix-sum them onto the block's first doc id, unpack the term
frequencies, and emit the BM25 numerator idf * (k1+1) * tf. Inactive
blocks emit zeros. The caller finishes the score with the per-doc length
norm, ``num / (tf + doc_norm[doc])``, which needs a doc-indexed gather.

Arithmetic follows the JAX reference operation for operation: f32
products left to right, Python scalars rounded once to f32, int32 doc ids
with two's-complement wraparound.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.postings_pack.ref import as_u32, unpack_ref, wrap_i32

BLOCK = 128


def _decode(packed_docs, bw_docs, first_doc, packed_tf, bw_tf, idf, k1):
    deltas = unpack_ref(packed_docs, bw_docs).to(torch.int64)
    docids = wrap_i32(first_doc.to(torch.int64)[:, None]
                      + torch.cumsum(deltas, dim=1))
    tf = as_u32(unpack_ref(packed_tf, bw_tf)).to(torch.float32)
    num = idf.to(torch.float32)[:, None] * (k1 + 1.0) * tf
    return docids, tf, num


def bm25_blocks_ref(packed_docs, bw_docs, first_doc, packed_tf, bw_tf,
                    idf, active, k1: float = 0.9):
    """-> (docids (S,128) int32, tf (S,128) f32, num (S,128) f32)."""
    docids, tf, num = _decode(packed_docs, bw_docs, first_doc, packed_tf,
                              bw_tf, idf, k1)
    act = (active > 0)[:, None]
    return (torch.where(act, docids, 0), torch.where(act, tf, 0.0),
            torch.where(act, num, 0.0))


def lane_partials_ref(tf, num, k1: float = 0.9, b: float = 0.4):
    """(1, 128) per-lane max of num / (tf + k1*(1-b)) over active blocks
    (``tf``/``num`` already zero on inactive blocks)."""
    min_norm = k1 * (1.0 - b)
    part = torch.where(tf > 0, num / (tf + min_norm), 0.0)
    return part.max(dim=0, keepdim=True).values


def bm25_blocks_partials_ref(packed_docs, bw_docs, first_doc, packed_tf,
                             bw_tf, idf, active, k1: float = 0.9,
                             b: float = 0.4):
    """``bm25_blocks_ref`` plus the TPU kernel's running (1, 128) carry:
    the per-lane max of the length-independent bound, from a zero init."""
    docids, tf, num = bm25_blocks_ref(packed_docs, bw_docs, first_doc,
                                      packed_tf, bw_tf, idf, active, k1)
    part = torch.clamp_min(lane_partials_ref(tf, num, k1, b), 0.0)
    return docids, tf, num, part


def _kth_lane_partial(part, k: int):
    """Per block row, a lower bound on the k-th largest of its 128 lane
    values: k-1 rounds of (take the max, retire every lane equal to it),
    then the max of what is left, floored at 0. Retiring ties only drives
    the result down — still a valid k-th-best lower bound."""
    cur = part
    for _ in range(max(k - 1, 0)):
        m = cur.max(dim=1, keepdim=True).values
        cur = torch.where(cur == m, -1.0, cur)
    return torch.clamp_min(cur.max(dim=1).values, 0.0)


def bm25_blocks_midgrid_ref(packed_docs, bw_docs, first_doc, packed_tf,
                            bw_tf, idf, active, rows, ubf, theta_lanes,
                            norm_max, k1: float = 0.9, k: int = 10,
                            block_rows: int = 8):
    """The midgrid theta-tightening kernel's semantics, step by step.

    Per step of ``block_rows`` blocks, in order: (1) with the running
    per-row carry L (seeded from ``theta_lanes``, lane j = row j), flag
    every ACTIVE block whose stored full-score bound ``ubf`` is strictly
    below its row's L as skipped — decisions within one step never see
    that step's own updates; (2) fold the kept blocks' k-th largest
    pessimistic partial ``num / (tf + norm_max)`` into L by row. Returns
    the plain outputs with skipped blocks zeroed, plus the (S,) int32 skip
    flags. A block's k-th value does not depend on L (a skipped block
    folds 0, which never raises L), so it is computed for all blocks up
    front and only the skip decisions walk the steps."""
    S = packed_docs.shape[0]
    block_rows = min(block_rows, S)
    assert S % block_rows == 0, (S, block_rows)
    dev = packed_docs.device
    docids, tf, num = _decode(packed_docs, bw_docs, first_doc, packed_tf,
                              bw_tf, idf, k1)
    act = active > 0
    nmax = torch.as_tensor(norm_max, dtype=torch.float32, device=dev)
    part = torch.where(act[:, None] & (tf > 0), num / (tf + nmax), 0.0)
    kth = _kth_lane_partial(part, k)
    rows = rows.to(torch.int64)
    in_range = (rows >= 0) & (rows < BLOCK)
    rows_c = rows.clamp(0, BLOCK - 1)
    ubf = ubf.to(torch.float32)
    L = theta_lanes.to(torch.float32).reshape(BLOCK).clone()
    skip = torch.zeros(S, dtype=torch.bool, device=dev)
    for s in range(0, S, block_rows):
        sl = slice(s, s + block_rows)
        l_row = torch.where(in_range[sl], L[rows_c[sl]], 0.0)
        sk = act[sl] & (ubf[sl] < l_row)
        skip[sl] = sk
        upd = torch.zeros(BLOCK, dtype=torch.float32, device=dev)
        upd.scatter_reduce_(0, rows_c[sl][in_range[sl]],
                            torch.where(sk, 0.0, kth[sl])[in_range[sl]],
                            reduce="amax", include_self=True)
        L = torch.maximum(L, upd)
    keep = (act & ~skip)[:, None]
    return (torch.where(keep, docids, 0), torch.where(keep, tf, 0.0),
            torch.where(keep, num, 0.0), skip.to(torch.int32))

"""BM25 query evaluation over the block-max index, in PyTorch: the
counterpart of the JAX package's ``core/query.py`` (fixed-stride layout;
the compact layout is not ported yet, see ``ROADMAP.md``).

Layout: per term, postings padded to 128-lane blocks; per block: first and
last doc id, max tf, shortest doc length, packed doc gaps and tfs
(lane-blocked PFor). Two evaluations share one contract — the same top-k
values, bit for bit:

``bm25_topk_dense``  every candidate lane is decoded and scored; the
    pruning decision only masks blocks. The parity oracle, and with
    ``prune=False`` the exhaustive path (``bm25_exhaustive``).

``bm25_topk`` / ``pruned_eval``  the serving path: a metadata pass
    (``prune_candidates`` — per-block upper bounds, no decode) feeds a
    host block-max WAND test (doc-range-overlap bounds, non-essential list
    elimination) at a threshold theta from a small phase-1 probe; the
    surviving blocks are compacted into a power-of-two bucket and only
    they are decoded and scored (``score_survivors``, or
    ``score_survivors_midgrid`` whose kernel keeps tightening theta
    inside its grid).

Bit-identity rests on two orders the reference fixes:
  * each doc's partial scores are summed in flattened candidate order,
    starting from +0.0 (XLA:CPU's scatter-add). ``_ordered_scatter_add``
    reproduces that order on every device with a stable sort and one
    deterministic pass per contribution rank — no float atomics;
  * ``jax.lax.top_k`` puts the lower index first among equal values.
    ``topk`` reproduces that with one ``torch.topk`` over a composite
    (score, -index) key.
Divisions by a collection statistic (``/ avgdl``) always divide by a
tensor on the device: PyTorch's CUDA division by a host scalar multiplies
by its reciprocal instead, which can differ in the last bit.
The host-side bound math (f64 numpy) is copied from the reference as is —
the +inf exemption of phase-1 probe blocks depends on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.bm25_blockmax.ops import (bm25_blocks,
                                                   bm25_blocks_midgrid)
from repro_torch.kernels.postings_pack import ops as pack_ops

BLOCK = 128
# phase-1 budget: blocks scored to establish theta
PHASE1_BLOCKS = 8
# survivor buckets: compacted arrays are padded to the next power of two,
# never below this floor
MIN_BUCKET = 8
# midgrid theta tightening runs the skip kernel with a SHORT grid step so
# the running k-th-best carry bites within one survivor bucket
MIDGRID_BLOCK_ROWS = 8
# the in-kernel k-th-best fold runs k-1 max/retire rounds per block
MIDGRID_MAX_K = 32


@dataclass
class BlockMaxIndex:
    """Device-resident block-max scoring index (fixed-stride layout).
    Packed words are uint32 bit patterns in int32 tensors."""

    terms: torch.Tensor            # (T,) int32, sorted
    term_block_start: torch.Tensor  # (T+1,) int32 CSR into blocks
    idf: torch.Tensor              # (T,) f32 segment-local idf
    packed_docs: torch.Tensor      # (NB, 32, 4) int32
    bw_docs: torch.Tensor          # (NB,) int32
    packed_tf: torch.Tensor        # (NB, 32, 4) int32
    bw_tf: torch.Tensor            # (NB,) int32
    first_doc: torch.Tensor        # (NB,) int32 local (slot) doc ids
    max_tf: torch.Tensor           # (NB,) f32
    doc_norm: torch.Tensor         # (D,) f32 k1*(1-b+b*dl/avgdl), local
    n_docs: int
    max_blocks_per_term: int
    k1: float = 0.9
    b: float = 0.4
    # the shortest doc length in each block: with ``max_tf`` it majorizes
    # every (tf, norm) pair the block holds (Lucene's impacts)
    min_dl: torch.Tensor = None    # (NB,) f32
    avgdl: float = 1.0             # segment-local mean live doc length
    # the last (largest) local doc id each block holds: [first, last] is
    # the block's doc-id range, which the BMW overlap bound reads
    last_doc: torch.Tensor = None  # (NB,) int32

    @property
    def device(self) -> torch.device:
        return self.terms.device

    def packed_bytes(self) -> float:
        return (pack_ops.packed_bytes(self.bw_docs)
                + pack_ops.packed_bytes(self.bw_tf))


@dataclass
class PruneStats:
    """Serving-side pruning counters, accumulated per evaluation batch.

    ``blocks_candidate``  lanes the query could touch (the dense path's
                          cost); ``blocks_survived`` blocks that passed
                          the bound test; ``blocks_scored`` blocks the
                          compacted path decoded + scored (phase-1 probes
                          + bucket-padded survivors, padding included).
    ``segments_skipped``  segments eliminated wholesale by the shared
                          theta (cross-segment threshold sharing).
    ``terms_eliminated``  per-(query, segment) non-essential terms (BMW).
    ``blocks_skipped_midgrid``  survivor blocks zeroed by the kernel's
                          in-grid theta tightening.
    """

    queries: int = 0
    batches: int = 0
    segments_visited: int = 0
    segments_skipped: int = 0
    blocks_candidate: int = 0
    blocks_survived: int = 0
    blocks_scored: int = 0
    terms_eliminated: int = 0
    blocks_skipped_midgrid: int = 0

    def add(self, other: "PruneStats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def snapshot(self) -> "PruneStats":
        return PruneStats(**{f: getattr(self, f) for f in
                             self.__dataclass_fields__})

    def delta(self, prev: "PruneStats") -> "PruneStats":
        return PruneStats(**{f: getattr(self, f) - getattr(prev, f)
                             for f in self.__dataclass_fields__})

    @property
    def skip_rate(self) -> float:
        """Fraction of candidate blocks NOT scored by the compacted path
        (negative for tiny candidate sets: the probe and the bucket floor
        are a fixed overhead)."""
        if self.blocks_candidate == 0:
            return 0.0
        return 1.0 - self.blocks_scored / self.blocks_candidate


# --------------------------------------------------------------------------
# order-exact reductions shared by every scorer
# --------------------------------------------------------------------------

def _ordered_scatter_add(size: int, idx: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """``zeros(size).at[idx].add(vals)`` with each target's contributions
    summed left to right in the order they appear, from +0.0 — the order
    XLA:CPU's scatter uses, reproduced exactly on CPU and CUDA alike.

    Zero contributions are dropped first (x + 0.0 == x for every
    accumulator a +0.0-seeded sum can hold). A stable sort groups each
    target's contributions in their original order; pass j then adds the
    j-th contribution of every target at once — targets are unique within
    a pass, so no two writes race and no float atomics are involved. The
    number of passes is the most contributions any target has (the query
    length, for a postings scatter)."""
    out = torch.zeros(size, dtype=torch.float32, device=vals.device)
    keep = vals != 0
    idx, vals = idx[keep], vals[keep]
    n = idx.numel()
    if n == 0:
        return out
    sidx, order = torch.sort(idx, stable=True)
    svals = vals[order]
    new = torch.ones(n, dtype=torch.bool, device=idx.device)
    new[1:] = sidx[1:] != sidx[:-1]
    run_start = torch.nonzero(new).reshape(-1)
    run_id = torch.cumsum(new, 0) - 1
    rank = torch.arange(n, device=idx.device) - run_start[run_id]
    acc = torch.zeros(run_start.numel(), dtype=torch.float32,
                      device=vals.device)
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        rid = run_id[sel]
        acc[rid] = acc[rid] + svals[sel]
    out[sidx[run_start]] = acc
    return out


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 with the same total order (for non-NaN values)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    n = scores.shape[-1]
    assert n < 2 ** 32, n
    key = _order_key(scores).to(torch.int64) * 2 ** 32 + (
        (2 ** 32 - 1) - torch.arange(n, device=scores.device))
    ids = torch.topk(key, k, dim=-1).indices
    return torch.gather(scores, -1, ids), ids


# --------------------------------------------------------------------------
# shared pieces of both evaluations
# --------------------------------------------------------------------------

def _gather_term_blocks(index: BlockMaxIndex, q_terms: torch.Tensor,
                        max_blocks=None):
    """For each query term (any shape): row lookup + padded block-id
    window. ``max_blocks`` narrows the window below the segment-wide
    ``max_blocks_per_term``; callers guarantee every query term has at
    most that many blocks."""
    q = q_terms.to(torch.int32)
    rows = torch.searchsorted(index.terms, q)
    rows = rows.clamp(0, index.terms.shape[0] - 1)
    found = index.terms[rows] == q
    start = index.term_block_start[rows].to(torch.int64)
    end = torch.where(found, index.term_block_start[rows + 1].to(torch.int64),
                      start)
    MB = index.max_blocks_per_term if max_blocks is None else max_blocks
    bidx = start[..., None] + torch.arange(MB, device=q.device)
    in_term = bidx < end[..., None]
    bidx = torch.where(in_term, bidx, 0)
    return rows, found, bidx, in_term


def _decode_score_blocks(index: BlockMaxIndex, flat, idf_flat, act_flat):
    """Decode + score a flat (S,) list of block ids (the one seam the dense
    grid and the compacted survivor scorer both go through)."""
    return bm25_blocks(
        index.packed_docs[flat], index.bw_docs[flat], index.first_doc[flat],
        index.packed_tf[flat], index.bw_tf[flat],
        idf_flat.to(torch.float32).contiguous(),
        act_flat.to(torch.int32).contiguous(), k1=index.k1, b=index.b)


def _lane_scores(tf, num, docids, doc_norm):
    denom = tf + doc_norm[docids.to(torch.int64)]
    return torch.where(tf > 0, num / denom.clamp_min(1e-9), 0.0)


def _score_blocks(index: BlockMaxIndex, bidx, active, idf_per_block,
                  doc_norm=None):
    """Exact BM25 partial scores for the selected blocks -> (D,) scores,
    summed per doc in flattened block order."""
    if doc_norm is None:
        doc_norm = index.doc_norm
    flat = bidx.reshape(-1)
    docids, tf, num = _decode_score_blocks(
        index, flat, idf_per_block.reshape(-1), active.reshape(-1))
    s = _lane_scores(tf, num, docids, doc_norm)
    return _ordered_scatter_add(index.n_docs, docids.reshape(-1).to(
        torch.int64), s.reshape(-1))


def block_upper_bounds(index: BlockMaxIndex, bidx, in_term, idf_q,
                       avgdl=None):
    """Safe per-block score upper bound from the block's impact pair:
    score(d) <= idf*(k1+1)*max_tf / (max_tf + k1*(1-b+b*min_dl/avgdl)).
    ``avgdl`` must be the mean length ``doc_norm`` was built from; None
    falls back to the dl=0 floor, safe under any doc_norm."""
    mt = index.max_tf[bidx]
    min_norm = index.k1 * (1.0 - index.b)
    if index.min_dl is not None and avgdl is not None:
        a = torch.as_tensor(avgdl, dtype=torch.float32, device=mt.device)
        min_norm = min_norm + index.k1 * index.b * index.min_dl[bidx] / a
    ub = idf_q[..., None] * (index.k1 + 1.0) * mt / (mt + min_norm)
    return torch.where(in_term & (mt > 0), ub, 0.0)


def _mask_live(scores, live):
    """Tombstone mask: deleted docs sink to -1, below every real score."""
    if live is None:
        return scores
    return torch.where(live, scores, -1.0)


def _resolve_idf(index: BlockMaxIndex, q_terms, idf_q):
    rows, found, _, _ = _gather_term_blocks(index, q_terms, 1)
    if idf_q is None:
        idf_q = index.idf[rows]
    return torch.where(found, idf_q, 0.0)


# --------------------------------------------------------------------------
# dense evaluation (parity oracle + exhaustive path)
# --------------------------------------------------------------------------

def bm25_topk_dense(index: BlockMaxIndex, q_terms, k: int = 10,
                    prune: bool = True, idf_q=None, doc_norm=None,
                    max_blocks=None, live=None, avgdl=None):
    """Dense evaluation of one query (Q,): every candidate lane is
    computed. ``prune=True`` runs the two-phase MaxScore test but only
    masks eliminated blocks (the pruning parity oracle); ``prune=False``
    is the exhaustive path. ``idf_q``/``doc_norm`` default to the
    segment-local statistics; ``live`` (D,) masks tombstoned docs."""
    q_terms = torch.as_tensor(q_terms, device=index.device).to(torch.int32)
    rows, found, bidx, in_term = _gather_term_blocks(index, q_terms,
                                                     max_blocks)
    if idf_q is None:
        idf_q = index.idf[rows]
    idf_q = torch.where(found, torch.as_tensor(idf_q, device=index.device),
                        0.0).to(torch.float32)
    idf_pb = idf_q[:, None].expand(bidx.shape)

    if not prune:
        scores = _mask_live(
            _score_blocks(index, bidx, in_term, idf_pb, doc_norm), live)
        vals, ids = topk(scores, k)
        n = int(in_term.sum())
        return vals, ids, {"blocks_scored": n, "blocks_total": n}

    if avgdl is None and doc_norm is None:
        avgdl = index.avgdl  # baked stats: the self-consistent pair
    ub = block_upper_bounds(index, bidx, in_term, idf_q, avgdl)  # (Q, MB)
    n_cand = ub.numel()
    n_phase1 = max(n_cand // 2, min(n_cand, 8))
    thresh_ub = torch.sort(ub.reshape(-1)).values[-n_phase1]
    phase1 = in_term & (ub >= thresh_ub)
    scores1 = _mask_live(
        _score_blocks(index, bidx, phase1, idf_pb, doc_norm), live)
    theta = topk(scores1, k)[0][-1]
    term_best = ub.max(dim=1).values
    others = term_best.sum() - term_best
    needed = ub + others[:, None] > theta
    active = in_term & (phase1 | needed)
    scores = _mask_live(
        _score_blocks(index, bidx, active, idf_pb, doc_norm), live)
    vals, ids = topk(scores, k)
    return vals, ids, {"blocks_scored": int(active.sum()),
                       "blocks_total": int(in_term.sum()), "theta": theta}


def bm25_exhaustive(index: BlockMaxIndex, q_terms, k: int = 10,
                    idf_q=None, doc_norm=None, live=None):
    return bm25_topk_dense(index, q_terms, k, prune=False,
                           idf_q=idf_q, doc_norm=doc_norm, live=live)


# --------------------------------------------------------------------------
# compacted pruned evaluation (the serving path)
# --------------------------------------------------------------------------

def prune_candidates(index: BlockMaxIndex, q_terms, idf_q=None,
                     max_blocks=None, avgdl=None):
    """Metadata pass over a (B, Q) batch (or one (Q,) query): per-candidate
    block upper bounds, without touching any postings bytes. Returns
    ``(ub, in_term, bidx, idf_pb, bfirst, blast)``, each (..., Q, MB)."""
    q_terms = q_terms.to(torch.int32)
    rows, found, bidx, in_term = _gather_term_blocks(index, q_terms,
                                                     max_blocks)
    if idf_q is None:
        idf_q = index.idf[rows]
    idf_q = torch.where(found, idf_q, 0.0).to(torch.float32)
    ub = block_upper_bounds(index, bidx, in_term, idf_q, avgdl)
    idf_pb = idf_q[..., None].expand(bidx.shape)
    bfirst = index.first_doc[bidx]
    blast = (torch.full(bidx.shape, index.n_docs - 1, dtype=torch.int32,
                        device=bidx.device)
             if index.last_doc is None else index.last_doc[bidx])
    return ub, in_term, bidx, idf_pb, bfirst, blast


def _survivor_tensors(index, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)).to(index.device)
            for a in arrays]


def score_survivors(index: BlockMaxIndex, cb_ids, cb_idf, cb_act, cb_row,
                    n_rows: int, k: int, doc_norm=None, live=None):
    """Compacted scorer over a batch-flat survivor list: entry j is block
    ``cb_ids[j]`` scored for query row ``cb_row[j]`` (host arrays;
    inactive padding contributes nothing). Decode + score exactly those
    blocks, sum into the (n_rows, D) score matrix in entry order, mask
    tombstones, per-row top-k."""
    if doc_norm is None:
        doc_norm = index.doc_norm
    ci, cf, ca, cr = _survivor_tensors(index, cb_ids, cb_idf, cb_act, cb_row)
    docids, tf, num = _decode_score_blocks(index, ci.to(torch.int64), cf, ca)
    s = _lane_scores(tf, num, docids, doc_norm)
    fidx = cr.to(torch.int64)[:, None] * index.n_docs + docids
    scores = _ordered_scatter_add(n_rows * index.n_docs, fidx.reshape(-1),
                                  s.reshape(-1)).reshape(n_rows, index.n_docs)
    if live is not None:
        scores = torch.where(live[None, :], scores, -1.0)
    return topk(scores, k)


def score_survivors_midgrid(index: BlockMaxIndex, cb_ids, cb_idf, cb_act,
                            cb_row, cb_ubf, theta_rows, n_rows: int, k: int,
                            doc_norm=None):
    """``score_survivors`` through the midgrid kernel: later grid steps
    zero any block whose stored full-score bound ``cb_ubf`` falls strictly
    below the row's running k-th-best lower bound (seeded from
    ``theta_rows``). Sound only without tombstones (the caller gates on
    that). Returns ``(vals, ids, n_skipped)``."""
    if doc_norm is None:
        doc_norm = index.doc_norm
    ci, cf, ca, cr, cu = _survivor_tensors(index, cb_ids, cb_idf, cb_act,
                                           cb_row, cb_ubf)
    ci = ci.to(torch.int64)
    theta_l = torch.zeros((1, BLOCK), dtype=torch.float32,
                          device=index.device)
    theta_l[0, :n_rows] = torch.as_tensor(
        np.asarray(theta_rows, np.float32)).to(index.device)
    docids, tf, num, skip = bm25_blocks_midgrid(
        index.packed_docs[ci], index.bw_docs[ci], index.first_doc[ci],
        index.packed_tf[ci], index.bw_tf[ci], cf.to(torch.float32),
        ca.to(torch.int32), cr.to(torch.int32), cu.to(torch.float32),
        theta_l, doc_norm.max(), k=k, k1=index.k1,
        block_rows=MIDGRID_BLOCK_ROWS)
    s = _lane_scores(tf, num, docids, doc_norm)
    fidx = cr.to(torch.int64)[:, None] * index.n_docs + docids
    scores = _ordered_scatter_add(n_rows * index.n_docs, fidx.reshape(-1),
                                  s.reshape(-1))
    vals, ids = topk(scores.reshape(n_rows, index.n_docs), k)
    return vals, ids, skip.sum()


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def survivor_bucket(n_surv: int) -> int:
    """Bucket for a survivor count: next power of two, at least
    ``MIN_BUCKET``."""
    return max(MIN_BUCKET, _pow2ceil(max(n_surv, 1)))


def compact_survivors(surv: np.ndarray, bidx: np.ndarray, idf_pb: np.ndarray,
                      bucket: int = None, ubf: np.ndarray = None):
    """Host-side survivor compaction over the WHOLE batch: the flattened
    positions of surviving blocks, in (row, grid position) order, padded
    to one bucket, with per-entry query-row attribution. ``ubf`` is each
    block's full-score bound for the midgrid kernel (None: +inf). Returns
    ``(cb_ids, cb_idf, cb_act, cb_row, cb_ubf)``, each (bucket,)."""
    B, N = surv.shape
    pos = np.flatnonzero(surv)
    if bucket is None:
        bucket = survivor_bucket(pos.size)
    assert pos.size <= bucket, "survivors must never be truncated"
    cb_ids = np.zeros(bucket, np.int32)
    cb_idf = np.zeros(bucket, np.float32)
    cb_act = np.zeros(bucket, bool)
    cb_row = np.zeros(bucket, np.int32)
    cb_ubf = np.full(bucket, np.inf, np.float32)
    cb_ids[:pos.size] = bidx.reshape(-1)[pos]
    cb_idf[:pos.size] = idf_pb.reshape(-1)[pos]
    cb_act[:pos.size] = True
    cb_row[:pos.size] = pos // N
    if ubf is not None:
        cb_ubf[:pos.size] = ubf.reshape(-1)[pos]
    return cb_ids, cb_idf, cb_act, cb_row, cb_ubf


def _row_searchsorted(keys: np.ndarray, queries: np.ndarray,
                      side: str, stride: int) -> np.ndarray:
    """Row-wise ``searchsorted`` via one flat searchsorted over row-offset
    values (every entry lives in [0, stride))."""
    R, MB = keys.shape
    off = np.arange(R, dtype=np.int64) * stride
    flat = np.searchsorted((keys + off[:, None]).reshape(-1),
                           (queries + off[:, None]).reshape(-1), side)
    return flat.reshape(R, -1) - np.arange(R)[:, None] * MB


def _range_max(rows: np.ndarray, lo: np.ndarray, hi: np.ndarray
               ) -> np.ndarray:
    """Per-row range max ``max(rows[r, lo[r,j]:hi[r,j]])`` (0.0 when
    empty), with a sparse table."""
    R, MB = rows.shape
    length = hi - lo
    res = np.zeros(lo.shape, rows.dtype)
    if MB == 0:
        return res
    tables = [rows]
    while (1 << len(tables)) <= MB:
        w = 1 << (len(tables) - 1)
        prev = tables[-1]
        tables.append(np.maximum(prev[:, :MB - 2 * w + 1],
                                 prev[:, w:MB - w + 1]))
    lvl = np.frexp(np.maximum(length, 1))[1] - 1
    for lv in range(len(tables)):
        sel = (lvl == lv) & (length > 0)
        if not sel.any():
            continue
        ri, qi = np.nonzero(sel)
        w = 1 << lv
        res[sel] = np.maximum(tables[lv][ri, lo[ri, qi]],
                              tables[lv][ri, hi[ri, qi] - w])
    return res


def _bmw_overlap_others(ub3, f3, l3, sentinel: int):
    """Doc-range-overlap "others" bound (true block-max WAND): for every
    candidate block j of term t, the sum over the OTHER query terms of the
    max bound among their blocks whose doc-id range intersects j's.
    (B, Q, MB) host arrays; pad entries hold ``sentinel`` in f3/l3."""
    B, Q, MB = ub3.shape
    stride = sentinel + 2
    overlap = np.zeros((B, Q, MB))
    for to in range(Q):
        keys_l = l3[:, to, :]
        keys_f = f3[:, to, :]
        for t in range(Q):
            if t == to:
                continue
            lo = _row_searchsorted(keys_l, f3[:, t, :], "left", stride)
            hi = _row_searchsorted(keys_f, l3[:, t, :], "right", stride)
            overlap[:, t, :] += _range_max(ub3[:, to, :], lo, hi)
    return overlap


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pruned_eval(meta, scorer_for, q2d, idf2d, k: int, theta0=None,
                n_phase1: int = PHASE1_BLOCKS, bmw: bool = True,
                scorer_mid_for=None):
    """Host-orchestrated pruned evaluation over a (B, Q) query batch.

    ``meta(q2d, idf2d)``      -> (ub, in_term, bidx, idf_pb, bfirst, blast),
                                 (B, Q, MB) (``prune_candidates``).
    ``scorer_for(n)``         -> fn(cb_ids, cb_idf, cb_act, cb_row) scoring a
                                 flat (n,) survivor list to (vals, ids).
    ``scorer_mid_for(n)``     optional midgrid variant for the survivor
                                 stage: fn(..., cb_ubf, theta_rows) ->
                                 (vals, ids, n_skipped). The phase-1 probe
                                 always uses the plain scorer.
    ``theta0``                (B,) or scalar lower bound on each query's
                                 final k-th score known from elsewhere.
    ``bmw``                   True: doc-range-overlap bound + non-
                                 essential list elimination; False: the
                                 term-level MaxScore test.

    Protocol, exactness argument and the probe-keep contract are the
    reference's (``repro/core/query.py::pruned_eval``). Returns
    ``(vals, ids, PruneStats)``."""
    ub_d, in_term_d, bidx_d, idf_pb_d, bf_d, bl_d = meta(q2d, idf2d)
    B = q2d.shape[0]
    ub = _host(ub_d).astype(np.float64).reshape(B, -1)
    in_term = _host(in_term_d).reshape(B, -1)
    bidx = _host(bidx_d).reshape(B, -1)
    idf_pb = _host(idf_pb_d).reshape(B, -1)
    n_cand = ub.shape[1]
    t0 = (np.zeros(B, np.float64) if theta0 is None
          else np.broadcast_to(np.asarray(theta0, np.float64),
                               (B,)).astype(np.float64))

    # phase 1: probe the highest-bound blocks for a threshold, unless the
    # caller already holds a positive bound for every query
    probed = 0
    top = None
    if not bool(np.all(t0 > 0)):
        P1 = min(n_phase1, n_cand)
        ubm = np.where(in_term, ub, -1.0)
        top = np.argpartition(-ubm, P1 - 1, axis=1)[:, :P1]
        p1_act = np.take_along_axis(in_term, top, 1)
        probed = _pow2ceil(B * P1)
        p1_ids = np.zeros(probed, np.int32)
        p1_idf = np.zeros(probed, np.float32)
        p1_actf = np.zeros(probed, bool)
        p1_row = np.zeros(probed, np.int32)
        p1_ids[:B * P1] = np.take_along_axis(bidx, top, 1).reshape(-1)
        p1_idf[:B * P1] = np.take_along_axis(idf_pb, top, 1).reshape(-1)
        p1_actf[:B * P1] = p1_act.reshape(-1)
        p1_row[:B * P1] = np.repeat(np.arange(B, dtype=np.int32), P1)
        vals1, _ = scorer_for(probed)(p1_ids, p1_idf, p1_actf, p1_row)
        theta = np.maximum(_host(vals1).astype(np.float64)[:, k - 1], t0)
    else:
        theta = t0

    # phase 2, on host metadata; the phase-1 probe blocks are kept
    # unconditionally (a probed doc can sit exactly at theta)
    Q = q2d.shape[1]
    ub3 = ub.reshape(B, Q, -1)
    MB = ub3.shape[2]
    term_best = ub3.max(axis=2)                            # (B, Q)
    n_elim = 0
    if bmw:
        in3 = in_term.reshape(B, Q, MB)
        bf, bl = _host(bf_d), _host(bl_d)
        sentinel = int(max(bl.max(initial=0), bf.max(initial=0)) + 1)
        f3 = np.where(in3, bf.astype(np.int64).reshape(B, Q, MB), sentinel)
        l3 = np.where(in3, bl.astype(np.int64).reshape(B, Q, MB), sentinel)
        bound3 = ub3 + _bmw_overlap_others(ub3, f3, l3, sentinel)
        base = in3 & (bound3 > theta[:, None, None])
        # non-essential list elimination
        order = np.argsort(term_best, axis=1, kind="stable")
        csum = np.cumsum(np.take_along_axis(term_best, order, 1), axis=1)
        ness = np.zeros((B, Q), bool)
        np.put_along_axis(ness, order, csum <= theta[:, None], 1)
        has_blocks = in3.any(axis=2)
        n_elim = int((ness & has_blocks).sum())
        if ness.any():
            ess_surv = (base & ~ness[:, :, None]).astype(np.float64)
            touches = _bmw_overlap_others(ess_surv, f3, l3, sentinel) > 0
            base = np.where(ness[:, :, None], base & touches, base)
        surv = base.reshape(B, -1)
        bound = bound3.reshape(B, -1)
    else:
        others = term_best.sum(axis=1, keepdims=True) - term_best
        bound = (ub3 + others[:, :, None]).reshape(B, -1)
        surv = in_term & (bound > theta[:, None])
    if top is not None:
        surv[np.arange(B)[:, None], top] |= p1_act
        # probe blocks keep their unconditional keep inside the midgrid
        # kernel too: their stored bound becomes +inf
        rows_b = np.repeat(np.arange(B), top.shape[1])
        cols_b = top.reshape(-1)
        keepmask = p1_act.reshape(-1)
        bound[rows_b[keepmask], cols_b[keepmask]] = np.inf
    n_surv = int(surv.sum())
    cb_ids, cb_idf, cb_act, cb_row, cb_ubf = compact_survivors(
        surv, bidx, idf_pb, ubf=bound)
    n_skipped = 0
    if scorer_mid_for is not None:
        vals, ids, n_skip = scorer_mid_for(cb_ids.shape[0])(
            cb_ids, cb_idf, cb_act, cb_row, cb_ubf,
            theta.astype(np.float32))
        n_skipped = int(n_skip)
    else:
        vals, ids = scorer_for(cb_ids.shape[0])(cb_ids, cb_idf, cb_act,
                                                cb_row)
    stats = PruneStats(
        segments_visited=1,
        blocks_candidate=int(in_term.sum()),
        blocks_survived=n_surv,
        blocks_scored=probed + cb_ids.shape[0],
        terms_eliminated=n_elim,
        blocks_skipped_midgrid=n_skipped)
    return vals, ids, stats


def bm25_topk(index: BlockMaxIndex, q_terms, k: int = 10,
              prune: bool = True, idf_q=None, doc_norm=None,
              max_blocks=None, live=None, theta0=None, avgdl=None,
              bmw: bool = True, midgrid: bool = True):
    """Top-k BM25 of one query: ``(scores (k,), doc_ids (k,), stats)``.
    ``prune=True`` runs the compacted pruned path; ``prune=False`` the
    dense exhaustive one. Results are identical either way. ``midgrid``
    scores survivors through the theta-tightening kernel when its gates
    hold (no tombstones, k <= ``MIDGRID_MAX_K``)."""
    if not prune:
        return bm25_topk_dense(index, q_terms, k, prune=False, idf_q=idf_q,
                               doc_norm=doc_norm, max_blocks=max_blocks,
                               live=live)
    q_terms = torch.as_tensor(q_terms, device=index.device).to(torch.int32)
    idf1 = _resolve_idf(index, q_terms, idf_q)
    if avgdl is None and doc_norm is None:
        avgdl = index.avgdl  # baked stats: the self-consistent pair

    def meta(q2d, idf2d):
        return prune_candidates(index, q2d, idf2d, max_blocks, avgdl)

    def scorer_for(_n):
        return lambda ci, cf, ca, cr: score_survivors(
            index, ci, cf, ca, cr, 1, k, doc_norm, live)

    scorer_mid_for = None
    if midgrid and live is None and k <= MIDGRID_MAX_K:
        def scorer_mid_for(_n):
            return lambda ci, cf, ca, cr, cu, th: score_survivors_midgrid(
                index, ci, cf, ca, cr, cu, th, 1, k, doc_norm)

    vals, ids, stats = pruned_eval(meta, scorer_for, q_terms[None],
                                   idf1[None], k, theta0=theta0, bmw=bmw,
                                   scorer_mid_for=scorer_mid_for)
    stats.queries, stats.batches = 1, 1
    return vals[0], ids[0], {
        "blocks_scored": stats.blocks_scored,
        "blocks_survived": stats.blocks_survived,
        "blocks_total": stats.blocks_candidate,
        "prune_stats": stats,
    }

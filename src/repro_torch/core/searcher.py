"""Segment-native read path in PyTorch: per-segment readers and the
multi-segment searcher (the counterpart of the JAX package's
``core/searcher.py``), over either index layout: fixed-stride packed
planes, or the compact layout (``compact=True``: only the live plane rows
the storage codec writes, scored by the fused decompress-and-score
kernel).

  ``build_block_index``   vectorized (numpy CSR block-alignment) builder of
                          the device-resident ``BlockMaxIndex`` of one
                          segment; the packing runs through the pack op
                          (the CUDA kernel on the card).
  ``SegmentReader``       one open segment: its block-max index, the
                          local->absolute doc-id map, the live-doc mask
                          (tombstones), and its per-shape evaluators.
  ``IndexSearcher``       an immutable snapshot over a list of readers,
                          evaluating each segment under collection-global
                          LIVE statistics and merging per-segment top-k,
                          with cross-segment threshold sharing when pruned.
  ``ReaderCache``         keyed by ``Segment.seg_id``: a refresh builds
                          readers only for segments it has not seen, and a
                          delete reopens the existing reader over the new
                          liveness instead of rebuilding its index.

PyTorch runs eagerly, so the JAX package's shape-keyed cache of compiled
evaluators becomes a plain dict of per-shape callables; it still counts
hits (``evaluator_cache_hits``). Results are returned as CPU tensors: the
per-segment top-k are merged on the host.
"""
from __future__ import annotations

import collections
import itertools
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.query import (BLOCK, MIDGRID_MAX_K, BlockMaxIndex,
                                    PruneStats, bm25_topk_dense,
                                    prune_candidates, pruned_eval,
                                    score_survivors, score_survivors_midgrid,
                                    topk)
from repro_torch.core.segments import Segment, live_posting_stats
from repro_torch.device import resolve_device
from repro_torch.kernels.postings_pack import ops as pack_ops


# --------------------------------------------------------------------------
# per-shape evaluator sharing
# --------------------------------------------------------------------------

_IDX_FIELDS_DENSE = ("terms", "term_block_start", "idf", "packed_docs",
                     "bw_docs", "packed_tf", "bw_tf", "first_doc", "max_tf",
                     "doc_norm", "min_dl", "last_doc")
_IDX_FIELDS_COMPACT = ("terms", "term_block_start", "idf", "bw_docs",
                       "bw_tf", "first_doc", "max_tf", "doc_norm", "min_dl",
                       "last_doc", "cplanes_docs", "coff_docs",
                       "cplanes_tf", "coff_tf")
_EVAL_CACHE_CAP = 128
_EVAL_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_EVAL_HITS = [0]
_EVAL_LOCK = threading.Lock()


def _shared_evaluator(kind_key: tuple, index: BlockMaxIndex, build):
    """Fetch or build the evaluator for this kind + the index's shape
    signature. ``build()`` returns a callable whose first argument is the
    index. Returns ``(fn, was_cached)``. The layout is part of the key:
    a segment's compact and dense indexes never share an entry."""
    names = _IDX_FIELDS_COMPACT if index.compact else _IDX_FIELDS_DENSE
    shapes = tuple((tuple(getattr(index, n).shape),
                    str(getattr(index, n).dtype)) for n in names)
    key = (kind_key, index.compact, index.n_docs, index.max_blocks_per_term,
           index.k1, index.b, str(index.device), shapes)
    with _EVAL_LOCK:
        fn = _EVAL_CACHE.get(key)
        if fn is not None:
            _EVAL_CACHE.move_to_end(key)
            return fn, True
    fn = build()
    with _EVAL_LOCK:
        fn = _EVAL_CACHE.setdefault(key, fn)
        _EVAL_CACHE.move_to_end(key)
        while len(_EVAL_CACHE) > _EVAL_CACHE_CAP:
            _EVAL_CACHE.popitem(last=False)
    return fn, False


def evaluator_cache_hits() -> int:
    """Reader-level evaluator lookups served by the shared cache."""
    with _EVAL_LOCK:
        return _EVAL_HITS[0]


def _count_eval_hit(cached: bool) -> None:
    if cached:
        with _EVAL_LOCK:
            _EVAL_HITS[0] += 1


# --------------------------------------------------------------------------
# per-segment index construction
# --------------------------------------------------------------------------

def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 (or any non-negative int < 2^32) array -> the port's
    int32 bit-pattern tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32)).to(device)


def _finish_index(seg: Segment, deltas: np.ndarray, tfs: np.ndarray,
                  first_doc: np.ndarray, max_tf: np.ndarray,
                  term_nb: np.ndarray, df: np.ndarray,
                  k1: float, b: float, min_dl: np.ndarray,
                  dl: np.ndarray = None, last_doc: np.ndarray = None,
                  compact: bool = False, device="cpu") -> BlockMaxIndex:
    """Shared tail of the builder: pack the blocks on ``device`` and
    assemble the index. ``dl`` is the LOCAL-SLOT-ordered doc-length
    vector (a reordered build passes the permuted one). ``compact=True``
    keeps only the live bit-plane rows + per-block row offsets instead of
    the fixed-stride packed buffers."""
    device = torch.device(device)
    pd, bwd = pack_ops.pack(_u32_tensor(deltas, device))
    pt, bwt = pack_ops.pack(_u32_tensor(tfs, device))
    extra = {}
    if compact:
        # keep only what the storage codec writes: the compacted plane
        # rows, tail-padded with 32 zero rows (the JAX package's shapes),
        # and each block's first row
        pad = torch.zeros((32, pack_ops.WORDS_PER_PLANE), dtype=torch.int32,
                          device=device)
        extra = dict(
            cplanes_docs=torch.cat([pack_ops.compact_planes(pd, bwd), pad]),
            coff_docs=(torch.cumsum(bwd, 0) - bwd).to(torch.int32),
            cplanes_tf=torch.cat([pack_ops.compact_planes(pt, bwt), pad]),
            coff_tf=(torch.cumsum(bwt, 0) - bwt).to(torch.int32))
        pd = pt = None

    n_docs = seg.n_docs
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    dl = (seg.doc_len if dl is None else dl).astype(np.float64)
    avgdl = max(dl.mean(), 1.0) if dl.size else 1.0
    doc_norm = k1 * (1.0 - b + b * dl / avgdl)
    tbs = np.concatenate([[0], np.cumsum(term_nb)])

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(dtype))).to(device)

    return BlockMaxIndex(
        terms=dev(seg.terms, np.int32),
        term_block_start=dev(tbs, np.int32),
        idf=dev(idf, np.float32),
        packed_docs=pd, bw_docs=bwd, packed_tf=pt, bw_tf=bwt,
        first_doc=dev(first_doc, np.int32),
        max_tf=dev(max_tf, np.float32),
        doc_norm=dev(doc_norm, np.float32),
        n_docs=n_docs,
        max_blocks_per_term=int(np.max(term_nb)) if len(term_nb) else 1,
        k1=k1, b=b,
        min_dl=dev(min_dl, np.float32), avgdl=avgdl,
        last_doc=dev(first_doc if last_doc is None else last_doc, np.int32),
        **extra)


def _local_layout(seg: Segment):
    """``(local_docs, tf_stream, dl_local)`` in the segment's LOCAL
    doc-slot layout: the identity in natural order; a BP-reordered
    segment permutes the slots and re-sorts each term's postings by slot."""
    local_docs = np.searchsorted(seg.doc_ids, seg.docs)
    if seg.reorder is None:
        return local_docs, seg.tf, seg.doc_len
    rank_of = np.empty(seg.n_docs, np.int64)
    rank_of[seg.reorder] = np.arange(seg.n_docs)
    local_r = rank_of[local_docs]
    tix = np.repeat(np.arange(seg.n_terms), np.diff(seg.term_start))
    perm = np.lexsort((local_r, tix))   # per-term sort by new slot rank
    return local_r[perm], seg.tf[perm], seg.doc_len[seg.reorder]


def build_block_index(seg: Segment, k1: float = 0.9, b: float = 0.4,
                      compact: bool = False,
                      device="cpu") -> BlockMaxIndex:
    """Block-align each term's postings and pack them — vectorized, O(P).
    Every term starts a fresh block; pad lanes carry gap 0 and tf 0. A
    segment with a BP ``reorder`` gets its blocks laid out over the
    reordered slot space (scores and returned doc ids are unchanged).
    ``compact=True`` builds the fused decompress-and-score layout (see
    ``_finish_index``)."""
    assert np.all(np.diff(seg.doc_ids) > 0), \
        "Segment.doc_ids must be sorted unique (np.searchsorted relies on it)"
    local_docs, tf_stream, dl_local = _local_layout(seg)
    df = np.diff(seg.term_start).astype(np.int64)
    term_nb = -(-df // BLOCK)                     # ceil: blocks per term
    nb_total = int(term_nb.sum())
    if nb_total == 0:                             # empty segment
        return _finish_index(seg, np.zeros((1, BLOCK), np.int64),
                             np.zeros((1, BLOCK), np.int64),
                             np.zeros(1, np.int64), np.zeros(1, np.int64),
                             np.zeros(1, np.int64), df, k1, b,
                             np.zeros(1, np.int64), dl=dl_local,
                             compact=compact, device=device)

    n_post = len(seg.docs)
    block_term = np.repeat(np.arange(seg.n_terms), term_nb)   # (NB,)
    nb_before = np.cumsum(term_nb) - term_nb                  # (T,)
    within = np.arange(nb_total) - nb_before[block_term]      # (NB,)
    blk_s = seg.term_start[:-1][block_term] + within * BLOCK  # (NB,) sorted
    sizes = np.diff(np.append(blk_s, n_post))                 # tiles [0, P)
    lane = np.arange(n_post) - np.repeat(blk_s, sizes)        # (P,)
    flat_pos = np.repeat(np.arange(nb_total) * BLOCK, sizes) + lane
    d = local_docs.copy()
    d[1:] -= local_docs[:-1]
    d[blk_s] = 0                                  # first lane of each block
    deltas = np.zeros(nb_total * BLOCK, np.uint32)  # pad lanes stay 0
    deltas[flat_pos] = d
    tfs = np.zeros(nb_total * BLOCK, np.uint32)
    tfs[flat_pos] = tf_stream
    return _finish_index(seg, deltas.reshape(nb_total, BLOCK),
                         tfs.reshape(nb_total, BLOCK), local_docs[blk_s],
                         np.maximum.reduceat(tf_stream, blk_s), term_nb,
                         df, k1, b,
                         np.minimum.reduceat(dl_local[local_docs], blk_s),
                         dl=dl_local, last_doc=local_docs[blk_s + sizes - 1],
                         compact=compact, device=device)


# --------------------------------------------------------------------------
# readers and the multi-segment searcher
# --------------------------------------------------------------------------

def _live_term_df(seg: Segment) -> np.ndarray:
    """Per-term LIVE df (tombstoned postings do not count)."""
    return live_posting_stats(seg)[1]


def _term_impacts(index: BlockMaxIndex, n_terms: int):
    """(T,) host copies of each term's best block-max tf and shortest doc
    length (the searcher's cross-segment ordering reads them)."""
    if n_terms == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    tbs = index.term_block_start[:n_terms].cpu().numpy()
    return (np.maximum.reduceat(index.max_tf.cpu().numpy(), tbs),
            np.minimum.reduceat(index.min_dl.cpu().numpy(), tbs))


def _live_local(seg: Segment, device):
    if not seg.has_deletes:
        return None
    live_np = ~seg.deletes
    if seg.reorder is not None:
        live_np = live_np[seg.reorder]
    return torch.from_numpy(np.ascontiguousarray(live_np)).to(device)


@dataclass
class SegmentReader:
    """One open segment: device index + doc-id map + liveness + per-shape
    evaluators. The index always covers the FULL postings; tombstones live
    in the ``live`` mask and in the live-only statistics."""

    seg: Segment
    index: BlockMaxIndex
    doc_map: torch.Tensor         # (D,) local -> absolute doc id (device)
    terms_np: np.ndarray          # host copies for global-df lookups
    df_np: np.ndarray             # (T,) LIVE df per term
    nb_np: np.ndarray             # (T,) blocks per term
    term_max_tf_np: np.ndarray = None
    term_min_dl_np: np.ndarray = None
    live: object = None           # (D,) bool device mask; None = no deletes
    live_doc_len: np.ndarray = None  # host doc lengths of live docs only
    doc_len_local: np.ndarray = None  # (D,) doc lengths in LOCAL slot order
    _fns: dict = field(default_factory=dict)

    @classmethod
    def open(cls, seg: Segment, k1: float = 0.9, b: float = 0.4,
             compact: bool = False, device="cpu") -> "SegmentReader":
        device = torch.device(device)
        df_full = np.diff(seg.term_start).astype(np.int64)
        index = build_block_index(seg, k1, b, compact=compact, device=device)
        tmax, tmin = _term_impacts(index, seg.n_terms)
        r = seg.reorder
        doc_ids_local = seg.doc_ids if r is None else seg.doc_ids[r]
        return cls(seg=seg, index=index,
                   doc_map=torch.from_numpy(np.ascontiguousarray(
                       doc_ids_local.astype(np.int64))).to(device),
                   terms_np=np.asarray(seg.terms),
                   df_np=_live_term_df(seg),
                   nb_np=-(-df_full // BLOCK),
                   term_max_tf_np=tmax, term_min_dl_np=tmin,
                   live=_live_local(seg, device),
                   live_doc_len=(seg.doc_len[~seg.deletes]
                                 if seg.has_deletes else seg.doc_len),
                   doc_len_local=(seg.doc_len if r is None
                                  else seg.doc_len[r]))

    def reopen(self, seg: Segment) -> "SegmentReader":
        """Same postings core, new tombstone bitmap: shares the packed
        device index, the doc map and the evaluators."""
        assert seg.base_id == self.seg.base_id, "reopen needs the same core"
        return SegmentReader(
            seg=seg, index=self.index, doc_map=self.doc_map,
            terms_np=self.terms_np, df_np=_live_term_df(seg),
            nb_np=self.nb_np, term_max_tf_np=self.term_max_tf_np,
            term_min_dl_np=self.term_min_dl_np,
            live=_live_local(seg, self.index.device),
            live_doc_len=(seg.doc_len[~seg.deletes] if seg.has_deletes
                          else seg.doc_len),
            doc_len_local=self.doc_len_local,
            _fns=self._fns)

    @property
    def seg_id(self) -> int:
        return self.seg.seg_id

    @property
    def n_docs(self) -> int:
        return self.seg.n_docs

    @property
    def live_docs(self) -> int:
        return self.seg.live_doc_count

    @property
    def device(self) -> torch.device:
        return self.index.device

    def query_max_blocks(self, q: np.ndarray) -> int:
        """Exact max blocks-per-term over the query's terms, rounded up to
        a power of two (bounded number of window shapes)."""
        t = self.terms_np
        if t.size == 0:
            return 1
        rows = np.clip(np.searchsorted(t, q), 0, t.size - 1)
        nb = np.where(t[rows] == q, self.nb_np[rows], 1)
        need = int(nb.max(initial=1))
        return min(1 << (need - 1).bit_length(),
                   max(self.index.max_blocks_per_term, 1))

    def query_max_ub(self, q2d: np.ndarray, idf2d: np.ndarray,
                     avgdl: float = 1.0) -> np.ndarray:
        """(B,) best POSSIBLE score this segment can give each query, from
        host metadata only."""
        t = self.terms_np
        q = np.asarray(q2d)
        if t.size == 0:
            return np.zeros(q.shape[0], np.float64)
        rows = np.clip(np.searchsorted(t, q), 0, t.size - 1)
        found = t[rows] == q
        mt = np.where(found, self.term_max_tf_np[rows], 0.0)
        k1, b = self.index.k1, self.index.b
        norm = k1 * (1.0 - b) \
            + k1 * b * np.where(found, self.term_min_dl_np[rows], 0.0) / avgdl
        ub = np.where(mt > 0,
                      np.asarray(idf2d, np.float64) * (k1 + 1.0)
                      * mt / (mt + norm), 0.0)
        return ub.sum(axis=-1)

    def _fn(self, key: tuple, build):
        if key not in self._fns:
            fn, cached = _shared_evaluator(key, self.index, build)
            _count_eval_hit(cached)
            self._fns[key] = fn
        return self._fns[key]

    def topk_fn(self, k: int, max_blocks: int):
        """Dense-exhaustive ``(index, doc_map, q (B, Q), idf (B, Q),
        doc_norm, live) -> (scores (B, k), abs doc ids (B, k))``."""
        def build():
            def fn(index, doc_map, q, idf_q, doc_norm, live):
                vs, ids = [], []
                for qi, fi in zip(q, idf_q):
                    v, i, _ = bm25_topk_dense(
                        index, qi, k, prune=False, idf_q=fi,
                        doc_norm=doc_norm, max_blocks=max_blocks, live=live)
                    vs.append(v)
                    ids.append(doc_map[i])
                return torch.stack(vs), torch.stack(ids)
            return fn
        return self._fn(("dense", k, max_blocks), build)

    def topk(self, q, idf_q, doc_norm, k: int, max_blocks: int):
        """Dense-exhaustive top-k of a (B, Q) batch on this segment,
        masking tombstones."""
        dev = self.device
        q = torch.as_tensor(np.asarray(q, np.int32)).to(dev)
        idf_q = torch.as_tensor(np.asarray(idf_q, np.float32)).to(dev)
        return self.topk_fn(k, max_blocks)(self.index, self.doc_map, q, idf_q,
                                           doc_norm, self.live)

    def _pruned_fns(self, k: int, max_blocks: int, n_rows: int,
                    midgrid: bool = False):
        """The device stages of the compacted pruned path: the metadata
        pass, the batch-flat survivor scorer and (``midgrid``) its
        theta-tightening variant."""
        def build_meta():
            def meta(index, q2d, idf2d, avgdl):
                return prune_candidates(index, q2d, idf2d, max_blocks, avgdl)
            return meta

        def build_score():
            def score(index, doc_map, ci, cf, ca, cr, doc_norm, live):
                vals, ids = score_survivors(index, ci, cf, ca, cr, n_rows, k,
                                            doc_norm, live)
                return vals, doc_map[ids]
            return score

        def build_mid():
            def score(index, doc_map, ci, cf, ca, cr, cu, th, doc_norm):
                vals, ids, nskip = score_survivors_midgrid(
                    index, ci, cf, ca, cr, cu, th, n_rows, k, doc_norm)
                return vals, doc_map[ids], nskip
            return score

        meta = self._fn(("meta", max_blocks), build_meta)
        scorer = self._fn(("scorer", k, n_rows), build_score)
        mid = self._fn(("midscorer", k, n_rows), build_mid) if midgrid \
            else None
        return meta, scorer, mid

    def topk_pruned(self, q2d, idf2d, doc_norm, k: int, max_blocks: int,
                    theta0=None, avgdl=None, bmw: bool = True,
                    midgrid: bool = True):
        """Compacted pruned top-k over a (B, Q) batch, through the midgrid
        kernel when its gates hold (``midgrid`` requested, no tombstones,
        fixed-stride layout, k within the in-kernel fold's budget, at most
        128 batch rows). Returns ``(vals (B, k), abs doc ids (B, k),
        PruneStats)``."""
        n_rows = int(q2d.shape[0])
        use_mid = (midgrid and self.live is None and not self.index.compact
                   and k <= MIDGRID_MAX_K and n_rows <= BLOCK)
        meta_f, scorer, mid = self._pruned_fns(k, max_blocks, n_rows,
                                               use_mid)
        index, doc_map, live = self.index, self.doc_map, self.live
        meta = lambda q2, f2: meta_f(index, q2, f2, avgdl)  # noqa: E731

        def scorer_for(_n):
            return lambda ci, cf, ca, cr: scorer(
                index, doc_map, ci, cf, ca, cr, doc_norm, live)

        scorer_mid_for = None
        if use_mid:
            def scorer_mid_for(_n):
                return lambda ci, cf, ca, cr, cu, th: mid(
                    index, doc_map, ci, cf, ca, cr, cu, th, doc_norm)
        dev = self.device
        return pruned_eval(
            meta, scorer_for,
            torch.as_tensor(np.asarray(q2d, np.int32)).to(dev),
            torch.as_tensor(np.asarray(idf2d, np.float32)).to(dev),
            k, theta0=theta0, bmw=bmw, scorer_mid_for=scorer_mid_for)


def _merge_topk(parts_v: list, parts_i: list, k: int):
    """Per-segment (B, k_s) results -> global (B, k) on the host, padded
    with (0.0, -1) when fewer than k exist."""
    vals = torch.from_numpy(np.concatenate(parts_v, axis=1))
    ids = torch.from_numpy(np.concatenate(parts_i, axis=1))
    kk = min(k, vals.shape[1])
    top_v, pos = topk(vals, kk)
    top_i = torch.gather(ids, 1, pos)
    if kk < k:
        top_v = torch.nn.functional.pad(top_v, (0, k - kk))
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    return top_v, top_i


@dataclass
class IndexSearcher:
    """Point-in-time searchable view over a set of live segments.

    Per-segment evaluation runs under collection-global statistics from
    LIVE docs only (summed live df -> idf, live avgdl -> doc_norm), so each
    live doc scores exactly as in the force-merged compacted index and a
    merge of per-segment top-k is the global top-k. ``prune=True`` serves
    the compacted pruned path with cross-segment threshold sharing;
    ``prune=False`` the dense exhaustive baseline. ``prune_stats``
    accumulates the per-batch counters under a lock.
    """

    readers: list
    k1: float = 0.9
    b: float = 0.4
    prune: bool = True
    bmw: bool = True       # doc-range-overlap (BMW) bound; False: MaxScore
    midgrid: bool = True   # in-grid theta tightening where its gates hold
    device: object = None  # None: CUDA (raises without one); or "cpu"
    n_docs: int = 0                # LIVE docs in the snapshot
    avgdl: float = 1.0
    # degraded serving: the snapshot was recovered minus quarantined
    # segments; results are exact over the surviving docs, but
    # ``missing_docs`` committed docs are absent
    degraded: bool = False
    missing_docs: int = 0
    quarantined: tuple = ()        # quarantined segment base names
    # snapshot identity for result caching (0 = unkeyed): one per
    # distinct (seg_ids, quarantine) state a ReaderCache serves
    generation: int = 0
    prune_stats: PruneStats = None
    _doc_norms: list = None
    _df_terms: np.ndarray = None   # (U,) sorted union of segment terms
    _df_table: np.ndarray = None   # (U,) collection-wide LIVE df per term
    _stats_lock: threading.Lock = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for r in self.readers:
            if r.device != self.device:
                raise ValueError(f"reader on {r.device}, searcher on "
                                 f"{self.device}")
        self.prune_stats = PruneStats()
        self._stats_lock = threading.Lock()
        dls = [r.live_doc_len for r in self.readers]
        all_dl = (np.concatenate(dls).astype(np.float64) if dls
                  else np.zeros(0, np.float64))
        self.n_docs = int(all_dl.size)
        self.avgdl = max(all_dl.mean(), 1.0) if all_dl.size else 1.0
        # norms are indexed by LOCAL doc slot at scoring time
        self._doc_norms = [
            torch.from_numpy((self.k1 * (1.0 - self.b + self.b *
                              (r.doc_len_local if r.doc_len_local is not None
                               else r.seg.doc_len).astype(np.float64)
                              / self.avgdl)).astype(np.float32)
                             ).to(self.device)
            for r in self.readers]
        if self.readers:
            all_t = np.concatenate([r.terms_np for r in self.readers])
            all_df = np.concatenate([r.df_np for r in self.readers])
            self._df_terms, inv = np.unique(all_t, return_inverse=True)
            self._df_table = np.zeros(self._df_terms.size, np.int64)
            np.add.at(self._df_table, inv, all_df)
        else:
            self._df_terms = np.zeros(0, np.int64)
            self._df_table = np.zeros(0, np.int64)

    @property
    def n_segments(self) -> int:
        return len(self.readers)

    def global_idf(self, q_terms: np.ndarray) -> np.ndarray:
        """Collection-wide idf for ``q_terms`` (any shape); terms absent
        everywhere (including -1 query padding) get df 0."""
        q = np.asarray(q_terms, np.int64)
        t = self._df_terms
        if t.size == 0:
            df = np.zeros(q.shape, np.int64)
        else:
            rows = np.clip(np.searchsorted(t, q), 0, t.size - 1)
            df = np.where(t[rows] == q, self._df_table[rows], 0)
        return np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)
                      ).astype(np.float32)

    def _empty(self, B, k):
        return (torch.zeros((B, k), dtype=torch.float32),
                torch.full((B, k), -1, dtype=torch.int64))

    def _search_pruned(self, q2d: np.ndarray, k: int, theta0=None):
        """Pruned evaluation of a (B, Q) batch with cross-segment
        threshold sharing: readers in descending best-possible-score
        order, the running global k-th score seeding each later segment,
        and segments whose best possible score is below it skipped."""
        B = q2d.shape[0]
        idf = self.global_idf(q2d)
        stats = PruneStats(queries=B, batches=1)
        live = [(r, dn) for r, dn in zip(self.readers, self._doc_norms)
                if min(k, r.live_docs) > 0 and r.terms_np.size > 0]
        seg_ub = [r.query_max_ub(q2d, idf, self.avgdl) for r, _ in live]
        order = np.argsort([-float(u.sum()) for u in seg_ub], kind="stable")
        ext_theta = theta0 is not None
        theta0 = (np.zeros(B, np.float64) if theta0 is None else
                  np.array(np.broadcast_to(
                      np.asarray(theta0, np.float64), (B,))))
        running = None
        parts_v, parts_i = [], []
        for oi in order:
            r, dn = live[oi]
            k_eff = min(k, r.live_docs)
            if (ext_theta or (running is not None
                              and running.shape[1] >= k)) \
                    and bool(np.all(seg_ub[oi] < theta0)):
                stats.segments_skipped += 1
                continue
            mb = r.query_max_blocks(q2d)
            v, i, st = r.topk_pruned(q2d, idf, dn, k_eff, mb, theta0=theta0,
                                     avgdl=self.avgdl, bmw=self.bmw,
                                     midgrid=self.midgrid)
            stats.add(st)
            v_np = v.cpu().numpy()
            parts_v.append(v_np)
            parts_i.append(i.cpu().numpy())
            running = v_np if running is None \
                else np.concatenate([running, v_np], axis=1)
            if running.shape[1] > k:
                running = -np.partition(-running, k - 1, axis=1)[:, :k]
            if running.shape[1] >= k:
                theta0 = np.maximum(theta0, running.min(axis=1))
        with self._stats_lock:
            self.prune_stats.add(stats)
        if not parts_v:
            return self._empty(B, k)
        return _merge_topk(parts_v, parts_i, k)

    def _search_dense(self, q2d: np.ndarray, k: int):
        B = q2d.shape[0]
        idf = self.global_idf(q2d)
        parts_v, parts_i = [], []
        for r, dn in zip(self.readers, self._doc_norms):
            k_eff = min(k, r.live_docs)
            if k_eff <= 0 or r.terms_np.size == 0:
                continue  # nothing live (or no postings): contributes 0
            v, i = r.topk(q2d, idf, dn, k_eff, r.query_max_blocks(q2d))
            parts_v.append(v.cpu().numpy())
            parts_i.append(i.cpu().numpy())
        if not parts_v:
            return self._empty(B, k)
        return _merge_topk(parts_v, parts_i, k)

    def search(self, q_terms, k: int = 10):
        """Top-k over every live segment: (scores (k,), doc ids (k,)) with
        absolute doc ids, as CPU tensors."""
        v, i = self.search_batched(np.asarray(q_terms)[None], k)
        return v[0], i[0]

    def search_batched(self, q_batch, k: int = 10, theta0=None):
        """Fixed-shape batched search: ``q_batch`` is (B, Q) int32, queries
        right-padded with -1. Returns (scores (B, k), doc ids (B, k)) as
        CPU tensors. ``theta0`` seeds the pruning threshold from outside
        the snapshot; the dense path ignores it."""
        q = np.asarray(q_batch)
        if self.prune:
            return self._search_pruned(q, k, theta0=theta0)
        return self._search_dense(q, k)


# every distinct snapshot state any ReaderCache serves gets a unique id
_GENERATIONS = itertools.count(1)


@dataclass
class ReaderCache:
    """Reader cache keyed by segment identity (``Segment.seg_id``).

    ``refresh(segs)`` returns a searcher over exactly ``segs``, reusing
    cached readers, reopening readers whose postings core is cached under
    a new delete bitmap (``reopens``), and evicting readers whose segments
    left the live set. Refresh callers are serialized only around the
    cache dict; reader builds run outside the lock."""

    k1: float = 0.9
    b: float = 0.4
    prune: bool = True    # searchers serve the compacted pruned path
    bmw: bool = True      # BMW doc-range-overlap bounds (False: MaxScore)
    midgrid: bool = True  # in-grid theta tightening where gates hold
    compact: bool = False  # fused decompress-and-score index layout
    device: object = None  # None: CUDA (raises without one); or "cpu"
    builds: int = 0
    hits: int = 0
    reopens: int = 0
    evictions: int = 0
    _readers: dict = field(default_factory=dict)
    _max_seen: int = -1
    _gen_key: tuple = None
    _generation: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def refresh(self, segs: list, recovery=None) -> IndexSearcher:
        """``recovery`` (a ``storage.RecoveryInfo`` or any object with
        ``quarantined``/``missing_docs``) marks the returned searcher
        degraded: it serves ``segs`` while reporting what is missing."""
        with self._lock:
            have = dict(self._readers)
        by_base = {r.seg.base_id: r for r in have.values()}
        fresh, n_reopened = {}, 0
        for seg in segs:
            if seg.seg_id in have:
                continue
            core = by_base.get(seg.base_id)
            if core is not None:
                fresh[seg.seg_id] = core.reopen(seg)
                n_reopened += 1
            else:
                fresh[seg.seg_id] = SegmentReader.open(
                    seg, self.k1, self.b, compact=self.compact,
                    device=self.device)
        with self._lock:
            self.builds += len(fresh) - n_reopened
            self.reopens += n_reopened
            live, readers = {}, []
            for seg in segs:
                r = self._readers.get(seg.seg_id)
                if r is None:
                    r = fresh.get(seg.seg_id) or have.get(seg.seg_id)
                else:
                    self.hits += 1
                live[seg.seg_id] = r
                readers.append(r)
            snap_max = max(live, default=-1)
            if snap_max >= self._max_seen:
                self._max_seen = snap_max
                self.evictions += len(set(self._readers) - set(live))
                self._readers = live
        quarantined = tuple(sorted(getattr(recovery, "quarantined", ())
                                   or ()))
        missing = int(getattr(recovery, "missing_docs", 0) or 0)
        gen_key = (tuple(sorted(s.seg_id for s in segs)), quarantined,
                   missing)
        with self._lock:
            if gen_key != self._gen_key:
                self._gen_key = gen_key
                self._generation = next(_GENERATIONS)
            generation = self._generation
        return IndexSearcher(readers=readers, k1=self.k1, b=self.b,
                             prune=self.prune, bmw=self.bmw,
                             midgrid=self.midgrid, device=self.device,
                             degraded=bool(quarantined),
                             missing_docs=missing, quarantined=quarantined,
                             generation=generation)

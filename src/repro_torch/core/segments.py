"""Host-side immutable index segments (the flush targets).

A Segment is what one device flushes for its term shard: sorted unique
terms with CSR postings (absolute doc ids + tf), a position stream CSR'd
per posting, per-doc lengths, and the byte accounting the envelope model
charges against the target medium (packed postings + dictionary + parsed
doc vectors + stored docs — the paper stores all of these, §2).

Document lifecycle (Lucene's tombstone model): segments stay immutable
under deletes. A delete produces a NEW segment via ``with_deletes`` — the
postings arrays are shared, only the ``deletes`` bitmap is copied-on-write
— so every cached reader, in-flight merge input and published snapshot
keeps the exact bytes it was built over. ``seg_id`` changes with the
bitmap (readers cache by it), ``base_id`` names the immutable postings
core (so a reader can be *reopened* with a fresh bitmap instead of
rebuilt). Tombstoned docs are physically dropped at merge time
(``core/merge.py`` folds the mask into its scatter).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

import numpy as np

BLOCK = 128

_seg_ids = itertools.count()


def fresh_seg_id() -> int:
    """Next process-unique segment id (for dataclasses.replace-built
    segments, which would otherwise inherit their source's identity)."""
    return next(_seg_ids)


def _np_block_bits(stream: np.ndarray) -> int:
    """Compacted lane-blocked-PFor bit count for a uint32 stream (numpy
    mirror of kernels/postings_pack accounting: 128-blocks, per-block bw)."""
    if stream.size == 0:
        return 0
    n = stream.size
    nb = -(-n // BLOCK)
    padded = np.zeros(nb * BLOCK, np.uint32)
    padded[:n] = stream.astype(np.uint32)
    mx = padded.reshape(nb, BLOCK).max(axis=1)
    bw = np.where(mx > 0, np.floor(np.log2(np.maximum(mx, 1))).astype(np.int64) + 1, 0)
    return int((bw * BLOCK).sum() + nb * 8)  # + per-block 1-byte header


@dataclass
class Segment:
    terms: np.ndarray          # (T,) sorted unique term ids
    term_start: np.ndarray     # (T+1,) CSR into postings
    docs: np.ndarray           # (P,) absolute doc ids, sorted within term
    tf: np.ndarray             # (P,)
    positions: np.ndarray      # (PP,) absolute positions
    pos_start: np.ndarray      # (P+1,) CSR into positions
    doc_ids: np.ndarray        # (D,) absolute doc ids covered
    doc_len: np.ndarray        # (D,)
    generation: int = 0        # merge tier
    # tombstones: None = no deletes; else a (D,) bool mask aligned with
    # doc_ids (True = deleted). Never mutated in place — ``with_deletes``
    # is the only writer and it copies.
    deletes: np.ndarray = None
    # merge-time doc-id reassignment (recursive graph bisection): None =
    # natural order; else a (D,) permutation of LOCAL doc slots,
    # ``reorder[rank] = original local index``. The logical arrays above
    # stay in natural (absolute doc id) order — consumers that lay out
    # blocks (build_block_index) permute the local id space instead, so
    # external doc ids, delete routing and the disjoint-range invariant
    # are untouched.
    reorder: np.ndarray = None
    # process-unique identity: segments are immutable, so readers built from
    # a segment can be cached under this key across refreshes (id() would be
    # reusable after GC and is not safe as a cache key).
    seg_id: int = field(default_factory=fresh_seg_id)
    # identity of the postings CORE (every array except ``deletes``):
    # preserved by ``with_deletes``, fresh everywhere else. A reader whose
    # segment left the live set can be reopened over any segment sharing
    # its base_id — same packed index, new liveness — instead of rebuilt.
    base_id: int = -1

    def __post_init__(self):
        if self.base_id < 0:
            self.base_id = self.seg_id

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_postings(self) -> int:
        return len(self.docs)

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def n_deleted(self) -> int:
        return int(self.deletes.sum()) if self.deletes is not None else 0

    @property
    def live_doc_count(self) -> int:
        return self.n_docs - self.n_deleted

    @property
    def has_deletes(self) -> bool:
        return self.deletes is not None and bool(self.deletes.any())

    def live_doc_ids(self) -> np.ndarray:
        if not self.has_deletes:
            return self.doc_ids
        return self.doc_ids[~self.deletes]

    def with_deletes(self, doc_ids) -> "Segment":
        """Copy-on-write tombstone application.

        Returns a NEW segment (fresh ``seg_id``, same ``base_id``, shared
        postings arrays) whose bitmap additionally marks every id in
        ``doc_ids`` that this segment holds; returns ``self`` unchanged
        when nothing new intersects — callers use identity to detect
        whether anything happened (and reader caches stay warm)."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        if ids.size == 0 or self.n_docs == 0:
            return self
        pos = np.searchsorted(self.doc_ids, ids)
        ok = pos < self.n_docs
        hit = pos[ok][self.doc_ids[pos[ok]] == ids[ok]]
        if hit.size == 0:
            return self
        if self.deletes is not None and bool(self.deletes[hit].all()):
            return self
        mask = (np.zeros(self.n_docs, bool) if self.deletes is None
                else self.deletes.copy())
        mask[hit] = True
        new = replace(self, deletes=mask, seg_id=fresh_seg_id())
        # byte accounting depends only on the shared postings core, so the
        # memoized figures carry over (tombstones cost a separate .liv file,
        # measured by the storage layer, not modeled here)
        for attr in ("_index_bytes_cache", "_total_bytes_cache"):
            cached = getattr(self, attr, None)
            if cached is not None:
                setattr(new, attr, cached)
        return new

    def index_bytes(self) -> dict:
        """Byte accounting of what writing this segment costs (packed).

        Memoized on the instance: segments are immutable, the computation
        is O(P), and the merge cascade consults it several times per
        segment (flush accounting, merge-read accounting, amplification).
        Benign if two threads race — both compute the same value."""
        cached = getattr(self, "_index_bytes_cache", None)
        if cached is None:
            cached = self._compute_index_bytes()
            self._index_bytes_cache = cached
        return dict(cached)

    def _compute_index_bytes(self) -> dict:
        # doc deltas per term (re-deltaed), tf, position deltas
        ddelta = np.diff(self.docs, prepend=0).astype(np.int64)
        firsts = self.term_start[:-1]
        valid_first = firsts[firsts < len(self.docs)]
        ddelta[valid_first] = self.docs[valid_first] + 1
        pdelta = np.diff(self.positions, prepend=0).astype(np.int64)
        pf = self.pos_start[:-1]
        pf = pf[pf < len(self.positions)]
        pdelta[pf] = self.positions[pf] + 1
        postings_bits = _np_block_bits(np.maximum(ddelta, 0)) \
            + _np_block_bits(self.tf) + _np_block_bits(np.maximum(pdelta, 0))
        dict_bytes = self.n_terms * 12  # term id + offset + df
        # parsed doc vectors: (term, tf) pairs per doc ~= postings again
        docvec_bits = _np_block_bits(self.tf) + self.n_postings * 24
        # stored raw docs: ~vbyte of term ids (random-access compression is
        # less efficient than the raw collection's, as the paper notes)
        stored_bytes = int(self.doc_len.sum()) * 2
        return {
            "postings": postings_bits // 8,
            "dictionary": dict_bytes,
            "doc_vectors": docvec_bits // 8,
            "stored_docs": stored_bytes,
        }

    def total_bytes(self) -> int:
        cached = getattr(self, "_total_bytes_cache", None)
        if cached is None:
            cached = sum(self.index_bytes().values())
            self._total_bytes_cache = cached
        return cached


def live_posting_stats(seg: Segment):
    """The one tombstone-folding kernel every consumer shares:
    ``(keep, df_live, kept_before)`` where ``keep`` is the (P,) bool
    live-posting mask (None when the segment has no deletes — callers
    take their fast path), ``df_live`` the per-term LIVE df, and
    ``kept_before`` the exclusive count of kept postings before each
    term's run. The merge scatter, the naive fold oracle and the reader's
    live statistics all derive from these three arrays — one
    implementation keeps them bit-identical by construction."""
    df_full = np.diff(seg.term_start).astype(np.int64)
    if not seg.has_deletes:
        return None, df_full, None
    keep = ~seg.deletes[np.searchsorted(seg.doc_ids, seg.docs)]
    ck = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
    return (keep, ck[seg.term_start[1:]] - ck[seg.term_start[:-1]],
            ck[seg.term_start[:-1]])


def segment_from_run(run_np: dict, doc_ids: np.ndarray,
                     doc_len: np.ndarray) -> Segment:
    """Build a Segment from a (numpy-ified) InvertedRun of one device.

    run_np fields are the InvertedRun arrays; counts select valid prefixes.
    Doc deltas are decoded back to absolute ids (host keeps absolutes;
    packing happens at write accounting / query-index build time).
    """
    n_t = int(run_np["n_terms"])
    n_p = int(run_np["n_postings"])
    n_e = int(run_np["n_entries"])
    terms = run_np["terms_unique"][:n_t].astype(np.int64)
    term_start = np.concatenate([run_np["term_start"][:n_t],
                                 [n_p]]).astype(np.int64)
    ddelta = run_np["postings_doc_delta"][:n_p].astype(np.int64)
    docs = np.cumsum(ddelta)
    firsts = term_start[:-1]
    # re-base each term's run: first delta stored doc+1
    for_first = np.zeros(n_p, bool)
    for_first[firsts[firsts < n_p]] = True
    # docs[i] = first ? delta-1 : prev + delta; vectorized via segment cumsum:
    base = np.zeros(n_p, np.int64)
    base[for_first] = ddelta[for_first] - 1
    vals = np.where(for_first, 0, ddelta)
    grp = np.cumsum(for_first) - 1
    csum = np.cumsum(vals)
    seg_off = np.zeros(max(grp.max() + 1, 1) if n_p else 1, np.int64)
    if n_p:
        starts_idx = np.flatnonzero(for_first)
        seg_off[:len(starts_idx)] = csum[starts_idx] - vals[starts_idx]
        docs = base[starts_idx][grp] + (csum - seg_off[grp])
    tf = run_np["postings_tf"][:n_p].astype(np.int64)
    # positions
    pdelta = run_np["pos_delta"][:n_e].astype(np.int64)
    pos_start = np.concatenate([[0], np.cumsum(tf)])
    pfirst = np.zeros(n_e, bool)
    pfirst[pos_start[:-1][pos_start[:-1] < n_e]] = True
    pbase = np.zeros(n_e, np.int64)
    pbase[pfirst] = pdelta[pfirst] - 1
    pvals = np.where(pfirst, 0, pdelta)
    pgrp = np.cumsum(pfirst) - 1
    pcsum = np.cumsum(pvals)
    if n_e:
        pstarts = np.flatnonzero(pfirst)
        poff = pcsum[pstarts] - pvals[pstarts]
        positions = pbase[pstarts][pgrp] + (pcsum - poff[pgrp])
    else:
        positions = np.zeros(0, np.int64)
    return Segment(terms=terms, term_start=term_start, docs=docs, tf=tf,
                   positions=positions, pos_start=pos_start,
                   doc_ids=doc_ids.astype(np.int64),
                   doc_len=doc_len.astype(np.int64))

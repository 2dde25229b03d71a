"""Hierarchical segment merging (host side).

Lucene merges small per-thread segments into geometrically larger ones
(Lester/Moffat/Zobel geometric partitioning, cited by the paper); every
merge re-reads and re-writes its inputs, which is exactly the write
amplification the envelope model charges to the target medium. The tiered
policy here mirrors Lucene's TieredMergePolicy at ``fanout`` segments per
tier; ``MergeDriver.bytes_written`` divided by the final segment size IS
the measured amplification alpha that calibrates the paper's Table 1.

Two write-path lessons from the paper are implemented here:

* ``merge_segments`` is a streaming O(P) k-way merge. The inputs already
  satisfy two invariants — each segment is sorted by ``(term, doc)`` and
  doc-id spaces are disjoint contiguous ranges — so re-sorting the union
  (the old lexsort) throws information away. Instead, each input's output
  positions are computed with ``np.searchsorted`` on the merged term
  dictionary plus offset arithmetic and the postings/tf/position-runs are
  scattered directly. Tombstoned docs are COMPACTED during that same
  scatter — the live mask is folded into the per-input offset math (kept
  ranks replace ``arange``), no post-hoc filter pass — so a merge output
  never carries deletes. The lexsort implementation survives as
  ``merge_segments_sorted`` (folding deletes naively via ``drop_deleted``
  first), the parity oracle asserted in tests.
* ``ConcurrentMergeScheduler`` (the shape of Lucene's class of the same
  name) runs merges on a background thread pool so ``index_batch``/
  ``_flush`` never wait on a merge — write-write decoupling to match the
  read path's write-read decoupling. The driver stays the single owner of
  tier state: workers *claim* a batch under the driver lock (the batch
  moves from its tier to the in-flight list, so ``live_segments()``
  snapshots stay complete), merge outside the lock, and install the output
  under the lock.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.segments import Segment, fresh_seg_id, live_posting_stats


def _bump_single(seg: Segment) -> Segment:
    """A 1-way "merge": same postings, next generation. Shares the input's
    (immutable) arrays; gets a fresh seg_id because tier accounting treats
    it as a new segment."""
    return replace(seg, generation=seg.generation + 1,
                   seg_id=fresh_seg_id())


def drop_deleted(seg: Segment) -> Segment:
    """Naive tombstone fold: boolean-filter every stream of ``seg`` down to
    its live docs (dictionary terms whose live df hits zero drop out too).

    This is the oracle the compacting scatter in ``merge_segments`` is
    asserted bit-identical against; it is also the production path for
    compacting a LONE segment (a 1-way merge of a deleted-into segment),
    where there is no scatter to fold the mask into. Returns ``seg``
    itself when there is nothing to drop."""
    if not seg.has_deletes:
        return seg
    live = ~seg.deletes
    keep, df_live, _ = live_posting_stats(seg)
    alive_t = df_live > 0
    tf_live = seg.tf[keep]
    return Segment(
        terms=seg.terms[alive_t],
        term_start=np.concatenate(
            [[0], np.cumsum(df_live[alive_t], dtype=np.int64)]),
        docs=seg.docs[keep], tf=tf_live,
        positions=seg.positions[np.repeat(keep, seg.tf)],
        pos_start=np.concatenate([[0], np.cumsum(tf_live, dtype=np.int64)]),
        doc_ids=seg.doc_ids[live], doc_len=seg.doc_len[live],
        generation=seg.generation)


def merge_segments_sorted(segs: list[Segment]) -> Segment:
    """Lexsort-based k-way merge — the original implementation, kept as the
    parity oracle for ``merge_segments`` (asserted bit-identical in
    tests/test_merge.py). Only requires doc-id spaces to be disjoint.
    Tombstones are folded the naive way: each input is filtered down to
    its live docs (``drop_deleted``) before the merge."""
    segs = [drop_deleted(s) for s in segs]
    if len(segs) == 1:
        return _bump_single(segs[0])
    terms = np.concatenate([np.repeat(s.terms, np.diff(s.term_start))
                            for s in segs])
    docs = np.concatenate([s.docs for s in segs])
    tf = np.concatenate([s.tf for s in segs])
    # gather positions runs aligned with postings
    pos_concat = np.concatenate([s.positions for s in segs])
    run_starts = np.concatenate([
        s.pos_start[:-1] + off for s, off in
        zip(segs, np.cumsum([0] + [len(s.positions) for s in segs[:-1]]))])
    order = np.lexsort((docs, terms))
    terms, docs, tf = terms[order], docs[order], tf[order]
    run_starts = run_starts[order]
    # reorder variable-length position runs with the repeat/arange trick
    lens = tf
    total = int(lens.sum())
    if total:
        run_off = np.repeat(np.cumsum(lens) - lens, lens)
        idx = np.repeat(run_starts, lens) + (np.arange(total) - run_off)
        positions = pos_concat[idx]
    else:
        positions = np.zeros(0, np.int64)
    pos_start = np.concatenate([[0], np.cumsum(lens)])
    # term dictionary
    new_term = np.concatenate([[True], terms[1:] != terms[:-1]]) \
        if len(terms) else np.zeros(0, bool)
    uterms = terms[new_term]
    term_start = np.concatenate([np.flatnonzero(new_term), [len(terms)]])
    doc_ids = np.concatenate([s.doc_ids for s in segs])
    doc_len = np.concatenate([s.doc_len for s in segs])
    o = np.argsort(doc_ids)
    return Segment(terms=uterms, term_start=term_start, docs=docs, tf=tf,
                   positions=positions, pos_start=pos_start,
                   doc_ids=doc_ids[o], doc_len=doc_len[o],
                   generation=max(s.generation for s in segs) + 1)


def _tcost(deg: np.ndarray, n: int) -> np.ndarray:
    """Per-term log-gap cost model of the BP objective: a term with
    ``deg`` of its postings inside a partition of ``n`` docs costs
    ``deg * log2(n / (deg + 1))`` bits of expected doc gaps."""
    deg = np.maximum(deg, 0).astype(np.float64)
    return deg * np.log2(max(n, 1) / (deg + 1.0))


def reassign_doc_ids(seg: Segment, max_iters: int = 8,
                     min_partition: int = 128) -> np.ndarray | None:
    """Recursive graph bisection (BP: Dhulipala et al., carried into the
    Pibiri & Venturini compression survey) over the segment's term-doc
    matrix: cluster docs that share terms so per-term posting runs get
    smaller local-id gaps AND skewed per-block impact bounds (similar
    docs land in the same 128-block, so MaxScore prunes the others).

    The adjacency keeps only DISCRIMINATING terms — df >= 2 (singletons
    carry no co-occurrence signal) and df <= n_docs/2 (ubiquitous terms
    split nothing and dominate the posting count) — the standard BP
    degree filter; the permutation still reassigns every doc. Refinement
    passes decay with recursion depth (the top split moves the most
    cost), and recursion stops at the 128-lane block size: permuting
    WITHIN a block cannot change any block statistic.

    Returns a (D,) permutation of LOCAL doc slots — ``perm[rank] = old
    local index`` — or None when the segment is too small to benefit.
    Deterministic: stable sorts everywhere, no RNG."""
    D = seg.n_docs
    if D <= min_partition or seg.n_postings == 0:
        return None
    local = np.searchsorted(seg.doc_ids, seg.docs)
    df = np.diff(seg.term_start)
    tix = np.repeat(np.arange(seg.n_terms), df).astype(np.int64)
    keep = ((df >= 2) & (df <= max(D // 2, 2)))[tix]
    local_k, tix_k = local[keep], tix[keep]
    if local_k.size == 0:
        return None
    by_doc = np.argsort(local_k, kind="stable")
    adj_t = tix_k[by_doc]                   # doc-major term adjacency
    counts = np.bincount(local_k, minlength=D).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    T = seg.n_terms

    def doc_terms(docs):
        """(terms, owner) concatenated adjacency for a doc set."""
        c = counts[docs]
        total = int(c.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        pos = np.arange(total) - np.repeat(np.cumsum(c) - c, c)
        return adj_t[np.repeat(starts[docs], c) + pos], \
            np.repeat(np.arange(len(docs)), c)

    order = np.arange(D)
    stack = [(0, D, 0)]
    while stack:
        lo, hi, depth = stack.pop()
        half = (hi - lo) // 2
        if half == 0:
            continue
        left, right = order[lo:lo + half].copy(), order[lo + half:hi].copy()
        nl, nr = len(left), len(right)
        for _ in range(max(2, max_iters - depth)):
            # rebuild the halves' adjacency each pass: swapped docs must
            # be attributed to their NEW side before the next gain sweep
            tl, ol = doc_terms(left)
            tr, orr = doc_terms(right)
            deg_l = np.bincount(tl, minlength=T).astype(np.int64)
            deg_r = np.bincount(tr, minlength=T).astype(np.int64)
            # per-term gain of moving ONE posting across, both directions
            cost_l, cost_r = _tcost(deg_l, nl), _tcost(deg_r, nr)
            d_l2r = (cost_l + cost_r) \
                - (_tcost(deg_l - 1, nl) + _tcost(deg_r + 1, nr))
            d_r2l = (cost_l + cost_r) \
                - (_tcost(deg_l + 1, nl) + _tcost(deg_r - 1, nr))
            gain_l = np.bincount(ol, weights=d_l2r[tl], minlength=nl)
            gain_r = np.bincount(orr, weights=d_r2l[tr], minlength=nr)
            il = np.argsort(-gain_l, kind="stable")
            ir = np.argsort(-gain_r, kind="stable")
            pair = min(nl, nr)
            swap = gain_l[il[:pair]] + gain_r[ir[:pair]] > 1e-9
            n_swap = int(np.cumprod(swap).sum())  # leading True run only
            if n_swap == 0:
                break
            sl, sr = il[:n_swap], ir[:n_swap]
            left[sl], right[sr] = right[sr].copy(), left[sl].copy()
        order[lo:lo + half], order[lo + half:hi] = left, right
        if half > min_partition:
            stack.append((lo, lo + half, depth + 1))
            stack.append((lo + half, hi, depth + 1))
    return order


def merge_segments(segs: list[Segment], reorder: bool = False) -> Segment:
    """Streaming O(P) k-way merge: exact union of the inputs' LIVE
    postings, bit-identical to ``merge_segments_sorted`` (which folds
    tombstones naively first) but without the O(P log P) re-sort and
    without any separate filter pass.

    Exploited invariants (both hold for every segment the pipeline
    produces — asserted cheaply below):
      * each input is sorted by ``(term, doc)``;
      * doc-id spaces are disjoint contiguous ranges, so once the inputs
        are ordered by their first doc id, concatenating each term's
        per-segment runs in input order is already doc-sorted.

    The merged term dictionary comes from ``np.unique`` over the (small)
    input dictionaries, restricted to terms whose LIVE df is non-zero;
    every surviving posting's output slot is then pure offset arithmetic —
    merged term start + within-term offset of its segment's run + its rank
    *among the kept postings* of the run — and postings scatter straight
    to their slots in one vectorized pass per input. The tombstone mask is
    folded into that index math: the kept-rank (an exclusive cumsum of the
    live mask) replaces the ``arange`` of the append-only path, so
    compaction costs one extra cumsum per input instead of a second pass.
    Position runs never touch an intermediate concatenated stream: each
    input's position array is already ordered by (term, doc), so it
    scatters as contiguous source runs with a single fused
    ``repeat(dst_start - src_start) + arange`` index per input
    (``repeat(a, l) + repeat(b, l) == repeat(a + b, l)``), masked down to
    the kept runs. The output carries no deletes — merging IS compaction.

    ``reorder=True`` additionally runs recursive graph bisection over the
    merge output's term-doc matrix (``reassign_doc_ids``) and attaches
    the resulting LOCAL-slot permutation as metadata: logical arrays —
    and therefore every parity oracle and external doc id — are
    bit-identical to the unreordered merge; only block layout downstream
    (``build_block_index``) consumes the permutation.
    """
    if len(segs) == 1:
        # no scatter to fold the mask into: compact naively, then bump
        merged = _bump_single(drop_deleted(segs[0]))
        if reorder:
            merged = replace(merged, reorder=reassign_doc_ids(merged))
        return merged
    # order inputs by doc range (empty inputs first; they contribute nothing)
    segs = sorted(segs, key=lambda s: int(s.doc_ids[0]) if s.n_docs else -1)
    doc_ids = np.concatenate([s.live_doc_ids() for s in segs])
    assert doc_ids.size < 2 or (np.diff(doc_ids) > 0).all(), \
        "doc-id spaces must be disjoint ordered ranges"
    doc_len = np.concatenate([s.doc_len if not s.has_deletes
                              else s.doc_len[~s.deletes] for s in segs])

    uterms_all = np.unique(np.concatenate([s.terms for s in segs]))
    # merged LIVE df per term; terms whose live df is zero leave the
    # dictionary (their postings all point at tombstoned docs)
    df_all = np.zeros(uterms_all.size, np.int64)
    per_input = []  # (ti into uterms_all, df_full, df_live, keep, kept_before)
    for s in segs:
        ti = np.searchsorted(uterms_all, s.terms)
        df_full = np.diff(s.term_start).astype(np.int64)
        keep, df_live, kept_before = live_posting_stats(s)
        np.add.at(df_all, ti, df_live)
        per_input.append((ti, df_full, df_live, keep, kept_before))
    alive_t = df_all > 0
    uterms = uterms_all[alive_t]
    term_start = np.concatenate([[0], np.cumsum(df_all[alive_t])])
    # old dictionary slot -> compacted slot (dead slots map to a clamped
    # neighbor; they are only ever indexed with a zero-live-df advance)
    remap = np.maximum(np.cumsum(alive_t) - 1, 0)

    P = int(term_start[-1])
    docs = np.empty(P, np.int64)
    tf = np.empty(P, np.int64)
    # within-term write cursor advances as segments are consumed in order
    cursor = term_start[:-1].copy()
    outs = []
    for s, (ti, df_full, df_live, keep, kept_before) in zip(segs, per_input):
        p = s.n_postings
        out = None
        if p and int(df_live.sum()):
            ti = remap[ti]
            starts = cursor[ti]
            live_i = df_live > 0  # ti is injective over these rows
            cursor[ti[live_i]] += df_live[live_i]
            if keep is None:
                # posting j of this input lands at
                #   starts[term(j)] + (j - term_start[term(j)])
                out = np.repeat(starts - s.term_start[:-1], df_full) \
                    + np.arange(p)
                docs[out] = s.docs
                tf[out] = s.tf
            else:
                # kept posting j lands at starts[term(j)] + its rank among
                # the KEPT postings of its run: the exclusive cumsum of the
                # mask replaces arange — dropped slots get garbage values
                # that are never scattered
                excl = np.cumsum(keep, dtype=np.int64) - keep
                out = np.repeat(starts - kept_before, df_full) + excl
                docs[out[keep]] = s.docs[keep]
                tf[out[keep]] = s.tf[keep]
        outs.append((out, keep))
    pos_start = np.concatenate([[0], np.cumsum(tf)]) if P \
        else np.zeros(1, np.int64)
    positions = np.empty(int(pos_start[-1]) if P else 0, np.int64)
    for s, (out, keep) in zip(segs, outs):
        if out is None or not len(s.positions):
            continue
        if keep is None:
            # element m of this input's position stream belongs to its
            # posting j(m); it lands at pos_start[out[j]] + (m - src_start)
            dst = np.repeat(pos_start[:-1][out] - s.pos_start[:-1],
                            s.tf) + np.arange(len(s.positions))
            positions[dst] = s.positions
        else:
            safe_out = np.where(keep, out, 0)
            run_dst = np.where(keep, pos_start[:-1][safe_out], 0)
            elem_keep = np.repeat(keep, s.tf)
            dst = np.repeat(run_dst - s.pos_start[:-1],
                            s.tf) + np.arange(len(s.positions))
            positions[dst[elem_keep]] = s.positions[elem_keep]
    merged = Segment(terms=uterms, term_start=term_start, docs=docs, tf=tf,
                     positions=positions, pos_start=pos_start,
                     doc_ids=doc_ids, doc_len=doc_len,
                     generation=max(s.generation for s in segs) + 1)
    if reorder:
        merged = replace(merged, reorder=reassign_doc_ids(merged))
    return merged


@dataclass(eq=False)
class _MergeWork:
    """One claimed merge: its source tier and the batch pulled from it.
    Identity equality (eq=False) — instances are tracked in lists.
    ``deferred`` collects delete batches that arrived while the merge was
    running: the worker may have read the pre-delete inputs, so they are
    re-applied to the merge output at install time (no delete is ever
    lost mid-merge)."""

    tier: int
    batch: list
    deferred: list = field(default_factory=list)


class MergeRateLimiter:
    """Lucene's ioThrottle shape: background merges pay for their bytes at
    a capped MB/s, sleeping off the debt in bounded slices, so merge IO is
    *spaced out* in wall-clock instead of monopolizing the target device —
    flushes on the same medium always find headroom. The cap applies to a
    merge's re-reads and its output write; flushes are never charged.

    ``max_pause_s`` bounds any single sleep (a giant top-tier merge must
    not stall its worker for minutes at a time); debt beyond the bound is
    forgiven, which makes the cap soft exactly the way Lucene's is."""

    def __init__(self, mb_per_s: float = 50.0, max_pause_s: float = 0.25):
        assert mb_per_s > 0
        self.mb_per_s = mb_per_s
        self.max_pause_s = max_pause_s
        self.paused_s = 0.0       # total wall-clock slept by merge workers
        self.bytes_charged = 0
        self._lock = threading.Lock()

    def charge(self, n_bytes: int) -> float:
        """Charge ``n_bytes`` of merge IO; sleeps this (worker) thread for
        up to ``max_pause_s`` to hold the configured rate. Returns the
        seconds actually slept."""
        with self._lock:
            self.bytes_charged += n_bytes
            pause = min(n_bytes / (self.mb_per_s * 1e6), self.max_pause_s)
        if pause > 1e-4:
            time.sleep(pause)
            with self._lock:
                self.paused_s += pause
            return pause
        return 0.0


@dataclass
class MergeDriver:
    """Tiered merge policy with write-amplification accounting.

    Thread-safety: all tier/counter mutation happens under ``_lock``. A
    merge is *claimed* (``pop_merge_work``: the batch leaves its tier and
    parks in ``_in_flight``), executed lock-free (``merge_segments`` is
    pure), and *installed* (``run_merge`` tail: counters + output segment
    move under the lock). ``live_segments()`` therefore always sees every
    doc exactly once: claimed inputs stay visible until the instant their
    merged output replaces them.
    """

    fanout: int = 10
    # cfg.reorder_on_merge: every merge output additionally gets a BP
    # doc-id reassignment permutation (reassign_doc_ids) — expensive
    # write-path work the read path consumes for free (clustered blocks
    # => harder MaxScore pruning)
    reorder_on_merge: bool = False
    tiers: dict = field(default_factory=dict)
    bytes_written: int = 0      # every segment write (flush + each merge)
    bytes_read_merge: int = 0   # merge re-reads
    n_merges: int = 0
    flushed_bytes: int = 0
    merge_wall_s: float = 0.0   # measured wall-clock inside merge_segments
    scheduler: object = None    # ConcurrentMergeScheduler when attached
    # storage.SegmentStore when the index is durable: every flushed and
    # merged segment is encoded through the target Directory *before* it
    # becomes live, and merges re-read their inputs' files (measured IO)
    store: object = None
    # MergeRateLimiter when merge IO is capped (Lucene's ioThrottle):
    # run_merge charges its measured store reads/writes against it so
    # background merges never monopolize the target device
    io_limiter: object = None
    # doc-id -> segment routing (see apply_deletes): per-holder doc
    # ranges, rebuilt lazily after structural tier changes so a delete
    # touches O(affected segments), not O(live segments)
    route_rebuilds: int = 0
    route_hits: int = 0         # segments whose bitmap a delete swapped
    route_misses: int = 0       # segments skipped by the range probe
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _in_flight: list = field(default_factory=list, repr=False)
    _routes: list = field(default=None, repr=False)

    def add_flush(self, seg: Segment):
        """Account a freshly flushed segment. With a scheduler attached
        this only notifies the background pool (the caller — the ingest
        thread — never merges); without one it cascades synchronously."""
        sz = seg.total_bytes()  # memoized: the O(P) pass stays off the lock
        if self.store is not None:
            # durable write-path: the segment's bytes hit the target medium
            # before the segment is searchable, so a commit taken at any
            # instant only references fully-written files
            self.store.write(seg)
        with self._lock:
            self.bytes_written += sz
            self.flushed_bytes += sz
            self.tiers.setdefault(0, []).append(seg)
            self._routes = None  # a new holder joined the live set
        sched = self.scheduler
        if sched is not None:
            try:
                sched.notify()
                return
            except RuntimeError:
                # pool raced a concurrent close() between the check above
                # and submit; the claim was restored — merge inline instead
                pass
        self._drain_sync()

    @staticmethod
    def _first_doc(seg: Segment) -> int:
        return int(seg.doc_ids[0]) if seg.n_docs else -1

    def _rebuild_routes(self):
        """Doc-id -> segment routing table (callers hold ``_lock``): one
        ``(lo, hi, holder_list, index)`` row per live doc-carrying
        segment, sorted by ``lo``. Disjoint doc ranges make the interval
        set non-overlapping, so membership is one ``searchsorted`` per
        delete batch. Rebuilt lazily: any structural tier change (flush,
        claim, install, restore) just drops the table; delete-only
        workloads between structural changes reuse it, and a
        ``with_deletes`` swap keeps its row valid (same range, same
        position)."""
        routes = []
        holders = list(self.tiers.values()) \
            + [w.batch for w in self._in_flight]
        for segs in holders:
            for i, s in enumerate(segs):
                if s.n_docs:
                    routes.append((int(s.doc_ids[0]), int(s.doc_ids[-1]),
                                   segs, i))
        routes.sort(key=lambda r: r[0])
        self._routes = routes
        self.route_rebuilds += 1

    def apply_deletes(self, doc_ids) -> int:
        """Route tombstones to every live holder of the targeted docs.

        The doc-id -> segment routing table narrows the walk to segments
        whose doc range intersects the batch (one sorted-interval probe
        per segment range; disjoint doc spaces make ranges disjoint too),
        so a delete costs O(affected segments) ``with_deletes`` scans
        instead of O(live segments) — unaffected segments are never
        touched and keep their ``seg_id`` (no spurious reader-cache
        invalidation).

        Affected tier-resident segments are swapped for their
        ``with_deletes`` copies (shared postings, fresh seg_id — reader
        caches invalidate by key; the store, when attached, re-keys the
        on-disk name). In-flight merge inputs are swapped too, because
        snapshots include them — AND the ids are recorded on the claim:
        the merge worker may already have read the old objects, so
        ``run_merge`` re-applies the deferred ids to its output at
        install. Either way no delete is lost mid-merge, and any snapshot
        taken after this call returns excludes the docs. Returns how many
        segments changed."""
        ids = np.unique(np.asarray(doc_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        changed = 0
        with self._lock:
            if self._routes is None:
                self._rebuild_routes()
            for lo, hi, segs, i in self._routes:
                # any target inside [lo, hi]? ids is sorted: probe the
                # first id >= lo and check it against hi
                p = int(np.searchsorted(ids, lo))
                if p >= ids.size or ids[p] > hi:
                    self.route_misses += 1
                    continue
                s = segs[i]
                ns = s.with_deletes(ids)
                if ns is not s:
                    self.route_hits += 1
                    segs[i] = ns
                    changed += 1
                    if self.store is not None:
                        self.store.relabel(s, ns)
            for w in self._in_flight:
                w.deferred.append(ids)
        return changed

    def pop_merge_work(self) -> _MergeWork | None:
        """Claim the smallest eligible merge, or None.

        Size-proportional selection: among every tier holding >= ``fanout``
        segments, candidate batches are the tier's doc-range-consecutive
        windows of ``fanout`` segments, and the window with the smallest
        summed bytes across all tiers is claimed first (ties go to the
        lower tier). A worker that would previously have queued behind one
        huge pending merge now clears the cheap ones first, so large
        merges never starve small ones.

        Doc-space safety: merging a batch whose doc-id span contains some
        OTHER segment's docs would create a segment whose doc range
        interleaves with the bystander's, and a later merge of the two
        would violate ``merge_segments``' disjoint-ordered-ranges
        invariant. So a window ABSORBS every tier-resident bystander
        inside its span into the batch (a cross-tier, doc-consecutive
        merge — the output lands one tier above the highest input, and no
        segment is ever stranded behind a higher-tier barrier), while a
        window spanning an *in-flight* batch is simply not claimable yet.

        Delete-aware tie-break: at equal byte size, the window with the
        highest tombstone ratio is claimed first — merging it reclaims
        more dead bytes for the same IO (the update-heavy regime's
        compaction dividend), and only then do ties fall to the lower
        tier.

        ``total_bytes`` is memoized on the (immutable) segments, so the
        selection under the lock is O(segments^2), not O(postings). The
        claimed batch moves from its tier(s) to ``_in_flight`` so it
        stays searchable."""
        with self._lock:
            # disjoint doc spaces => "first doc inside the span" is
            # exactly "some docs inside the span"
            inflight_firsts = [self._first_doc(s) for w in self._in_flight
                               for s in w.batch if s.n_docs]
            # best key: (batch_bytes, -tombstone_ratio, out_tier)
            best = None  # (key, _, tier, seg_id set of the batch)
            for tier, segs in self.tiers.items():
                if len(segs) < self.fanout:
                    continue
                order = sorted(range(len(segs)),
                               key=lambda i: self._first_doc(segs[i]))
                for w in range(len(segs) - self.fanout + 1):
                    take = [segs[i] for i in order[w:w + self.fanout]]
                    docked = [s for s in take if s.n_docs]
                    absorb = []
                    if docked:
                        lo = self._first_doc(docked[0])
                        hi = int(docked[-1].doc_ids[-1])
                        if any(lo < f <= hi for f in inflight_firsts):
                            continue  # span swallows an in-flight merge
                        member = {s.seg_id for s in take}
                        absorb = [s for t2 in self.tiers.values()
                                  for s in t2
                                  if s.seg_id not in member and s.n_docs
                                  and lo < self._first_doc(s) <= hi]
                    batch = take + absorb
                    size = sum(s.total_bytes() for s in batch)
                    n_doc = sum(s.n_docs for s in batch)
                    tomb = (sum(s.n_deleted for s in batch) / n_doc
                            if n_doc else 0.0)
                    out_tier = max([tier] + [self._seg_tier(s)
                                             for s in absorb])
                    key = (size, -tomb, out_tier)
                    if best is None or key < best[0]:
                        best = (key, None, out_tier,
                                {s.seg_id for s in batch})
            if best is None:
                return None
            tier, taken = best[2], best[3]
            batch = []
            for t2 in self.tiers:
                keep = []
                for s in self.tiers[t2]:
                    (batch if s.seg_id in taken else keep).append(s)
                self.tiers[t2] = keep
            batch.sort(key=self._first_doc)
            work = _MergeWork(tier, batch)
            self._in_flight.append(work)
            self._routes = None  # tier lists were rebuilt
            return work

    def _seg_tier(self, seg: Segment) -> int:
        """Tier currently holding ``seg`` (callers hold ``_lock``)."""
        for t, segs in self.tiers.items():
            if any(s.seg_id == seg.seg_id for s in segs):
                return t
        return 0

    def run_merge(self, work: _MergeWork) -> Segment:
        """Execute one claimed merge and install its output (callable from
        any thread; the expensive part runs outside the lock)."""
        t0 = time.perf_counter()
        try:
            # keyword only when the knob is on: tests monkeypatch
            # merge_segments with stubs that take the positional form
            merged = merge_segments(work.batch, reorder=True) \
                if self.reorder_on_merge else merge_segments(work.batch)
            dt = time.perf_counter() - t0
            # memoized byte accounting: off the lock and off the timer
            # (merge_wall_s measures the merge itself, not its accounting)
            merged.total_bytes()
            if self.store is not None:
                # a durable merge re-reads its inputs from the target and
                # writes its output there before installing it (measured
                # counterparts of bytes_read_merge / bytes_written);
                # with an io_limiter the bytes are paid at a capped rate
                n_read = self.store.read_back(work.batch)
                name = self.store.write(merged)
                if self.io_limiter is not None:
                    self.io_limiter.charge(n_read
                                           + self.store.size_of(name))
        except BaseException:
            self.restore_work(work)  # no doc may ever go missing
            raise
        with self._lock:
            self._in_flight.remove(work)
            # deletes that arrived mid-merge: the worker may have read the
            # pre-delete inputs, so fold the deferred ids into the output
            # before it becomes live (idempotent when the merge saw them)
            for ids in work.deferred:
                nm = merged.with_deletes(ids)
                if nm is not merged and self.store is not None:
                    self.store.relabel(merged, nm)
                merged = nm
            self.bytes_read_merge += sum(s.total_bytes() for s in work.batch)
            self.bytes_written += merged.total_bytes()
            self.n_merges += 1
            self.merge_wall_s += dt
            self.tiers.setdefault(work.tier + 1, []).append(merged)
            self._routes = None  # inputs left, the output joined
        if self.store is not None:
            # inputs have now left the live set permanently: their files
            # become delete-eligible at the next commit (never before —
            # a commit snapshot taken pre-install still references them)
            self.store.mark_superseded(work.batch)
        return merged

    def expunge_deletes(self, min_ratio: float = 0.0) -> Segment | None:
        """Lucene's ``expungeDeletes`` shape: rewrite the single
        churn-heaviest live segment — the tier-resident segment with the
        highest tombstone ratio strictly above ``min_ratio`` — WITHOUT a
        force-merge. The segment is claimed as a 1-way ``_MergeWork`` at
        ``tier - 1`` so ``run_merge``'s install-at-``work.tier + 1`` puts
        the compacted rewrite back on the segment's own tier; the 1-way
        merge path (``drop_deleted`` + bump) does the compaction, and the
        normal merge machinery supplies store IO accounting, IO
        throttling, deferred mid-rewrite deletes and supersede marking
        for free. Returns the compacted segment, or None when no segment
        qualifies."""
        with self._lock:
            best = None
            for tier, segs in self.tiers.items():
                for i, s in enumerate(segs):
                    if not s.n_docs or not s.n_deleted:
                        continue
                    ratio = s.n_deleted / s.n_docs
                    if ratio > min_ratio and (best is None
                                              or ratio > best[0]):
                        best = (ratio, tier, i)
            if best is None:
                return None
            _, tier, i = best
            seg = self.tiers[tier].pop(i)
            work = _MergeWork(tier - 1, [seg])
            self._in_flight.append(work)
            self._routes = None
        return self.run_merge(work)

    def restore_work(self, work: _MergeWork):
        """Un-claim a merge that could not run: its batch goes back to the
        front of its tier, staying claimable and searchable."""
        with self._lock:
            self._in_flight.remove(work)
            self.tiers.setdefault(work.tier, [])[:0] = work.batch
            self._routes = None

    def _drain_sync(self):
        while (work := self.pop_merge_work()) is not None:
            self.run_merge(work)

    def live_segments(self) -> list[Segment]:
        """Snapshot of the current searchable segment set, largest tier
        first. Doc-id spaces are disjoint by construction (each flush covers
        a distinct doc range; merges union their inputs), so a searcher can
        evaluate them independently and merge top-k. The returned segments
        are immutable — later flushes/merges produce *new* Segment objects,
        leaving this snapshot valid (write-read decoupling). Batches of
        in-flight merges are included (their outputs are not installed
        yet), so every doc appears exactly once at any instant."""
        with self._lock:
            tiers = {w.tier for w in self._in_flight} | set(self.tiers)
            segs = []
            for t in sorted(tiers, reverse=True):
                for w in self._in_flight:
                    if w.tier == t:
                        segs.extend(w.batch)
                segs.extend(self.tiers.get(t, []))
            return segs

    def finalize(self) -> Segment:
        """Force-merge everything into one segment (the paper's end state).
        Drains the scheduler first, so in-flight cascades land before the
        final merge tree is built."""
        if self.scheduler is not None:
            self.scheduler.drain()
        self._drain_sync()  # any tier that filled right at the end
        while True:
            with self._lock:
                assert not self._in_flight
                remaining = [s for t in sorted(self.tiers)
                             for s in self.tiers[t]]
                assert remaining, "nothing indexed"
                # batch in doc-range order: every force-merge batch is a
                # doc-consecutive window, so intermediate outputs never
                # interleave with segments still waiting in ``keep``
                remaining.sort(key=self._first_doc)
                if len(remaining) == 1 and not remaining[0].has_deletes:
                    # the paper's end state is COMPACTED: a lone segment
                    # still carrying tombstones takes one more (1-way)
                    # merge through the loop below to fold them away
                    self.tiers = {0: remaining}
                    self._routes = None
                    return remaining[0]
                batch = remaining[:self.fanout]
                top = max(self.tiers)
                keep = remaining[self.fanout:]
                self.tiers = {0: keep} if keep else {}
                self._routes = None
                work = _MergeWork(top, batch)
                self._in_flight.append(work)
            self.run_merge(work)

    def snapshot(self) -> dict:
        """All counters read atomically (a background merge installing
        mid-read would otherwise tear e.g. bytes_written vs
        bytes_read_merge by one merge)."""
        with self._lock:
            live = [s for t in self.tiers.values() for s in t]
            live += [s for w in self._in_flight for s in w.batch]
            final = sum(s.total_bytes() for s in live)
            return {
                "bytes_written": self.bytes_written,
                "bytes_read_merge": self.bytes_read_merge,
                "flushed_bytes": self.flushed_bytes,
                "n_merges": self.n_merges,
                "merge_wall_s": self.merge_wall_s,
                "live_docs": sum(s.live_doc_count for s in live),
                "deleted_docs": sum(s.n_deleted for s in live),
                "merge_io_paused_s": (self.io_limiter.paused_s
                                      if self.io_limiter else 0.0),
                # THE index-size figure: the modeled (packed, pre-codec)
                # bytes of the live segment set. Everything downstream
                # (amplification here, envelope_report's raw-vs-encoded
                # split) derives from this one number.
                "live_bytes_raw": final,
                "amplification": self.bytes_written / max(final, 1),
            }

    def amplification(self) -> float:
        return self.snapshot()["amplification"]


class MergeRetriesExhausted(RuntimeError):
    """A merge batch kept failing past the retry policy's cap — typed so
    callers can tell a dead merge path from a first-strike error. The
    final underlying failure is chained as ``__cause__``."""

    def __init__(self, batch_key, attempts: int, cause: BaseException):
        super().__init__(f"merge of batch {batch_key} failed after "
                         f"{attempts} attempts: {cause}")
        self.batch_key = batch_key
        self.attempts = attempts
        self.__cause__ = cause


class ConcurrentMergeScheduler:
    """Background merge execution, mirroring Lucene's scheduler of the same
    name: ingest threads only *enqueue* merge pressure; a small thread pool
    claims batches from the ``MergeDriver`` and runs them concurrently.

    Lifecycle: constructing the scheduler attaches it to the driver
    (``driver.scheduler = self``); ``notify()`` (called by ``add_flush``)
    claims every currently-available merge and submits it; each completed
    merge re-notifies, so cascades propagate tier by tier without the
    ingest thread ever blocking. ``drain()`` blocks until no merge is
    pending or in flight (used by ``finalize`` and tests); ``close()``
    drains, detaches, and shuts the pool down.

    Worker exceptions are captured keyed by the claimed batch (a failed
    merge must not be silently dropped — its inputs go back to their tier)
    and re-raised from the next ``drain()``. A later *successful* merge of
    the same batch clears its recorded error: transient failures self-heal
    instead of raising stale on a healthy index; persistent failures keep
    raising.

    With a ``retry_policy`` (``storage.RetryPolicy``), a faulted merge is
    *re-enqueued* with capped exponential backoff instead of parking its
    error: the failed run already restored its inputs to their tier, so a
    delayed ``notify`` simply re-claims the batch. Only after the cap is
    exhausted does a typed ``MergeRetriesExhausted`` (chaining the last
    failure) land in the error map for ``drain`` to raise. A success at
    any attempt clears the batch's attempt count.
    """

    def __init__(self, driver: MergeDriver, max_threads: int = 2,
                 retry_policy=None):
        self.driver = driver
        self.max_threads = max_threads
        self.retry_policy = retry_policy
        self.pool = ThreadPoolExecutor(max_workers=max_threads,
                                       thread_name_prefix="merge")
        self._cv = threading.Condition()
        self._pending = {}          # future -> _MergeWork, not yet done
        self._errors = {}           # batch key -> exception
        self._attempts = {}         # batch key -> failed attempts so far
        self._retry_timers = 0      # backoff timers not yet fired
        self.submitted = 0
        self.merge_retries = 0      # backoff re-enqueues issued
        self.peak_pending = 0
        driver.scheduler = self

    @staticmethod
    def _key(work: _MergeWork):
        # base_id, not seg_id: a delete landing mid-merge swaps the batch
        # entries for with_deletes copies (new seg_ids, same cores), and a
        # retried batch must still clear its recorded error
        return tuple(sorted(s.base_id for s in work.batch))

    def notify(self):
        """Claim and submit every merge the driver currently has ready."""
        while (work := self.driver.pop_merge_work()) is not None:
            try:
                with self._cv:
                    fut = self.pool.submit(self.driver.run_merge, work)
                    self._pending[fut] = work
                    self.submitted += 1
                    self.peak_pending = max(self.peak_pending,
                                            len(self._pending))
            except BaseException:
                # submit can fail (pool racing shutdown): un-claim so the
                # batch is neither lost nor stuck in _in_flight
                self.driver.restore_work(work)
                raise
            fut.add_done_callback(self._done)

    def _done(self, fut):
        exc = fut.exception()
        with self._cv:
            work = self._pending.pop(fut, None)
            if work is not None:
                key = self._key(work)
                if exc is None:
                    self._errors.pop(key, None)  # retry healed
                    self._attempts.pop(key, None)
                elif self.retry_policy is not None:
                    attempts = self._attempts.get(key, 0) + 1
                    self._attempts[key] = attempts
                    if attempts <= self.retry_policy.max_retries:
                        # inputs are already back in their tier (run_merge
                        # restores on failure): re-claim after backoff
                        t = threading.Timer(
                            self.retry_policy.delay(attempts),
                            self._retry_fire)
                        t.daemon = True
                        self._retry_timers += 1
                        self.merge_retries += 1
                        t.start()
                    else:
                        self._errors[key] = MergeRetriesExhausted(
                            key, attempts, exc)
                else:
                    self._errors[key] = exc
        if exc is None:
            self.notify()   # the installed output may have filled a tier
        with self._cv:
            self._cv.notify_all()

    def _retry_fire(self):
        with self._cv:
            self._retry_timers -= 1
            self._cv.notify_all()
        try:
            self.notify()
        except BaseException:
            # pool racing shutdown: notify's guard restored the claim, so
            # the batch stays in its tier for a synchronous finalize
            pass

    def drain(self):
        """Block until every pending and in-flight merge has completed
        (and the cascades they trigger), then re-raise the first still-
        pending worker error. Raising only after quiescing means callers
        observe a settled driver (nothing pending or in flight, failed
        inputs restored to their tiers); each drain retries a failed batch
        at most once more via its leading ``notify``."""
        while True:
            self.notify()
            with self._cv:
                while self._pending or self._retry_timers:
                    self._cv.wait(0.1)
                if self._errors:
                    raise self._errors.pop(next(iter(self._errors)))
            with self.driver._lock:
                busy = bool(self.driver._in_flight)
                ready = any(len(v) >= self.driver.fanout
                            for v in self.driver.tiers.values())
            if not busy and not ready:
                break

    def close(self):
        try:
            self.drain()
        finally:  # release threads/detach even when drain re-raises;
            # detach FIRST so a racing add_flush falls back to synchronous
            # merging instead of submitting to a closed pool
            if self.driver.scheduler is self:
                self.driver.scheduler = None
            self.pool.shutdown(wait=True)

"""Indexing driver in PyTorch: the single-process (``mesh=None``) path of
the JAX package's ``core/indexer.py``.

Doc batches accumulate in the in-memory buffer (``FlushPolicy``); a flush
inverts the buffer on the device (``core.invert``), builds a host
``Segment`` and feeds the tiered ``MergeDriver``. ``refresh()`` snapshots
the live segment set into an ``IndexSearcher`` without force-merging
(near-real-time search while indexing), reusing cached readers.

Document lifecycle: ``delete(doc_ids)`` tombstones docs and
``update(doc_id, doc)`` is delete + re-add under the flush lock. Deletes
are buffered and folded into the live segment set at the next
flush/refresh, so every snapshot taken after the call returns excludes
them; merges drop tombstoned postings physically.

Durable storage (``repro_torch.storage``): with ``target_dir`` every
flushed and merged segment is encoded into that ``Directory`` (its
``pfor`` streams through the pack kernel), ``commit()`` publishes durable
commit points, and constructing over a non-empty directory RESUMES from
its latest commit (recovery, with the ``pfor`` streams through the unpack
kernel). ``wal=True`` logs every acked add/delete before the call returns
and replays the log on recovery. A ``ChecksumScrubber`` re-verifies
committed frames (``scrub_every`` > 0 runs it as a daemon thread, stopped
by ``close()``).

Merges run synchronously inside the flush. Not ported yet (each raises
``NotImplementedError`` naming ``ROADMAP.md``): background merges
(``merge_threads``, ``merge_io_mbps``), the NRT refresh daemon, the
replication publisher, the multi-device mesh step and
``envelope_report``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.flush import FlushPolicy
from repro_torch.core.invert import invert_shard
from repro_torch.core.merge import (MergeDriver, MergeRateLimiter,
                                    reassign_doc_ids)
from repro_torch.core.searcher import IndexSearcher, ReaderCache
from repro_torch.core.segments import Segment, segment_from_run
from repro_torch.data.corpus import iter_spooled
from repro_torch.device import resolve_device
from repro_torch.storage.commit import RecoveryInfo, SegmentStore
from repro_torch.storage.directory import CachingDirectory
from repro_torch.storage.retry import RetryingDirectory
from repro_torch.storage.scrub import (ChecksumScrubber,
                                       throttle_saturation_gate)
from repro_torch.storage.wal import (WriteAheadLog, encode_wal_add,
                                     encode_wal_delete)


def _later_slice(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, Queue 1")


@dataclass
class IndexStats:
    docs: int = 0
    tokens: int = 0
    read_bytes: int = 0
    flushed_bytes: int = 0
    wall_s: float = 0.0
    refreshes: int = 0
    last_refresh_s: float = 0.0
    deletes: int = 0    # acknowledged delete ids (incl. updates' deletes)
    updates: int = 0


@dataclass
class Indexer:
    """Host driver: device inversion + flush/merge + NRT refresh, and the
    durable write path when ``target_dir`` is set.

    ``device`` None runs on CUDA (and raises without a CUDA device);
    ``"cpu"`` runs the plain PyTorch path on the host. Segment encodes,
    recovery decodes and reader builds all run on it."""

    cfg: object
    device: object = None
    mesh: object = None
    stats: IndexStats = field(default_factory=IndexStats)
    merger: MergeDriver = None
    reader_cache: ReaderCache = None
    searcher: IndexSearcher = None   # latest refreshed snapshot
    # first doc id this writer allocates (doc-range sharding); recovery
    # resumes from max(committed max + 1, doc_base)
    doc_base: int = 0
    # durable storage: every flushed/merged segment is encoded into
    # target_dir and ``commit()`` publishes commit points; constructing
    # over a non-empty directory resumes from its latest commit.
    # source_dir holds the spooled source collection (index_spooled).
    target_dir: object = None
    source_dir: object = None
    store: SegmentStore = None
    # wal=True: every acked add/delete is logged + synced before the call
    # returns, replayed on recovery and truncated at commit. None: take
    # cfg.wal. Needs target_dir. wal_group=True coalesces concurrent
    # ackers' syncs into one (group commit); None: take cfg.wal_group.
    wal: bool = None
    wal_group: bool = None
    # a storage.RetryPolicy: target_dir is wrapped in a RetryingDirectory
    retry_policy: object = None
    # > 0: a ChecksumScrubber daemon re-verifies committed frames every
    # this many seconds (scrub_io_mbps caps its read rate). The scrubber
    # exists (for manual ``sweep()``) whenever target_dir is set. None:
    # take cfg.scrub_every / cfg.scrub_io_mbps.
    scrub_every: float = None
    scrub_io_mbps: float = None
    # recover a partially-corrupt newest commit minus its quarantined
    # segments (degraded) instead of falling back
    degraded_ok: bool = False
    scrubber: ChecksumScrubber = None
    # later slices of the port
    merge_threads: int = None
    refresh_every: float = None
    publisher: object = None
    _postings_cache: object = None   # CachingDirectory when configured
    _next_doc: int = 0
    _wal: WriteAheadLog = None
    _wal_covered: int = -1     # highest wal seq whose ops are flushed
    _wal_replaying: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None:
            raise _later_slice("the multi-device mesh indexing step")
        if (self.refresh_every or getattr(self.cfg, "refresh_every", 0.0)):
            raise _later_slice("the NRT refresh daemon (refresh_every)")
        if (self.merge_threads or getattr(self.cfg, "merge_threads", 0)
                or getattr(self.cfg, "merge_io_mbps", 0.0)):
            raise _later_slice("background merges (merge_threads, "
                               "merge_io_mbps)")
        if self.publisher is not None:
            raise _later_slice("the replication publisher")
        self.merger = MergeDriver(
            fanout=self.cfg.merge_fanout,
            reorder_on_merge=getattr(self.cfg, "reorder_on_merge", False))
        if self.target_dir is not None:
            self._open_target()
        self._next_doc = max(self._next_doc, self.doc_base)
        self.reader_cache = ReaderCache(device=self.device)
        self._flush_policy = FlushPolicy(budget_mb=self.cfg.flush_budget_mb)
        # serializes the flush buffer handoff + doc-id allocation
        self._flush_lock = threading.RLock()
        # acknowledged-but-unapplied delete ids, drained at flush
        self._buffered_deletes = np.zeros(0, np.int64)
        if self.wal is None:
            self.wal = bool(getattr(self.cfg, "wal", False))
        if self.wal_group is None:
            self.wal_group = bool(getattr(self.cfg, "wal_group", False))
        if self.wal and self.target_dir is not None:
            self._wal = WriteAheadLog(
                self.target_dir,
                rotate_bytes=int(float(getattr(self.cfg, "wal_rotate_mb",
                                               0.0) or 0.0) * 1e6),
                recycle_keep=int(getattr(self.cfg, "wal_recycle", 0) or 0))
            self._wal_covered = -1
            self._replay_wal()
        if self.scrub_every is None:
            self.scrub_every = getattr(self.cfg, "scrub_every", 0.0)
        if self.scrub_io_mbps is None:
            self.scrub_io_mbps = getattr(self.cfg, "scrub_io_mbps", 0.0)
        if self.target_dir is not None:
            self._start_scrubber()

    def _open_target(self):
        """Stack the target directory (retries, then the postings cache
        above the whole media stack), then recover the store from its
        latest commit: recovered segments rejoin their merge tier and new
        doc ids continue after the committed max. Their bytes are
        credited as prior writes (one write each: the original run's
        merge history is gone)."""
        if self.retry_policy is not None and not isinstance(
                self.target_dir, RetryingDirectory):
            self.target_dir = RetryingDirectory(self.target_dir,
                                                self.retry_policy)
        cache_mb = float(getattr(self.cfg, "postings_cache_mb", 0.0) or 0.0)
        if cache_mb > 0:
            self.target_dir = CachingDirectory(
                self.target_dir, cap_bytes=int(cache_mb * 1e6))
            self._postings_cache = self.target_dir
        self.store, recovered = SegmentStore.open(
            self.target_dir, codec=getattr(self.cfg, "codec", "pfor"),
            degraded=self.degraded_ok, device=self.device)
        self.merger.store = self.store
        for seg in recovered:
            sz = seg.total_bytes()
            self.merger.bytes_written += sz
            self.merger.flushed_bytes += sz
            self.merger.tiers.setdefault(seg.generation, []).append(seg)
        tops = [int(s.doc_ids.max()) for s in recovered if s.n_docs]
        if tops:
            self._next_doc = max(tops) + 1

    def _start_scrubber(self):
        """The checksum scrubber over the media stack below the postings
        cache (cached blocks must not mask on-media bit rot). When the
        stack carries a ``DeviceThrottle``, periodic sweeps defer while
        ingest saturates the device."""
        limiter = (MergeRateLimiter(self.scrub_io_mbps)
                   if self.scrub_io_mbps else None)
        gate, d = None, self.target_dir
        while d is not None:
            thr = getattr(d, "throttle", None)
            if thr is not None:
                gate = throttle_saturation_gate(thr)
                break
            d = getattr(d, "inner", None)
        scrub_dir = (self._postings_cache.inner
                     if self._postings_cache is not None
                     else self.target_dir)
        self.scrubber = ChecksumScrubber(
            scrub_dir, store=self.store, limiter=limiter,
            interval_s=self.scrub_every or 0.0, contention=gate)
        self.scrubber.start()   # no-op unless scrub_every > 0

    def _replay_wal(self):
        """Re-apply every readable WAL record through the normal ingest
        paths, in sequence order: ``_next_doc`` resumed from the committed
        max and replay order equals ack order, so every acked doc
        reappears under its original id. Torn records (never acked) are
        skipped and counted by the log."""
        self._wal_replaying = True
        try:
            for _seq, op, payload in self._wal.replay():
                if op == "add":
                    self.index_batch(payload)
                else:
                    self.delete(payload)
        finally:
            self._wal_replaying = False

    def index_batch(self, tokens: np.ndarray):
        """tokens: (D, L) int32 host buffer. Accumulates in the in-memory
        buffer; flushes a segment when the flush budget fills. Returns the
        flushed segment or None.

        With the WAL the batch is logged + synced before any state
        changes, so a return means the docs survive a kill. With
        ``wal_group`` the sync runs after the lock is released,
        coalescing with concurrent ackers; the return still waits for
        it."""
        seq, out = None, None
        with self._flush_lock:
            if self._wal is not None and not self._wal_replaying:
                seq = self._wal.append(encode_wal_add(tokens),
                                       sync=not self.wal_group)
            self.stats.docs += tokens.shape[0]
            self.stats.tokens += int((tokens > 0).sum())
            self.stats.read_bytes += tokens.nbytes
            if self._flush_policy.add(tokens):
                out = self._flush_locked()
        if seq is not None and self.wal_group:
            self._wal.sync_upto(seq)
        return out

    def delete(self, doc_ids) -> int:
        """Tombstone ``doc_ids`` (absolute ids, any shape); folded into the
        live segment set at the next flush/refresh/commit (logged first
        with the WAL). Returns the ids acknowledged."""
        ids = np.unique(np.asarray(doc_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        seq = None
        with self._flush_lock:
            if self._wal is not None and not self._wal_replaying:
                seq = self._wal.append(encode_wal_delete(ids),
                                       sync=not self.wal_group)
            self._buffered_deletes = np.union1d(self._buffered_deletes, ids)
            self.stats.deletes += int(ids.size)
        if seq is not None and self.wal_group:
            self._wal.sync_upto(seq)
        return int(ids.size)

    def update(self, doc_id: int, doc: np.ndarray):
        """Replace one document: tombstone ``doc_id`` and buffer ``doc``
        as a new document (fresh id at flush); both surface together at
        the next flush/refresh."""
        doc = np.asarray(doc, np.int32)
        if doc.ndim == 1:
            doc = doc[None]
        assert doc.shape[0] == 1, "update replaces exactly one document"
        with self._flush_lock:
            self.delete([doc_id])
            self.stats.updates += 1
            return self.index_batch(doc)

    def _apply_deletes_locked(self, drain: bool):
        """Fold buffered deletes into the live segment set (callers hold
        ``_flush_lock``); drain only when no target can still be in the
        token buffer."""
        ids = self._buffered_deletes
        if not ids.size:
            return
        self.merger.apply_deletes(ids)
        if drain:
            self._buffered_deletes = np.zeros(0, np.int64)
        elif self._flush_policy.pending_docs == 0:
            self._buffered_deletes = ids[ids >= self._next_doc]

    def _flush(self):
        with self._flush_lock:
            return self._flush_locked()

    def _invert(self, tokens: np.ndarray, base: int) -> dict:
        """Invert one buffer on the device; ship the valid prefixes of the
        run's arrays to the host."""
        run = invert_shard(torch.from_numpy(np.ascontiguousarray(
            tokens, np.int32)).to(self.device), base)
        n_e, n_p, n_t = (int(x) for x in torch.stack(
            [run.n_entries, run.n_postings, run.n_terms]).tolist())
        prefix = {"postings_term": n_p, "postings_doc_delta": n_p,
                  "postings_tf": n_p, "pos_delta": n_e,
                  "terms_unique": n_t, "term_start": n_t}
        out = {k: getattr(run, k)[:n].cpu().numpy()
               for k, n in prefix.items()}
        out.update(n_entries=n_e, n_postings=n_p, n_terms=n_t,
                   doc_len=run.doc_len.cpu().numpy())
        return out

    def _flush_locked(self):
        if self._flush_policy.pending_docs == 0:
            self._apply_deletes_locked(drain=True)
            if self._wal is not None:
                # nothing buffered: every logged op is in the live set
                self._wal_covered = self._wal.next_seq - 1
            return None
        t0 = time.time()
        tokens = self._flush_policy.take()
        D = tokens.shape[0]
        base = self._next_doc
        self._next_doc += D
        run_np = self._invert(tokens, base)
        seg = segment_from_run(run_np, np.arange(base, base + D),
                               run_np["doc_len"])
        if getattr(self.cfg, "reorder_on_flush", False):
            perm = reassign_doc_ids(seg)
            if perm is not None:
                seg = replace(seg, reorder=perm)
        self.merger.add_flush(seg)
        # deletes land WITH the flush (after it, so deletes targeting docs
        # in this very buffer hit the segment they just became)
        self._apply_deletes_locked(drain=True)
        if self._wal is not None:
            # every record appended before this flush (same lock) is now
            # in flushed segments + applied deletes: the next commit makes
            # them durable and may truncate them
            self._wal_covered = self._wal.next_seq - 1
        self.stats.flushed_bytes += seg.total_bytes()
        self.stats.wall_s += time.time() - t0
        return seg

    def index_spooled(self, directory=None) -> int:
        """Stream the spooled source collection (``data.corpus`` batches
        written through a source ``Directory``) into the index. Returns
        the docs indexed."""
        directory = directory if directory is not None else self.source_dir
        if directory is None:
            raise ValueError("index_spooled needs a source_dir")
        n = 0
        for _, tokens in iter_spooled(directory):
            self.index_batch(tokens)
            n += tokens.shape[0]
        return n

    def commit(self, flush: bool = True) -> int:
        """Durable commit point: flush buffered docs and deletes, then
        publish the live segment set as ``segments_N`` (``.liv`` delete
        generations first, two-phase manifest rename), delete superseded
        files and truncate the WAL records the commit covers. Returns the
        new commit generation."""
        if self.store is None:
            raise ValueError("commit() requires target_dir")
        with self._flush_lock:
            if flush:
                self._flush_locked()
            else:
                self._apply_deletes_locked(drain=False)
            covered = self._wal_covered
        gen = self.store.commit(self.merger.live_segments())
        if self._wal is not None and covered >= 0:
            # only once the commit is durable are its records disposable
            self._wal.truncate_upto(covered)
        return gen

    def envelope_report(self) -> dict:
        raise _later_slice("envelope_report (core/envelope.py)")

    def finalize(self) -> Segment:
        """Force-merge to the paper's single-segment end state, committed
        durably when a target ``Directory`` is attached."""
        self._flush()
        with self._flush_lock:
            covered = self._wal_covered
        final = self.merger.finalize()
        if self.store is not None:
            self.store.commit(self.merger.live_segments())
            if self._wal is not None and covered >= 0:
                self._wal.truncate_upto(covered)
        return final

    def close(self):
        """Stop the scrubber daemon (join; re-raises what it died of).
        Merges are synchronous, so no pool needs releasing."""
        if self.scrubber is not None:
            scrubber, self.scrubber = self.scrubber, None
            scrubber.close()

    def refresh(self, flush: bool = True) -> IndexSearcher:
        """Near-real-time snapshot over ``MergeDriver.live_segments()``:
        flushes the buffer first (``flush=False`` snapshots only flushed
        segments); buffered deletes are folded in either way."""
        with self._flush_lock:
            if flush:
                self._flush_locked()
            else:
                self._apply_deletes_locked(drain=False)
        t0 = time.time()
        recovery = None
        if self.store is not None and self.store.quarantined:
            recovery = RecoveryInfo(
                quarantined=dict(self.store.quarantined))
        searcher = self.reader_cache.refresh(self.merger.live_segments(),
                                             recovery=recovery)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.refreshes += 1
        self.stats.last_refresh_s = time.time() - t0
        self.searcher = searcher
        return searcher

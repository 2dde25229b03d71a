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

Merges run synchronously inside the flush unless ``merge_threads`` > 0:
then a ``ConcurrentMergeScheduler`` runs them on that many worker threads
(failed merges retried ``merge_retries`` times), paced by a
``MergeRateLimiter`` at ``merge_io_mbps``. With ``refresh_every`` > 0 a
daemon thread refreshes ``self.searcher`` at that period (flush=False) and
calls the ``on_refresh`` hooks; ``attach_serving`` registers a
``QueryScheduler``'s ``swap_searcher`` there. ``close()`` stops the daemon,
the scrubber and the merge pool.

``envelope_report()`` charges the measured bytes to the ``source`` ->
``target`` media pair of ``core/envelope.py`` (modeled seconds in the
paper's media units) and, with ``target_dir``, adds what the source and
target ``Directory`` stacks measured (bytes, and throttle device time).

With a ``publisher`` (``replication.CommitPublisher``) every durable
commit (``commit()``, ``finalize()``) is announced to it, and
``envelope_report()`` grows its ``fleet`` section.

Not ported yet (raises ``NotImplementedError`` naming ``ROADMAP.md``):
the multi-device mesh step.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core import envelope as env
from repro_torch.core.flush import FlushPolicy
from repro_torch.core.invert import invert_shard
from repro_torch.core.merge import (ConcurrentMergeScheduler, MergeDriver,
                                    MergeRateLimiter, reassign_doc_ids)
from repro_torch.core.query import PruneStats
from repro_torch.core.searcher import (IndexSearcher, ReaderCache,
                                       evaluator_cache_hits)
from repro_torch.core.segments import Segment, segment_from_run
from repro_torch.data.corpus import iter_spooled
from repro_torch.device import resolve_device
from repro_torch.storage.commit import RecoveryInfo, SegmentStore
from repro_torch.storage.directory import CachingDirectory
from repro_torch.storage.retry import RetryingDirectory, RetryPolicy
from repro_torch.storage.scrub import (ChecksumScrubber,
                                       throttle_saturation_gate)
from repro_torch.storage.wal import (WriteAheadLog, encode_wal_add,
                                     encode_wal_delete)

# the model parameters envelope_report charges the media pair with
_ENVELOPE_PARAMS = env.EnvelopeParams()


def _later_slice(what: str, item: str = None) -> NotImplementedError:
    """The error of a path still to port, naming its ``ROADMAP.md`` item."""
    where = "ROADMAP.md, Queue 1" + (f", {item}" if item else "")
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {where}")


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
    """Host driver: device inversion + flush/merge + NRT refresh with
    envelope accounting, and the durable write path when ``target_dir``
    is set.

    ``device`` None runs on CUDA (and raises without a CUDA device);
    ``"cpu"`` runs the plain PyTorch path on the host. Segment encodes,
    recovery decodes and reader builds all run on it."""

    cfg: object
    device: object = None
    # the media pair envelope_report charges (core/envelope.py MEDIA keys)
    source: str = "ceph"
    target: str = "ssd"
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
    # > 0: merges run on a ConcurrentMergeScheduler with that many worker
    # threads, so index_batch never waits on a cascade; 0: synchronous
    # merges inside the flush. None: take cfg.merge_threads.
    merge_threads: int = None
    merge_scheduler: ConcurrentMergeScheduler = None
    # > 0: background-merge IO is paced at this MB/s. None: take
    # cfg.merge_io_mbps; 0 disables.
    merge_io_mbps: float = None
    # > 0: a faulted background merge is retried with backoff this many
    # times before MergeRetriesExhausted. None: take cfg.merge_retries.
    merge_retries: int = None
    # > 0: a daemon thread refreshes ``self.searcher`` at this period (s).
    # None: take cfg.refresh_every; 0 disables. Stopped by ``close()``.
    refresh_every: float = None
    # callables given the fresh searcher after every ``refresh``
    # (``attach_serving`` registers a scheduler's ``swap_searcher``)
    on_refresh: list = None
    serving: object = None     # attached QueryScheduler (report source)
    # a replication.CommitPublisher told of every durable commit
    publisher: object = None
    _postings_cache: object = None   # CachingDirectory when configured
    _next_doc: int = 0
    _wal: WriteAheadLog = None
    _wal_covered: int = -1     # highest wal seq whose ops are flushed
    _wal_replaying: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None:
            raise _later_slice("the multi-device mesh indexing step",
                              "item 3, the multi-device slice")
        self.merger = MergeDriver(
            fanout=self.cfg.merge_fanout,
            reorder_on_merge=getattr(self.cfg, "reorder_on_merge", False))
        if self.on_refresh is None:
            self.on_refresh = []
        if self.target_dir is not None:
            self._open_target()
        self._next_doc = max(self._next_doc, self.doc_base)
        self._start_merges()
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
        if self.refresh_every is None:
            self.refresh_every = getattr(self.cfg, "refresh_every", 0.0)
        self._stop_refresh = threading.Event()
        self._refresh_error = None
        self._refresh_thread = None
        if self.refresh_every and self.refresh_every > 0:
            self._refresh_thread = threading.Thread(
                target=self._refresh_daemon, name="nrt-refresh", daemon=True)
            self._refresh_thread.start()

    def _start_merges(self):
        """Background merges (``merge_threads`` > 0, with the retry policy
        when ``merge_retries`` > 0) and the merge IO limiter."""
        if self.merge_threads is None:
            self.merge_threads = getattr(self.cfg, "merge_threads", 0)
        if self.merge_retries is None:
            self.merge_retries = getattr(self.cfg, "merge_retries", 0)
        if self.merge_threads:
            policy = None
            if self.merge_retries:
                policy = RetryPolicy(max_retries=self.merge_retries,
                                     base_delay_s=0.01, max_delay_s=0.25)
            self.merge_scheduler = ConcurrentMergeScheduler(
                self.merger, max_threads=self.merge_threads,
                retry_policy=policy)
        if self.merge_io_mbps is None:
            self.merge_io_mbps = getattr(self.cfg, "merge_io_mbps", 0.0)
        if self.merge_io_mbps:
            self.merger.io_limiter = MergeRateLimiter(self.merge_io_mbps)

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
        if self.publisher is not None:
            self.publisher.on_commit(gen)   # shippable to replicas now
        return gen

    def finalize(self) -> Segment:
        """Force-merge to the paper's single-segment end state, committed
        durably when a target ``Directory`` is attached. With background
        merges this first drains the cascades in flight (inside
        ``MergeDriver.finalize``); the scheduler stays usable."""
        self._flush()
        with self._flush_lock:
            covered = self._wal_covered
        final = self.merger.finalize()
        if self.store is not None:
            gen = self.store.commit(self.merger.live_segments())
            if self._wal is not None and covered >= 0:
                self._wal.truncate_upto(covered)
            if self.publisher is not None:
                self.publisher.on_commit(gen)
        return final

    def close(self):
        """Stop the NRT refresh daemon (join), the scrubber daemon and the
        background merge pool (no-op when merges are synchronous). An error
        the refresh or scrub thread died of is re-raised here, after all
        three are stopped."""
        err = None
        try:
            if self._refresh_thread is not None:
                self._stop_refresh.set()
                self._refresh_thread.join(timeout=30)
                if self._refresh_thread.is_alive():
                    raise RuntimeError("refresh daemon failed to stop")
                self._refresh_thread = None
                err, self._refresh_error = self._refresh_error, None
        finally:
            try:
                if self.scrubber is not None:
                    scrubber, self.scrubber = self.scrubber, None
                    scrubber.close()   # re-raises a scrub-thread error
            finally:
                if self.merge_scheduler is not None:
                    sched, self.merge_scheduler = self.merge_scheduler, None
                    sched.close()
        if err is not None:
            raise err

    def _refresh_daemon(self):
        """The daemon thread: an error ends it and ``close()`` re-raises
        it (nothing falls back; the serving side keeps the last
        snapshot until then)."""
        try:
            self._refresh_loop()
        except Exception as e:
            self._refresh_error = e

    def _refresh_loop(self):
        """Swap ``self.searcher`` to a fresh snapshot every
        ``refresh_every`` seconds until ``close()`` (flush=False: the
        ingest thread owns flushing; buffered deletes are folded in all
        the same)."""
        while not self._stop_refresh.wait(self.refresh_every):
            self.refresh(flush=False)

    def refresh(self, flush: bool = True) -> IndexSearcher:
        """Near-real-time snapshot over ``MergeDriver.live_segments()``:
        flushes the buffer first (``flush=False`` snapshots only flushed
        segments); buffered deletes are folded in either way. The reader
        builds are synchronized on the device, so ``last_refresh_s`` is
        the time to searchable; then the ``on_refresh`` hooks get the new
        searcher."""
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
        self.searcher = searcher   # the (atomic) NRT swap
        # a new generation keys result caches: the swap is the exact
        # invalidation event
        for cb in (self.on_refresh or ()):
            cb(searcher)
        return searcher

    def attach_serving(self, scheduler) -> None:
        """Wire a ``QueryScheduler`` into this writer: every ``refresh``
        swaps the fresh searcher in, and ``envelope_report`` grows the
        ``serve_*`` counters (and ``result_cache`` with a cache)."""
        self.serving = scheduler
        self.on_refresh.append(scheduler.swap_searcher)
        if self.searcher is not None \
                and scheduler.searcher is not self.searcher:
            scheduler.swap_searcher(self.searcher)


    def envelope_report(self) -> dict:
        """Charge the measured bytes to the ``source`` -> ``target`` media
        pair (modeled seconds and GB/min in the paper's media units), next
        to the merge, lifecycle, pruning, storage and serving counters;
        with ``target_dir`` also what the Directory stacks measured
        (``_measured_report``). The same keys as the JAX package's
        ``DistributedIndexer.envelope_report``."""
        src, tgt = env.MEDIA[self.source], env.MEDIA[self.target]
        params = _ENVELOPE_PARAMS
        G = self.stats.read_bytes
        merge = self.merger.snapshot()  # atomic vs in-flight merge installs
        W = merge["bytes_written"]
        t_read = G / (src.read_bw * env.GB)
        t_write = W / (tgt.write_bw * env.GB)
        t_cpu = (G / env.GB) * params.c_idx / params.n_cores
        if self.source == self.target:
            t_io = (G + W) / (tgt.write_bw * env.GB) * params.interference
            total = max(t_io, t_cpu)
            bound = "shared-io" if t_io >= t_cpu else "cpu"
        else:
            total = max(t_read, t_cpu, t_write)
            bound = ["read", "cpu", "write"][int(np.argmax(
                [t_read, t_cpu, t_write]))]
        # what the model charges the cascade (re-reads from the target +
        # merge re-writes) next to the wall clock the merges took
        merge_writes = W - merge["flushed_bytes"]
        t_merge_modeled = (merge["bytes_read_merge"] / (tgt.read_bw * env.GB)
                           + merge_writes / (tgt.write_bw * env.GB))
        report = {
            "alpha_measured": merge["amplification"],
            "bytes_read": G, "bytes_written": W,
            "t_read_s": t_read, "t_cpu_s": t_cpu, "t_write_s": t_write,
            "modeled_total_s": total, "bound": bound,
            "gb_per_min_modeled": (G / env.GB) / max(total / 60, 1e-9),
            "docs_per_s_modeled": self.stats.docs / max(total, 1e-9),
            "n_merges": merge["n_merges"],
            "wall_s_host": self.stats.wall_s,
            "t_merge_modeled_s": t_merge_modeled,
            "merge_wall_s": merge["merge_wall_s"],
            "merge_io_paused_s": merge["merge_io_paused_s"],
            "live_docs": merge["live_docs"],
            "deleted_docs": merge["deleted_docs"],
            "deletes_acked": self.stats.deletes,
            "updates_acked": self.stats.updates,
            "merge_concurrency": (self.merge_scheduler.max_threads
                                  if self.merge_scheduler else 0),
            "index_bytes_raw": merge["live_bytes_raw"],
            "index_bytes_encoded": 0,
        }
        # serving-side pruning counters of the latest refreshed searcher
        ps = getattr(self.searcher, "prune_stats", None) or PruneStats()
        report.update({
            "blocks_candidate": ps.blocks_candidate,
            "blocks_survived": ps.blocks_survived,
            "blocks_scored": ps.blocks_scored,
            "segments_skipped": ps.segments_skipped,
            "prune_skip_rate": ps.skip_rate,
            "terms_eliminated": ps.terms_eliminated,
            "blocks_skipped_midgrid": ps.blocks_skipped_midgrid,
            "evaluator_cache_hits": evaluator_cache_hits(),
        })
        if self.store is not None:
            q = dict(self.store.quarantined)
            report.update({
                "degraded": bool(q),
                "missing_docs": sum(int(v or 0) for v in q.values()),
                "segments_quarantined": len(q),
                "segments_healed": self.store.heals,
            })
        else:
            report.update({
                "degraded": bool(getattr(self.searcher, "degraded", False)),
                "missing_docs": int(getattr(self.searcher, "missing_docs", 0)
                                    or 0),
                "segments_quarantined": len(getattr(self.searcher,
                                                    "quarantined", ()) or ()),
            })
        if self._wal is not None:
            w = self._wal
            report.update({"wal_appends": w.appended,
                           "wal_replayed": w.replayed,
                           "wal_skipped": w.skipped,
                           "wal_group_commits": w.group_commits,
                           "wal_group_acks": w.group_acks,
                           "wal_group_max": w.group_max,
                           "wal_rotations": w.rotations,
                           "wal_recycled": w.recycled,
                           "wal_recycle_reused": w.recycle_reused,
                           "wal_recycle_reclaimed": w.recycle_reclaimed})
        if self.scrubber is not None:
            report.update({f"scrub_{k}": v
                           for k, v in self.scrubber.report().items()
                           if k != "corrupt"})
        d = self.target_dir   # the retry layer may sit under the cache
        while d is not None:
            if hasattr(d, "retries"):
                report["io_retries"] = d.retries
                report["io_giveups"] = d.giveups
                break
            d = getattr(d, "inner", None)
        if self.merge_scheduler is not None:
            report["merge_retries"] = self.merge_scheduler.merge_retries
        if self._postings_cache is not None:
            pc = self._postings_cache
            report.update({
                "postings_cache_hits": pc.cache_hits,
                "postings_cache_misses": pc.cache_misses,
                "postings_cache_evictions": pc.cache_evictions,
                "postings_cache_rejected": pc.cache_rejected,
                "postings_cache_bytes": pc.cache_bytes,
            })
        if self.serving is not None:
            s = self.serving
            report.update({
                "serve_served": s.served,
                "serve_cached": s.served_cached,
                "serve_rejected": s.rejected,
                "serve_steps": s.steps,
                "serve_partial_steps": s.partial_steps,
                "serve_queue_depth": s.queue_depth,
                "serve_degraded": s.degraded,
            })
            if s.cache is not None:
                report["result_cache"] = s.cache.report()
        if self.publisher is not None:
            report["fleet"] = self.publisher.report()
        if self.store is not None:
            report.update(self._measured_report())
        return report

    def _measured_report(self) -> dict:
        """The measured counterpart of the model: bytes that crossed the
        source and target Directories and the device time their throttles
        accumulated (wall time when unthrottled). One throttle behind both
        is one shared device: its timeline already sums both streams."""
        live = self.merger.live_segments()
        src_dir, tgt_dir = self.source_dir, self.target_dir
        src_thr = getattr(src_dir, "throttle", None)
        tgt_thr = getattr(tgt_dir, "throttle", None)
        G_m = src_dir.bytes_read if src_dir is not None \
            else self.stats.read_bytes
        t_src = (src_thr.busy_read_s if src_thr is not None
                 else src_dir.read_wall_s if src_dir is not None else 0.0)
        t_tgt = (tgt_thr.busy_s if tgt_thr is not None
                 else tgt_dir.write_wall_s + tgt_dir.read_wall_s)
        shared = src_thr is not None and src_thr is tgt_thr
        t_io = src_thr.busy_s if shared else max(t_src, t_tgt)
        t_env = max(t_io, self.stats.wall_s)
        return {
            "bytes_read_measured": G_m,
            "bytes_written_measured": tgt_dir.bytes_written,
            "bytes_read_merge_measured": self.store.bytes_encoded_read,
            "index_bytes_encoded": self.store.encoded_bytes_live(live),
            "codec": self.store.codec,
            "index_bytes_by_file": self.store.encoded_bytes_by_suffix(live),
            "t_source_busy_s": t_src,
            "t_target_busy_s": t_tgt,
            "t_io_measured_s": t_io,
            "shared_media_measured": shared,
            "t_envelope_measured_s": t_env,
            "gb_per_min_measured": (G_m / env.GB) / max(t_io / 60, 1e-12),
        }

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

Merges run synchronously inside the flush. Not ported yet (each raises
``NotImplementedError`` naming ``ROADMAP.md``): durable storage
(``target_dir``, commits, the WAL, the scrubber), background merges
(``merge_threads``, ``merge_io_mbps``), the NRT refresh daemon, the
multi-device mesh step and ``envelope_report``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.flush import FlushPolicy
from repro_torch.core.invert import invert_shard
from repro_torch.core.merge import MergeDriver, reassign_doc_ids
from repro_torch.core.searcher import IndexSearcher, ReaderCache
from repro_torch.core.segments import Segment, segment_from_run
from repro_torch.device import resolve_device


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
    """Host driver: device inversion + flush/merge + NRT refresh.

    ``device`` None runs on CUDA (and raises without a CUDA device);
    ``"cpu"`` runs the plain PyTorch path on the host."""

    cfg: object
    device: object = None
    mesh: object = None
    stats: IndexStats = field(default_factory=IndexStats)
    merger: MergeDriver = None
    reader_cache: ReaderCache = None
    searcher: IndexSearcher = None   # latest refreshed snapshot
    # first doc id this writer allocates (doc-range sharding)
    doc_base: int = 0
    # later slices of the port
    merge_threads: int = None
    target_dir: object = None
    source_dir: object = None
    wal: bool = None
    refresh_every: float = None
    scrub_every: float = None
    _next_doc: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None:
            raise _later_slice("the multi-device mesh indexing step")
        if self.target_dir is not None or self.source_dir is not None:
            raise _later_slice("durable storage (target_dir/source_dir)")
        if self.wal or getattr(self.cfg, "wal", False):
            raise _later_slice("the write-ahead log")
        if (self.refresh_every or getattr(self.cfg, "refresh_every", 0.0)):
            raise _later_slice("the NRT refresh daemon (refresh_every)")
        if (self.scrub_every or getattr(self.cfg, "scrub_every", 0.0)):
            raise _later_slice("the checksum scrubber")
        if (self.merge_threads or getattr(self.cfg, "merge_threads", 0)
                or getattr(self.cfg, "merge_io_mbps", 0.0)):
            raise _later_slice("background merges (merge_threads, "
                               "merge_io_mbps)")
        self.merger = MergeDriver(
            fanout=self.cfg.merge_fanout,
            reorder_on_merge=getattr(self.cfg, "reorder_on_merge", False))
        self._next_doc = max(self._next_doc, self.doc_base)
        self.reader_cache = ReaderCache(device=self.device)
        self._flush_policy = FlushPolicy(budget_mb=self.cfg.flush_budget_mb)
        # serializes the flush buffer handoff + doc-id allocation
        self._flush_lock = threading.RLock()
        # acknowledged-but-unapplied delete ids, drained at flush
        self._buffered_deletes = np.zeros(0, np.int64)

    def index_batch(self, tokens: np.ndarray):
        """tokens: (D, L) int32 host buffer. Accumulates in the in-memory
        buffer; flushes a segment when the flush budget fills. Returns the
        flushed segment or None."""
        with self._flush_lock:
            self.stats.docs += tokens.shape[0]
            self.stats.tokens += int((tokens > 0).sum())
            self.stats.read_bytes += tokens.nbytes
            if self._flush_policy.add(tokens):
                return self._flush_locked()
        return None

    def delete(self, doc_ids) -> int:
        """Tombstone ``doc_ids`` (absolute ids, any shape); folded into the
        live segment set at the next flush/refresh. Returns the ids
        acknowledged."""
        ids = np.unique(np.asarray(doc_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        with self._flush_lock:
            self._buffered_deletes = np.union1d(self._buffered_deletes, ids)
            self.stats.deletes += int(ids.size)
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
        self.stats.flushed_bytes += seg.total_bytes()
        self.stats.wall_s += time.time() - t0
        return seg

    def commit(self, flush: bool = True) -> int:
        raise _later_slice("durable commits")

    def index_spooled(self, directory=None) -> int:
        raise _later_slice("spooled source collections")

    def envelope_report(self) -> dict:
        raise _later_slice("envelope_report (core/envelope.py)")

    def finalize(self) -> Segment:
        """Force-merge to the paper's single-segment end state."""
        self._flush()
        return self.merger.finalize()

    def close(self):
        """No-op: synchronous merges hold no pool to release."""

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
        searcher = self.reader_cache.refresh(self.merger.live_segments())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.refreshes += 1
        self.stats.last_refresh_s = time.time() - t0
        self.searcher = searcher
        return searcher

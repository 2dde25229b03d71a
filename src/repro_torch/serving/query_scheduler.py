"""Batched BM25 query scheduler (copied from the JAX package's
``serving/query_scheduler.py``; it is host logic over an
``IndexSearcher``): fixed-slot continuous batching for the
read path, mirroring ``DecodeScheduler``'s serving shape.

Fixed ``slots`` query slots, queries padded to ``max_terms`` terms with -1
(a term id absent from every segment, so pad lanes contribute nothing).
Every step drains up to ``slots`` requests from the queue into one
fixed-shape ``IndexSearcher.search_batched`` call.

Continuous batching (the steady-state serving contract): instead of
blocking until ``slots`` requests have queued, ``maybe_step`` launches a
*partially filled* batch once the oldest waiting request has aged past
``max_wait_ms`` — the launch rule every production continuous-batching
server uses, because at moderate load the wait-for-full policy puts the
full inter-arrival gap of ``slots`` requests into every tail latency.
Partial batches are padded to the next power-of-two slot count
(``_bucket``), so the searcher sees at most log2(slots)+1 batch shapes,
not one per occupancy. ``full_batch=True`` retains the old wait-for-full
policy as the parity oracle: per-query evaluation is independent of
batch composition (theta0 seeds are per-query, pad lanes contribute
nothing), so both policies return bit-identical per-request results —
asserted in tests, measured (p99) in the ``serve_steady`` bench.

Result caching: with a ``cache`` attached (``serving/steady.py``'s
``ResultCache``), ``submit`` first looks up ``(query bytes, k)`` under
the searcher's ``generation``. Generations bump exactly when a refresh
swaps in a snapshot with different live contents, so a hit replays a
result computed on an identical snapshot — bit-identical by
construction, never stale. Generation 0 (an unkeyed snapshot) disables
caching rather than risking a collision.

Admission control: ``admit_cap`` bounds the queue. A submit past the
bound raises ``Overloaded`` (typed, counted in ``rejected``) instead of
queueing — shedding keeps the latency of *admitted* queries bounded past
saturation, where an unbounded queue's p99 grows without limit. Callers
see an explicit rejection, never a wrong or partial answer.

The searcher serves through the compacted pruned path by default; the
scheduler folds every served batch's ``PruneStats`` into its own totals,
surviving searcher swaps (``launch/serve.py`` and ``envelope_report``
read it). ``swap_searcher`` installs a fresh ``IndexSearcher`` from the
indexer's ``refresh()`` between steps: serving continues against the old
snapshot until the swap, which is the write-read decoupling contract.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.query import PruneStats
from repro_torch.device import resolve_device


class Overloaded(RuntimeError):
    """Typed admission rejection: the serving queue is at ``admit_cap``.

    The request was NOT enqueued and will never complete; callers retry
    elsewhere / later. Raised instead of queueing so p99 over admitted
    traffic stays bounded past saturation."""


@dataclass
class QueryRequest:
    rid: int
    terms: np.ndarray           # (q,) int32 query term ids
    k: int = 10
    scores: np.ndarray = None   # (k,) filled on completion
    doc_ids: np.ndarray = None  # (k,) absolute doc ids
    done: bool = False
    cached: bool = False        # served from the result cache
    t_submit: float = 0.0       # arrival timestamp (driver-provided or now)
    t_done: float = 0.0         # completion timestamp


def _bucket(n: int, cap: int) -> int:
    """Next power-of-two >= n, capped at ``cap`` — the compiled batch
    shapes stay log2-bounded regardless of instantaneous occupancy."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


@dataclass
class QueryScheduler:
    searcher: object            # IndexSearcher snapshot being served
    slots: int = 32
    max_terms: int = 8
    k: int = 10
    # continuous batching: launch a partial batch once the oldest waiter
    # is older than this; full_batch=True restores wait-for-full (parity
    # oracle + the bench's baseline policy)
    max_wait_ms: float = 2.0
    full_batch: bool = False
    # admission control: 0 = unbounded queue (no shedding)
    admit_cap: int = 0
    # result cache (duck-typed: get(key)/put(key, value); see
    # serving/steady.py::ResultCache). None = no caching.
    cache: object = None
    queue: list = field(default_factory=list)
    served: int = 0
    served_cached: int = 0      # submits answered straight from the cache
    rejected: int = 0           # submits shed with Overloaded
    steps: int = 0
    partial_steps: int = 0      # steps launched below full occupancy
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _stats_acc: PruneStats = field(default_factory=PruneStats)
    _stats_mark: PruneStats = None   # searcher counters at attach time
    # None: CUDA (raises without one); "cpu" serves a CPU searcher
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._check_device(self.searcher)
        self._mark_searcher()

    def _check_device(self, searcher):
        dev = getattr(searcher, "device", None)
        if dev is not None and torch.device(dev) != self.device:
            raise ValueError(f"searcher on {dev}, scheduler on "
                             f"{self.device}")

    def _mark_searcher(self):
        ps = getattr(self.searcher, "prune_stats", None)
        self._stats_mark = ps.snapshot() if ps is not None else None

    @property
    def degraded(self) -> bool:
        """True when the snapshot being served was recovered minus
        quarantined segments — traffic keeps flowing, but callers (and
        the replica router) can see this node is incomplete."""
        return bool(getattr(self.searcher, "degraded", False))

    @property
    def missing_docs(self) -> int:
        """Committed docs absent from the snapshot being served."""
        return int(getattr(self.searcher, "missing_docs", 0) or 0)

    @property
    def generation(self):
        """The served snapshot's result-cache key (0 = uncacheable)."""
        return getattr(self.searcher, "generation", 0)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self.queue)

    @property
    def prune_stats(self) -> PruneStats:
        """Pruning counters for everything THIS scheduler served: batches
        accumulated across searcher swaps plus the current searcher's
        delta since it was attached (a searcher shared with direct
        ``search`` callers only contributes what the scheduler drove)."""
        total = self._stats_acc.snapshot()
        ps = getattr(self.searcher, "prune_stats", None)
        if ps is not None and self._stats_mark is not None:
            total.add(ps.delta(self._stats_mark))
        return total

    def _cache_key(self, req: QueryRequest):
        return (np.asarray(req.terms, np.int32).tobytes(), self.k)

    def submit(self, req: QueryRequest, now: float = None):
        """Admit one request: answered instantly on a result-cache hit,
        queued otherwise, or shed with ``Overloaded`` past ``admit_cap``.
        ``now`` stamps ``t_submit`` (the open-loop driver passes the
        intended arrival time so measured latency includes queue wait)."""
        if len(req.terms) > self.max_terms:
            raise ValueError(
                f"query {req.rid}: {len(req.terms)} terms exceeds the "
                f"scheduler's fixed shape (max_terms={self.max_terms})")
        if req.k > self.k:
            raise ValueError(
                f"query {req.rid}: k={req.k} exceeds the scheduler's "
                f"fixed shape (k={self.k})")
        req.t_submit = time.perf_counter() if now is None else now
        gen = self.generation
        if self.cache is not None and gen:
            hit = self.cache.get((self._cache_key(req), gen))
            if hit is not None:
                vals, ids = hit
                kk = min(req.k, self.k)
                req.scores, req.doc_ids = vals[:kk], ids[:kk]
                req.cached = req.done = True
                req.t_done = time.perf_counter() if now is None else now
                with self._lock:
                    self.served_cached += 1
                return req
        with self._lock:
            if self.admit_cap and len(self.queue) >= self.admit_cap:
                self.rejected += 1
                raise Overloaded(
                    f"query {req.rid}: admission queue at cap "
                    f"({self.admit_cap}); shed to keep served p99 bounded")
            self.queue.append(req)
        return req

    def swap_searcher(self, searcher):
        """Install a fresher snapshot (from ``Indexer.refresh``);
        takes effect from the next step. The outgoing searcher's pruning
        delta is folded into the scheduler totals first. Cached results
        of older generations become unreachable by key — exact
        invalidation without a flush."""
        self._check_device(searcher)
        ps = getattr(self.searcher, "prune_stats", None)
        if ps is not None and self._stats_mark is not None:
            self._stats_acc.add(ps.delta(self._stats_mark))
        self.searcher = searcher
        self._mark_searcher()

    def ready(self, now: float = None) -> bool:
        """Launch rule: a full batch always; a partial batch only once
        the oldest waiter has aged past ``max_wait_ms`` (and never under
        ``full_batch``, the wait-for-full parity oracle)."""
        with self._lock:
            if not self.queue:
                return False
            if len(self.queue) >= self.slots:
                return True
            if self.full_batch:
                return False
            now = time.perf_counter() if now is None else now
            return (now - self.queue[0].t_submit) * 1e3 >= self.max_wait_ms

    def maybe_step(self, now: float = None):
        """Continuous-batching poll: serve one batch if the launch rule
        says so, else do nothing (returns [])."""
        if not self.ready(now):
            return []
        return self.step()

    def step(self):
        """Serve one batch from the queue; returns finished requests
        (every admitted request finishes in its step). Partial batches
        pad to the next pow2 slot bucket; per-query results are
        independent of batch composition, so occupancy never changes
        what any request gets back."""
        with self._lock:
            if not self.queue:
                return []
            batch = self.queue[:self.slots]
            del self.queue[:len(batch)]
        B = self.slots if self.full_batch else _bucket(len(batch),
                                                       self.slots)
        q = np.full((B, self.max_terms), -1, np.int32)
        for i, req in enumerate(batch):
            t = np.asarray(req.terms, np.int32)
            q[i, :len(t)] = t
        # one capture: results and cache key come from the same searcher
        # object. An IndexSearcher is an immutable snapshot, so the key
        # is exact by construction; a FleetSearcher is mutable, so the
        # key is re-read after serving and a change (a replica synced
        # mid-batch) vetoes the cache fill.
        searcher = self.searcher
        gen = getattr(searcher, "generation", 0)
        vals, ids = searcher.search_batched(q, self.k)
        vals, ids = np.asarray(vals.cpu()), np.asarray(ids.cpu())
        t_done = time.perf_counter()
        cacheable = (self.cache is not None and gen
                     and getattr(searcher, "generation", 0) == gen)
        for i, req in enumerate(batch):
            if cacheable:
                self.cache.put((self._cache_key(req), gen),
                               (vals[i].copy(), ids[i].copy()))
            kk = min(req.k, self.k)
            req.scores, req.doc_ids = vals[i, :kk], ids[i, :kk]
            req.done = True
            req.t_done = t_done
        with self._lock:
            self.served += len(batch)
            self.steps += 1
            if len(batch) < self.slots:
                self.partial_steps += 1
        return batch

    def run_to_completion(self, max_steps: int = 10_000):
        """Drain the queue regardless of the launch rule (end-of-stream
        flush; also the whole serving loop for offline callers)."""
        out = []
        for _ in range(max_steps):
            out += self.step()
            with self._lock:
                empty = not self.queue
            if empty:
                break
        return out

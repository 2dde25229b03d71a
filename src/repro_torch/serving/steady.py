"""Steady-state serving: open-loop load driver + generation-keyed cache
(the port's copy of the JAX package's ``serving/steady.py``, over the
port's ``QueryScheduler``).

Every other benchmark in this repo is CLOSED-loop: time a batch, repeat —
the next query waits for the previous answer, so a slow server slows the
*offered* load and tail latency self-flatters. Production traffic is
OPEN-loop: arrivals are a process the server does not control, a slow
server grows a queue, and the number that matters is tail latency at a
sustained QPS while ingest/delete churn runs concurrently. This module
is that harness:

``run_open_loop``
    Seeded Poisson arrival process, fixed up front (the open-loop
    contract: arrival times never depend on service times). Each arrival
    submits one query from a fixed pool to a ``QueryScheduler`` (or one
    wrapping a ``FleetSearcher``); the driver polls ``maybe_step`` — the
    continuous-batching launch rule — until the stream ends, then drains.
    Latency per request is measured from the INTENDED arrival time, so a
    request submitted late because a batch was in flight still pays its
    queue wait (no coordinated omission). A churn callable runs on its
    own thread for the duration — the write path mutating under the
    serve path is the point, not an accident. Reports p50/p99/p999,
    achieved QPS, queue-depth profile, typed-rejection counts.

``ResultCache``
    LRU-by-bytes result store the scheduler consults on submit, keyed
    ``((query bytes, k), searcher_generation)``. The generation comes
    from ``ReaderCache.refresh`` (or the fleet's all-shard key) and
    bumps exactly when served content changes, so a hit replays a result
    computed on an identical snapshot: bit-identical by construction,
    stale hits impossible — a swap strands old keys, it never needs a
    flush. Hit/miss/evict counters feed ``envelope_report``.

``make_churn``
    The standard ~10% update-rate churn loop (index a small batch,
    delete a few docs, refresh, swap the scheduler's searcher) used by
    the ``serve_steady`` bench and the interleaving tests. With a
    ``warm_pool``, each fresh snapshot is warmed (``warm_searcher``)
    on the churn thread before the swap — the SearcherWarmer contract:
    the serving thread keeps answering from the old snapshot while the
    new one compiles, and never pays a cold evaluator itself.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.query_scheduler import (Overloaded, QueryRequest,
                                           QueryScheduler)

__all__ = ["Overloaded", "QueryRequest", "QueryScheduler", "ResultCache",
           "LoadReport", "run_open_loop", "make_churn", "warm_searcher"]


def warm_searcher(searcher, pool, slots: int, max_terms: int, k: int):
    """Warm a snapshot before it serves — the Lucene SearcherWarmer
    contract. For every pow2 batch bucket up to ``slots`` AND every pow2
    real-lane occupancy within the bucket, one probe batch (queries
    round-robined from ``pool``, padded to the scheduler's fixed
    ``max_terms`` shape, spare lanes all -1) runs, so each segment's
    evaluators are built and the kernels loaded for every batch shape and
    survivor-count bucket the launch rule can produce before the swap (in
    the JAX package, every shape it would otherwise trace at serve time).
    Pad lanes contribute zero survivors, so a half-empty drain batch
    lands in a lower survivor bucket than any full batch: occupancy
    matters as much as batch shape. Refreshes reuse readers for unchanged
    segments (``ReaderCache``), so in steady state only the newest
    segment's evaluators are new here."""
    off, b = 0, 1
    while True:
        r = 1
        while r <= b:
            q = np.full((b, max_terms), -1, np.int32)
            for i in range(r):
                t = np.asarray(pool[(off + i) % len(pool)], np.int32)
                q[i, :len(t)] = t
            off += r
            searcher.search_batched(q, k)
            r <<= 1
        if b >= slots:
            break
        b <<= 1


class ResultCache:
    """LRU-by-bytes (scores, doc_ids) store keyed by (query, generation).

    Exactness is structural: the generation half of the key identifies a
    snapshot state; equal generations serve bit-identical results for
    every query (``core/searcher.py::ReaderCache``), so a hit is the
    same answer evaluation would give, to the bit — asserted against the
    uncached oracle in the interleaving tests. Entries of superseded
    generations are never looked up again and age out of the LRU order
    naturally under the bytes cap.
    """

    def __init__(self, cap_bytes: int = 4 << 20):
        self.cap_bytes = int(cap_bytes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0
        self._bytes = 0
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def _size(key, value) -> int:
        vals, ids = value
        return vals.nbytes + ids.nbytes + len(key[0][0]) + 64

    def get(self, key):
        with self._lock:
            value = self._store.get(key)
            if value is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key, value) -> None:
        vals, ids = value
        value = (np.asarray(vals), np.asarray(ids))
        size = self._size(key, value)
        if size > self.cap_bytes:
            return
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= self._size(key, old)
            self._store[key] = value
            self._bytes += size
            self.puts += 1
            while self._bytes > self.cap_bytes and self._store:
                k, v = self._store.popitem(last=False)
                self._bytes -= self._size(k, v)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._bytes = 0

    def report(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "puts": self.puts,
                    "bytes": self._bytes, "entries": len(self._store)}


def _pct(lat_ms: np.ndarray, q: float) -> float:
    return float(np.percentile(lat_ms, q)) if lat_ms.size else 0.0


@dataclass
class LoadReport:
    """One open-loop run, summarized (raw requests kept for oracles)."""

    qps_target: float = 0.0
    qps_achieved: float = 0.0      # completed / wall (cached included)
    wall_s: float = 0.0
    offered: int = 0               # arrivals the process generated
    completed: int = 0
    cached: int = 0                # completed straight from ResultCache
    rejected: int = 0              # shed with Overloaded (typed, counted)
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    p999_ms: float = 0.0
    mean_queue_depth: float = 0.0
    max_queue_depth: int = 0
    requests: list = field(default_factory=list, repr=False)

    def row(self) -> dict:
        return {k: getattr(self, k) for k in
                ("qps_target", "qps_achieved", "wall_s", "offered",
                 "completed", "cached", "rejected", "p50_ms", "p99_ms",
                 "p999_ms", "mean_queue_depth", "max_queue_depth")}


def run_open_loop(scheduler: QueryScheduler, query_pool, qps: float,
                  duration_s: float, seed: int = 0, churn=None,
                  churn_interval_s: float = 0.02, k: int = None,
                  poll_s: float = 0.0005) -> LoadReport:
    """Drive ``scheduler`` with a seeded open-loop arrival stream.

    ``query_pool`` is a list of int32 term arrays; each arrival draws one
    (seeded). Arrival times are an exponential (Poisson) process at
    ``qps``, materialized BEFORE serving starts — offered load never
    adapts to service times. ``churn`` (optional, e.g. ``make_churn``'s
    closure) runs on its own thread every ``churn_interval_s`` until the
    drain finishes. Latency is ``t_done - intended_arrival``; rejected
    submits (``Overloaded``) are counted, not measured.
    """
    rng = np.random.default_rng(seed)
    n = max(1, int(round(qps * duration_s)))
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n))
    picks = rng.integers(0, len(query_pool), n)
    k = scheduler.k if k is None else k

    stop = threading.Event()
    churn_err: list = []
    churner = None
    if churn is not None:
        def _churn_loop():
            while not stop.is_set():
                try:
                    churn()
                except Exception as e:   # surface, don't hang the driver
                    churn_err.append(e)
                    return
                stop.wait(churn_interval_s)
        churner = threading.Thread(target=_churn_loop, daemon=True)
        churner.start()

    completed: list = []
    rejected = 0
    depth_samples: list = []
    t0 = time.perf_counter()
    i = 0
    try:
        while i < n:
            now = time.perf_counter()
            while i < n and t0 + arrivals[i] <= now:
                req = QueryRequest(rid=i, terms=query_pool[picks[i]], k=k)
                try:
                    scheduler.submit(req, now=t0 + arrivals[i])
                except Overloaded:
                    rejected += 1
                else:
                    if req.done:          # cache hit: served on submit
                        completed.append(req)
                i += 1
            completed.extend(scheduler.maybe_step())
            depth_samples.append(scheduler.queue_depth)
            if i < n:
                wait = t0 + arrivals[i] - time.perf_counter()
                if wait > poll_s and scheduler.queue_depth == 0:
                    time.sleep(min(wait, poll_s * 10))
                elif wait > 0 and not scheduler.ready():
                    time.sleep(min(wait, poll_s))
        completed.extend(scheduler.run_to_completion())
        # the clock stops when serving is drained: joining the churn
        # thread is cleanup, not service time
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        if churner is not None:
            churner.join(timeout=10.0)
    if churn_err:
        raise churn_err[0]

    lat = np.array([(r.t_done - r.t_submit) * 1e3 for r in completed
                    if r.done], np.float64)
    depth = np.asarray(depth_samples, np.float64)
    return LoadReport(
        qps_target=float(qps),
        qps_achieved=len(completed) / wall if wall > 0 else 0.0,
        wall_s=wall,
        offered=n,
        completed=len(completed),
        cached=sum(1 for r in completed if r.cached),
        rejected=rejected,
        p50_ms=_pct(lat, 50), p99_ms=_pct(lat, 99),
        p999_ms=_pct(lat, 99.9),
        mean_queue_depth=float(depth.mean()) if depth.size else 0.0,
        max_queue_depth=int(depth.max()) if depth.size else 0,
        requests=completed)


def make_churn(indexer, scheduler: QueryScheduler, rng,
               docs_per_tick: int = 4, doc_len: int = 12,
               vocab: int = 500, delete_every: int = 4, warm_pool=None):
    """The standard churn closure: each tick indexes a small batch
    (every ``delete_every``-th tick also deletes one recent doc),
    refreshes, and swaps the fresh searcher into ``scheduler`` — the
    full write path running under the serve path, generation bumping on
    every content change so the result cache invalidates exactly. With
    ``warm_pool`` (a query pool), the fresh snapshot is warmed on THIS
    thread before the swap (``warm_searcher``): the serving thread keeps
    answering from the old snapshot through the compile and never eats
    a cold-evaluator stall into its tail."""
    tick = [0]

    def churn():
        tick[0] += 1
        toks = rng.integers(0, vocab,
                            (docs_per_tick, doc_len)).astype(np.int32)
        indexer.index_batch(toks)
        if delete_every and tick[0] % delete_every == 0 \
                and indexer._next_doc > 0:
            victim = int(rng.integers(0, indexer._next_doc))
            indexer.delete([victim])
        searcher = indexer.refresh()
        if warm_pool is not None:
            warm_searcher(searcher, warm_pool, scheduler.slots,
                          scheduler.max_terms, scheduler.k)
        scheduler.swap_searcher(searcher)

    return churn

"""Sharded scatter-gather serving: fleet top-k with cross-shard bounds.

A fleet is N index shards (disjoint global doc-id ranges, or a hash
split), each served by one or more replicas. ``FleetSearcher`` fans a
query batch out to one replica per shard and merges per-shard top-k into
global top-k. Two things make the result *bit-identical on scores* to a
single ``IndexSearcher`` over the union corpus:

  * **Union collection stats.** BM25 scores depend on collection-global
    df / n_docs / avgdl; per-shard stats would diverge from the union
    index. ``CollectionStats`` aggregates the per-shard tables — doc
    lengths and dfs are integers, so the sums are exact in float64 no
    matter how they are grouped, and the union equals what the oracle
    computes from the merged corpus digit for digit. Each shard searcher
    is wrapped (``IndexSearcher.with_stats``) before serving.

  * **Cross-shard theta sharing.** Each doc lives in exactly one shard,
    so per-shard top-k under union stats merge into the exact global
    top-k, and the running global k-th score is a valid lower bound that
    later shards receive as ``theta0`` — they prune harder, and a shard
    whose best possible score is below the bound for every query in the
    batch is skipped without being contacted at all.

The final merge runs on the host (``merge_topk_sharded``), with
``lax.top_k``'s tie order (``core/query.py::topk``), so the ids equal
the JAX package's too. The mesh variant of the merge waits for the
port's collective layer (``ROADMAP.md``, Queue 1, the multi-device
item): ``mesh=`` raises until then.

Replica objects are duck-typed (``ReplicaSyncer`` in-process,
``RemoteReplica`` across processes): ``replica_id``, ``epoch``,
``healthy``, ``missing_docs``, ``collection_stats()``,
``install_stats()``, ``query_max_ub()``, ``search_batched()``.
Routing is round-robin among a shard's healthy replicas; a replica
serving ``degraded=True``/``missing_docs > 0`` sheds its traffic to a
healthy peer (``failovers`` counts these), and only when a shard has no
healthy replica at all does the least-degraded one serve
(``degraded_served``).

The port's counterpart of the JAX package's ``replication/fleet.py``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.indexer import _later_slice
from repro_torch.core.query import PruneStats, topk
from repro_torch.device import resolve_device

_MULTI_DEVICE = "item 3, the multi-device slice and its collective layer"
_EWMA_ALPHA = 0.2     # weight of the newest batch in a replica's latency


@dataclass(frozen=True)
class CollectionStats:
    """Collection-global BM25 statistics, exactly mergeable.

    ``sum_dl`` and the df table are integer-valued (stored as float64 /
    int64), so merging is associative with zero rounding: the union of
    shard stats equals the single-index oracle's stats bit for bit."""

    n_docs: int
    sum_dl: float
    df_terms: np.ndarray    # (U,) sorted term ids
    df_table: np.ndarray    # (U,) live df per term

    @property
    def avgdl(self) -> float:
        # same clamp the searcher applies to its local mean
        return max(self.sum_dl / self.n_docs, 1.0) if self.n_docs else 1.0

    @classmethod
    def from_searcher(cls, searcher) -> "CollectionStats":
        """LOCAL stats of one snapshot, computed from its readers (not
        its possibly-already-overridden fields)."""
        n, total = 0, 0.0
        for r in searcher.readers:
            dl = np.asarray(r.live_doc_len)
            n += int(dl.size)
            total += float(dl.astype(np.float64).sum())
        if searcher.readers:
            all_t = np.concatenate([r.terms_np for r in searcher.readers])
            all_df = np.concatenate([r.df_np for r in searcher.readers])
            terms, inv = np.unique(all_t, return_inverse=True)
            table = np.zeros(terms.size, np.int64)
            np.add.at(table, inv, all_df)
        else:
            terms = np.zeros(0, np.int64)
            table = np.zeros(0, np.int64)
        return cls(n_docs=n, sum_dl=total, df_terms=terms, df_table=table)

    @staticmethod
    def merge(parts) -> "CollectionStats":
        """Union of disjoint-doc-space stats: counts and dfs add."""
        parts = list(parts)
        if not parts:
            return CollectionStats(0, 0.0, np.zeros(0, np.int64),
                                   np.zeros(0, np.int64))
        all_t = np.concatenate([p.df_terms for p in parts])
        all_df = np.concatenate([p.df_table for p in parts])
        terms, inv = np.unique(all_t, return_inverse=True)
        table = np.zeros(terms.size, np.int64)
        np.add.at(table, inv, all_df)
        return CollectionStats(
            n_docs=sum(int(p.n_docs) for p in parts),
            sum_dl=float(sum(float(p.sum_dl) for p in parts)),
            df_terms=terms, df_table=table)


@dataclass(frozen=True)
class ShardSpec:
    """Assignment of a global doc-id space to ``n_shards`` index shards:
    ``range`` keeps contiguous id blocks together (each shard's writer
    allocates from its own ``doc_base``), ``hash`` scatters ids by a
    multiplicative hash (stationary — a doc's shard never changes)."""

    n_shards: int
    policy: str = "range"
    range_size: int = 0      # docs per shard under "range"

    def shard_of(self, doc_ids) -> np.ndarray:
        ids = np.asarray(doc_ids, np.int64)
        if self.policy == "range":
            if self.range_size <= 0:
                raise ValueError("range sharding needs range_size > 0")
            return np.minimum(ids // self.range_size,
                              self.n_shards - 1).astype(np.int64)
        h = (ids.astype(np.uint64)
             * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
        return (h % np.uint64(self.n_shards)).astype(np.int64)


def merge_topk_sharded(vals, ids, k: int, mesh=None):
    """Global top-k from stacked per-shard partials ``(S, B, k)`` on the
    host: the shard-major flattening of the JAX package and its top-k
    with the lower index first among equal values, so ties resolve to the
    same ids. Returns CPU tensors ``(vals (B, k) float32, ids (B, k)
    int64)``, padded with (0, -1) when fewer than k exist. ``mesh`` (the
    SPMD merge over a device mesh) raises: see the module docstring."""
    if mesh is not None:
        raise _later_slice("merge_topk_sharded over a device mesh",
                          _MULTI_DEVICE)
    vals = torch.as_tensor(np.asarray(vals, np.float32))
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    S, B = int(vals.shape[0]), int(vals.shape[1])
    vf = vals.permute(1, 0, 2).reshape(B, S * vals.shape[2])
    idf = ids.permute(1, 0, 2).reshape(B, S * ids.shape[2])
    kk = min(k, vf.shape[1])
    top_v, pos = topk(vf, kk)
    top_i = torch.gather(idf, 1, pos)
    if kk < k:
        top_v = torch.nn.functional.pad(top_v, (0, k - kk))
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    return top_v, top_i


@dataclass
class FleetStats:
    queries: int = 0
    batches: int = 0
    shards_visited: int = 0
    shards_skipped: int = 0      # whole shards pruned by the shared bound
    failovers: int = 0           # unhealthy replica bypassed for a peer
    degraded_served: int = 0     # shard served degraded (no healthy peer)
    lat_routed: int = 0          # picks decided by the EWMA latency table
    served: dict = field(default_factory=dict)   # replica_id -> batches


class FleetSearcher:
    """Scatter-gather top-k over shard replica groups (see module doc).

    ``shards`` is a list of replica groups, one per shard. Satisfies the
    ``QueryScheduler`` searcher protocol (``search_batched`` /
    ``degraded`` / ``missing_docs`` / ``prune_stats`` / ``generation`` /
    ``device``), so a scheduler can serve a whole fleet exactly like one
    local index. ``device`` None is CUDA (raises without one) or
    ``"cpu"``; every replica that names a device must serve on it.
    Results come back as CPU tensors, as an ``IndexSearcher``'s do."""

    def __init__(self, shards, mesh=None,
                 latency_aware: bool = True, probe_every: int = 16,
                 device=None):
        if mesh is not None:
            raise _later_slice("FleetSearcher over a device mesh",
                              _MULTI_DEVICE)
        self.shards = [list(g) for g in shards]
        if not (self.shards and all(self.shards)):
            raise ValueError("every shard needs at least one replica")
        self.device = resolve_device(device)
        for g in self.shards:
            for r in g:
                dev = getattr(r, "device", None)
                if dev is not None and torch.device(dev) != self.device:
                    raise ValueError(f"replica {r.replica_id} serves on "
                                     f"{dev}, the fleet on {self.device}")
        # latency-aware routing: each serve updates an EWMA of that
        # replica's batch latency; once every healthy peer has samples,
        # picks go to the fastest (a slow replica sheds traffic without
        # ever being marked unhealthy). Every ``probe_every``-th pick per
        # shard falls back to round-robin so a recovered replica's EWMA
        # refreshes instead of being starved forever at its old worst.
        self.latency_aware = bool(latency_aware)
        self.probe_every = max(2, int(probe_every))
        self.stats = FleetStats()
        self.prune_stats = PruneStats()
        self._rr = [0] * len(self.shards)
        self._picks = [0] * len(self.shards)
        self._ewma = [[None] * len(g) for g in self.shards]   # seconds
        self._ewma_n = [[0] * len(g) for g in self.shards]
        self._stats_key = None
        self.union_stats: CollectionStats = None
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def degraded(self) -> bool:
        """True only when some shard has NO healthy replica — a single
        degraded replica just sheds its traffic to a peer."""
        return any(not any(r.healthy for r in g) for g in self.shards)

    @property
    def missing_docs(self) -> int:
        """Best-achievable holes: per shard, the fewest missing docs any
        of its replicas serves (the routing minimum)."""
        return sum(min(int(r.missing_docs) for r in g)
                   for g in self.shards)

    @property
    def generation(self):
        """Fleet-level result-cache key, or 0 (uncacheable) unless the
        fleet is in a cacheable state: every replica of every shard
        healthy and the whole group agreed on one commit generation.
        Healthy replicas at the same commit serve identical content, so
        routing cannot change results and the tuple of per-shard commit
        gens determines every answer. Syncers assign ``gen`` only AFTER
        their searcher swap, so a stable key across a serve brackets a
        consistent fleet — the scheduler re-checks the key post-serve
        before caching."""
        gens = []
        for g in self.shards:
            seen = set()
            for r in g:
                if not r.healthy:
                    return 0
                seen.add(int(r.gen))
            if len(seen) != 1:
                return 0   # mid-sync: replicas answer from different commits
            gens.append(seen.pop())
        return ("fleet", id(self), tuple(gens))

    # -- routing ------------------------------------------------------------
    def _pick(self, si: int):
        """Pick shard ``si``'s serving replica: the lowest-EWMA-latency
        healthy one once every healthy peer has warm stats, round-robin
        otherwise (cold start, single survivor, or the periodic probe
        pick). A degraded replica sheds to a healthy peer either way
        (``failed_over`` = the round-robin head was unhealthy). Returns
        ``(replica, failed_over, served_degraded, replica_index)``."""
        group = self.shards[si]
        n = len(group)
        start = self._rr[si]
        self._rr[si] = (start + 1) % n
        self._picks[si] += 1
        healthy = [j for j in range(n) if group[j].healthy]
        if not healthy:
            j = min(range(n), key=lambda x: int(group[x].missing_docs))
            return group[j], False, True, j
        failed_over = start not in healthy
        if (self.latency_aware and len(healthy) > 1
                and self._picks[si] % self.probe_every != 0
                and all(self._ewma_n[si][j] >= 2 for j in healthy)):
            j = min(healthy, key=lambda x: self._ewma[si][x])
            self.stats.lat_routed += 1
        else:
            j = next((start + o) % n for o in range(n)
                     if (start + o) % n in healthy)
        return group[j], failed_over, False, j

    def _observe(self, si: int, j: int, dt: float) -> None:
        """Fold one serve's wall time into replica ``j``'s EWMA."""
        with self._lock:
            prev = self._ewma[si][j]
            a = _EWMA_ALPHA
            self._ewma[si][j] = dt if prev is None \
                else (1.0 - a) * prev + a * dt
            self._ewma_n[si][j] += 1

    def _ensure_stats(self, chosen) -> None:
        """(Re)aggregate + install union stats when any chosen replica's
        snapshot changed since the last batch (epoch-keyed)."""
        key = tuple((id(r), r.epoch) for r in chosen)
        if key == self._stats_key:
            return
        union = CollectionStats.merge(
            r.collection_stats() for r in chosen)
        for r in chosen:
            r.install_stats(union)
        self._stats_key = key
        self.union_stats = union

    # -- serving ------------------------------------------------------------
    def search_batched(self, q_batch, k: int = 10):
        """Scatter a (B, Q) query batch, gather global (B, k) top-k."""
        q = np.asarray(q_batch)
        B = q.shape[0]
        with self._lock:
            picks = [self._pick(si) for si in range(self.n_shards)]
            chosen = [p[0] for p in picks]
            ridx = [p[3] for p in picks]
            self.stats.failovers += sum(p[1] for p in picks)
            self.stats.degraded_served += sum(p[2] for p in picks)
            for r in chosen:
                self.stats.served[r.replica_id] = \
                    self.stats.served.get(r.replica_id, 0) + 1
            self._ensure_stats(chosen)
        ubs = [np.asarray(r.query_max_ub(q)) for r in chosen]
        order = np.argsort([-float(u.sum()) for u in ubs], kind="stable")
        theta0 = np.zeros(B, np.float64)
        running = None
        S = len(chosen)
        vals = np.zeros((S, B, k), np.float32)
        ids = np.full((S, B, k), -1, np.int64)
        visited = skipped = 0
        for si in order:
            if running is not None and running.shape[1] >= k \
                    and bool(np.all(ubs[si] < theta0)):
                skipped += 1
                continue   # no doc on this shard can beat the running k-th
            t_serve = time.perf_counter()
            v, i = chosen[si].search_batched(q, k, theta0=theta0)
            v, i = np.asarray(v), np.asarray(i)
            self._observe(si, ridx[si], time.perf_counter() - t_serve)
            vals[si, :, :v.shape[1]] = v
            ids[si, :, :i.shape[1]] = i
            visited += 1
            running = v if running is None \
                else np.concatenate([running, v], axis=1)
            if running.shape[1] > k:
                running = -np.partition(-running, k - 1, axis=1)[:, :k]
            if running.shape[1] >= k:
                theta0 = np.maximum(theta0, running.min(axis=1))
        with self._lock:
            self.stats.queries += B
            self.stats.batches += 1
            self.stats.shards_visited += visited
            self.stats.shards_skipped += skipped
            self.prune_stats.add(PruneStats(queries=B, batches=1,
                                            segments_skipped=skipped))
        return merge_topk_sharded(vals, ids, k)

    def search(self, q_terms, k: int = 10):
        v, i = self.search_batched(np.asarray(q_terms)[None], k)
        return v[0], i[0]

    def report(self) -> dict:
        with self._lock:
            return {"shards": self.n_shards,
                    "replicas": sum(len(g) for g in self.shards),
                    "queries": self.stats.queries,
                    "batches": self.stats.batches,
                    "shards_visited": self.stats.shards_visited,
                    "shards_skipped": self.stats.shards_skipped,
                    "failovers": self.stats.failovers,
                    "degraded_served": self.stats.degraded_served,
                    "lat_routed": self.stats.lat_routed,
                    "latency_ms": {
                        g[j].replica_id: round(self._ewma[si][j] * 1e3, 4)
                        for si, g in enumerate(self.shards)
                        for j in range(len(g))
                        if self._ewma[si][j] is not None},
                    "served": dict(self.stats.served)}

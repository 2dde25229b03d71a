"""Manifest-shipping replication, replica side.

``ReplicaSyncer`` pulls a writer's commits into its OWN ``Directory``
(any media profile) and serves them through the ordinary read path:

  1. read the source's newest readable manifest (torn newest → previous,
     exactly like recovery),
  2. fetch the data files the manifest references that the replica lacks
     (``plan_delta``), verifying each frame checksum ON ARRIVAL — a
     corrupt or flaky copy falls through to the next peer, since
     segments are immutable and checksummed, any clean copy is
     authoritative,
  3. ``sync`` the fetched data files, then install the manifest LAST
     (write + sync) — the replica directory is at every instant a valid
     commit point for the ordinary ``open_latest`` walk,
  4. garbage-collect replication-owned files the new commit obsoletes
     (never touching quarantine evidence),
  5. swap the serving searcher via ``ReaderCache.refresh`` (NRT: delete
     generations reopen cached readers, merged-away segments evict),
     and ack the publisher with ``replication_lag_s`` (install time
     minus the manifest's commit stamp) and bytes shipped.

Failover substrate: ``quarantine`` marks a segment bad and keeps
serving around it (the searcher turns ``degraded`` and the fleet layer
sheds this replica's traffic to a healthy peer); ``repair`` re-fetches
the corrupt segment's files from a peer replica (or the source),
verifies, reinstalls, and returns the replica to healthy serving.
``anti_entropy`` composes the two with a ``ChecksumScrubber`` sweep —
scrub finds rot, peers heal it.

The syncer also speaks the fleet replica protocol (``collection_stats``
/ ``install_stats`` / ``query_max_ub`` / ``search_batched`` / ``epoch``
/ ``healthy``) so a ``FleetSearcher`` can serve shards straight off
in-process syncers; ``replication/server.py`` wraps the same object in
a child process for the multi-process fleet.

The port's counterpart of the JAX package's ``replication/syncer.py``.
Segments decode and readers build on ``device`` (the unpack and pack
kernels on the card). A segment's files are read and parsed under
``try`` (a torn, missing or flaky file quarantines it), its ``pfor``
streams unpack OUTSIDE it, and it is assembled under ``try`` again, as
recovery does (``storage/commit.py::_load_segment``): a kernel that
fails to build, load or launch (``ctypes`` raises ``OSError`` when a
library fails to load) propagates instead of being read as rot.
"""
from __future__ import annotations

import threading
import time

from repro_torch.core.searcher import ReaderCache
from repro_torch.device import resolve_device
from repro_torch.replication.fleet import CollectionStats
from repro_torch.replication.publisher import (_READ_SKIP,
                                               latest_commit_meta,
                                               manifest_files, plan_delta)
from repro_torch.storage import codec as seg_codec
from repro_torch.storage.codec import CorruptSegment, unframe
from repro_torch.storage.commit import LIV_NAME_RE, RecoveryInfo
from repro_torch.storage.directory import Directory
from repro_torch.storage.scrub import ChecksumScrubber, expected_kind


class NoCleanCopy(CorruptSegment):
    """Every source of a file failed verification — the fleet has lost
    its last authoritative copy (or all peers are unreachable)."""


def _base_of(file_name: str) -> str:
    m = LIV_NAME_RE.match(file_name)
    return m.group(1) if m else file_name.split(".", 1)[0]


class ReplicaSyncer:
    """One searcher replica: pull commits, serve, self-heal from peers.

    ``source`` is the writer's Directory (or any up-to-date replica's);
    ``peers`` are other replicas' Directories, tried for re-fetch when a
    local copy rots. All three are plain ``Directory`` objects, so a
    "remote" fetch is a read through whatever media profile models the
    transport. ``device`` None is CUDA (raises without one) or ``"cpu"``:
    decodes, reader builds and scoring run there.
    """

    def __init__(self, directory: Directory, source: Directory,
                 peers=(), replica_id: str = None, publisher=None,
                 device=None):
        self.directory = directory
        self.source = source
        self.peers = list(peers)
        self.replica_id = replica_id or f"replica-{id(self) & 0xffff:04x}"
        self.publisher = publisher
        self.device = resolve_device(device)
        self.cache = ReaderCache(device=self.device)
        if publisher is not None:
            publisher.register(self.replica_id)
        self.gen = 0
        self.meta: dict = None
        self.epoch = 0              # bumps on every searcher swap
        self.quarantined: dict = {}   # base name -> doc count (or None)
        self.syncs = 0
        self.files_fetched = 0
        self.bytes_fetched = 0
        self.last_lag_s = 0.0
        self.max_lag_s = 0.0
        self.refetches = 0          # repair-path fetches (anti-entropy)
        self.refetch_bytes = 0
        self.repairs = 0
        self.verify_failures = 0    # copies rejected on arrival
        self.gc_deleted = 0
        self._cores: dict = {}      # base name -> decoded postings core
        self._live: dict = {}       # base name -> (liv name, served Segment)
        self._union_stats: CollectionStats = None
        self._fleet_view = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread = None
        self._error = None
        self.searcher = self.cache.refresh([])

    # -- fetch with arrival verification ------------------------------------
    def _fetch_verified(self, name: str, sources) -> bytes:
        """First CLEAN copy of ``name`` among ``sources``: read, verify
        the frame checksum, fall through to the next source on a corrupt
        or flaky copy. Immutability + checksums make any verified copy
        authoritative, no matter which replica served it."""
        kind = expected_kind(name)
        for src in sources:
            try:
                data = src.read_file(name)
                if kind is not None:
                    unframe(data, kind)
                return data
            except _READ_SKIP:
                self.verify_failures += 1
                continue
        raise NoCleanCopy(f"no clean copy of {name} on any source")

    # -- the sync pull ------------------------------------------------------
    def sync_once(self):
        """Pull the source's newest commit if it is ahead; returns a
        ``{gen, files, bytes, lag_s}`` summary or None when already
        current (or the source has never committed)."""
        with self._lock:
            got = latest_commit_meta(self.source)
            if got is None:
                return None
            gen, meta, manifest_bytes = got
            if gen <= self.gen:
                return None
            plan = plan_delta(gen, meta, set(self.directory.list_files()))
            fetched = 0
            for n in plan.to_fetch:
                data = self._fetch_verified(n, [self.source] + self.peers)
                self.directory.write_file(n, data)
                fetched += len(data)
            if plan.to_fetch:
                self.directory.sync(plan.to_fetch)
            # data durable -> manifest installs LAST (then its dirent)
            self.directory.write_file(plan.manifest, manifest_bytes)
            self.directory.sync([plan.manifest])
            for n in plan.to_delete:
                if _base_of(n) in self.quarantined:
                    continue   # corruption evidence outlives the commit
                try:
                    self.directory.delete_file(n)
                    self.gc_deleted += 1
                except FileNotFoundError:
                    pass
            ts = float(meta.get("ts") or 0.0)
            lag = max(time.time() - ts, 0.0) if ts > 0 else 0.0
            self.syncs += 1
            self.files_fetched += len(plan.to_fetch)
            self.bytes_fetched += fetched
            self.last_lag_s = lag
            self.max_lag_s = max(self.max_lag_s, lag)
            self._install(gen, meta)
            if self.publisher is not None:
                self.publisher.ack(self.replica_id, gen, lag, fetched,
                                   files_shipped=len(plan.to_fetch),
                                   have=set(self.directory.list_files()))
            return {"gen": gen, "files": len(plan.to_fetch),
                    "bytes": fetched, "lag_s": lag}

    def _install(self, gen: int, meta: dict) -> None:
        """Decode the commit into served segments, reusing cached
        postings cores (a new ``.liv`` generation is a ``with_deletes``
        over the cached core — same ``base_id``, so the ReaderCache
        REOPENS the reader instead of rebuilding the device index). A
        segment whose local copy is torn, missing or corrupt is
        quarantined and served around; a kernel failure propagates."""
        new_live = {}
        current = set(meta["segments"])
        # local quarantines for segments the commit no longer references
        # die with them (the writer merged the hole away)
        self.quarantined = {n: c for n, c in self.quarantined.items()
                            if n in current}
        for n in meta["segments"]:
            if n in self.quarantined or n in meta["quarantined"]:
                continue
            seg = self._load(n, meta["liv"].get(n))
            if seg is None:
                self.quarantined[n] = meta["doc_counts"].get(n)
                continue
            new_live[n] = (meta["liv"].get(n), seg)
        self._cores = {n: c for n, c in self._cores.items() if n in current}
        self._live = new_live
        self.meta = meta
        self._refresh_searcher()
        # gen advances LAST: a concurrent fleet-generation reader that
        # sees the new gen is guaranteed the searcher swap already
        # happened, so a result cached under the new key can only hold
        # new-snapshot content (see FleetSearcher.generation)
        self.gen = gen

    def _load(self, n: str, lname):
        """Segment ``n`` under delete generation ``lname`` (None: no
        deletes), or None when its local copy is unreadable. A cached core
        is reused; otherwise its files are read and parsed under ``try``,
        unpacked on the device outside it, and assembled under ``try``."""
        prev = self._live.get(n)
        if prev is not None and prev[0] == lname:
            return prev[1]
        core = self._cores.get(n)
        parsed = liv = None
        try:
            if core is None:
                parsed = seg_codec.parse_segment(
                    seg_codec.read_segment_files(self.directory, n))
            if lname is not None:
                liv = self.directory.read_file(lname)
        except _READ_SKIP:
            return None
        unpacked = None if parsed is None \
            else seg_codec.unpack_segment(parsed, self.device)
        try:
            if core is None:
                core = seg_codec.finish_segment(parsed, unpacked)
                self._cores[n] = core
            if liv is None:
                return core
            mask = seg_codec.decode_liveness(liv, core.n_docs)
            return core.with_deletes(core.doc_ids[mask])
        except _READ_SKIP:
            return None

    def _refresh_searcher(self) -> None:
        """Swap the serving searcher over the current live set; the
        recovery info carries both the manifest's quarantine record and
        this replica's local ones, so ``degraded``/``missing_docs`` stay
        honest and the fleet router can shed traffic accordingly."""
        segs = [self._live[n][1] for n in (self.meta["segments"] if
                self.meta else []) if n in self._live]
        quar = dict(self.meta["quarantined"]) if self.meta else {}
        for n, c in self.quarantined.items():
            quar.setdefault(n, c)
        recovery = RecoveryInfo(quarantined=quar) if quar else None
        self.searcher = self.cache.refresh(segs, recovery=recovery)
        if self._union_stats is not None:
            self._fleet_view = self.searcher.with_stats(self._union_stats)
        self.epoch += 1

    # -- quarantine-driven failover -----------------------------------------
    def quarantine(self, file_name: str) -> str:
        """Mark the segment owning ``file_name`` corrupt-on-media and
        serve around it: the cached core is evicted (its in-memory copy
        may be built over the rotten bytes), the searcher goes degraded,
        and the fleet router sheds this replica's traffic. Returns the
        quarantined base name."""
        with self._lock:
            base = _base_of(file_name)
            count = None
            if self.meta is not None:
                count = self.meta["doc_counts"].get(base)
            core = self._cores.pop(base, None)
            if count is None and core is not None:
                count = core.n_docs
            self.quarantined[base] = count
            self._live.pop(base, None)
            self._refresh_searcher()
            return base

    def repair(self, base: str):
        """Re-fetch a quarantined segment's files from the first peer
        (or the source) holding a clean copy, reinstall, and return to
        healthy serving. Peers are tried FIRST — anti-entropy between
        replicas is the point; the writer is just another clean copy.
        Returns ``{base, files, bytes}``."""
        with self._lock:
            base = _base_of(base)
            if self.meta is None or base not in set(self.meta["segments"]):
                self.quarantined.pop(base, None)
                return {"base": base, "files": 0, "bytes": 0}
            names = [base + sfx for sfx in seg_codec.SEGMENT_SUFFIXES]
            lname = self.meta["liv"].get(base)
            if lname is not None:
                names.append(lname)
            fetched_n, fetched_b, resynced = 0, 0, []
            for n in names:
                if self._verifies(n):
                    continue   # keep local copies that still verify clean
                data = self._fetch_verified(n, self.peers + [self.source])
                self.directory.write_file(n, data)
                resynced.append(n)
                fetched_n += 1
                fetched_b += len(data)
            if resynced:
                self.directory.sync(resynced)
            self.refetches += fetched_n
            self.refetch_bytes += fetched_b
            self.quarantined.pop(base, None)
            self._cores.pop(base, None)   # force a clean re-decode
            self._live.pop(base, None)
            self.repairs += 1
            self._install(self.gen, self.meta)
            return {"base": base, "files": fetched_n, "bytes": fetched_b}

    def _verifies(self, name: str) -> bool:
        """The local copy of ``name`` reads and its frame checks clean."""
        kind = expected_kind(name)
        try:
            data = self.directory.read_file(name)
            if kind is not None:
                unframe(data, kind)
        except _READ_SKIP:
            return False
        return True

    def anti_entropy(self):
        """One scrub-and-heal pass: re-verify every frame the current
        commit references (the ``ChecksumScrubber`` generalized across
        replicas), then repair each detection — and any referenced file
        that has gone missing entirely — from peers. Returns
        ``{corrupt, repaired}``."""
        with self._lock:
            scrubber = ChecksumScrubber(self.directory)
            corrupt = list(scrubber.sweep())
            if self.meta is not None:
                corrupt += [n for n in manifest_files(self.meta)
                            if not self.directory.file_exists(n)]
            repaired = []
            for name in corrupt:
                self.quarantine(name)
            for base in sorted({_base_of(n) for n in corrupt}):
                self.repair(base)
                repaired.append(base)
            return {"corrupt": corrupt, "repaired": repaired}

    # -- fleet replica protocol ---------------------------------------------
    @property
    def healthy(self) -> bool:
        return not self.searcher.degraded \
            and self.searcher.missing_docs == 0

    @property
    def missing_docs(self) -> int:
        return int(self.searcher.missing_docs)

    def collection_stats(self) -> CollectionStats:
        """This replica's LOCAL shard statistics (for fleet union)."""
        return CollectionStats.from_searcher(self.searcher)

    def install_stats(self, stats: CollectionStats) -> None:
        """Serve under fleet-union collection statistics from now on."""
        with self._lock:
            self._union_stats = stats
            self._fleet_view = self.searcher.with_stats(stats)

    def _view(self):
        return self._fleet_view if self._fleet_view is not None \
            else self.searcher

    def query_max_ub(self, q2d):
        return self._view().query_max_ub(q2d)

    def search_batched(self, q_batch, k: int = 10, theta0=None):
        return self._view().search_batched(q_batch, k, theta0=theta0)

    def search(self, q_terms, k: int = 10):
        return self._view().search(q_terms, k)

    # -- background poller (NRT follow) -------------------------------------
    def start(self, poll_s: float) -> None:
        """Follow the source continuously, one ``sync_once`` per poll; an
        error ends the poller and ``close()`` raises it."""
        if self._thread is not None or poll_s <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._follow, args=(poll_s,),
            name=f"syncer-{self.replica_id}", daemon=True)
        self._thread.start()

    def _follow(self, poll_s: float) -> None:
        try:
            while not self._stop.wait(poll_s):
                self.sync_once()
        except Exception as e:
            self._error = e

    def close(self) -> None:
        """Stop the poller (join) and raise the error it died of."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError(f"syncer {self.replica_id} failed to "
                                   f"stop")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def report(self) -> dict:
        with self._lock:
            return {"replica_id": self.replica_id, "gen": self.gen,
                    "epoch": self.epoch, "healthy": self.healthy,
                    "missing_docs": self.missing_docs,
                    "quarantined": sorted(self.quarantined),
                    "syncs": self.syncs,
                    "files_fetched": self.files_fetched,
                    "bytes_fetched": self.bytes_fetched,
                    "replication_lag_s": self.last_lag_s,
                    "max_lag_s": self.max_lag_s,
                    "refetches": self.refetches,
                    "refetch_bytes": self.refetch_bytes,
                    "repairs": self.repairs,
                    "verify_failures": self.verify_failures,
                    "gc_deleted": self.gc_deleted}

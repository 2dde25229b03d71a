"""Manifest-shipping replication, writer side.

The commit layer already produces everything replication needs: segment
and ``.liv`` files are immutable and checksummed, file names are never
reused within a writer lineage, and ``segments_N`` is a two-phase
manifest — so "replicating" a commit is nothing more than shipping the
files the new manifest references that the replica does not yet hold,
then installing the manifest last. This module computes those deltas:

  * ``manifest_files(meta)`` — the data files a manifest references, in
    install order (the manifest itself always ships last);
  * ``plan_delta(meta, have)`` — the pure delta computation shared by
    the writer-side publisher and the replica-side pull path;
  * ``CommitPublisher`` — writer-side bookkeeping: per-replica
    inventories, per-commit plans, and the per-replica
    ``replication_lag_s`` / bytes-shipped ledger that surfaces as the
    ``fleet`` section of ``envelope_report``.

Replication is PULL-shaped (the Lucene/Solr segment-replication
protocol): replicas ask "what does the newest commit reference that I
lack", which makes the writer stateless-safe — a replica that was down
for ten commits just computes one bigger delta against the latest
manifest, and files from superseded commits it still holds are garbage
collected because the new manifest no longer references them.

The port's copy of the JAX package's ``replication/publisher.py``: host
code over the port's ``storage`` package, with the same names.
"""
from __future__ import annotations

import json
import struct
import threading
import time
from dataclasses import dataclass, field

from repro_torch.storage import codec as seg_codec
from repro_torch.storage.codec import CorruptSegment
from repro_torch.storage.commit import (MANIFEST_RE, _OWNED_RE, list_commits,
                                  manifest_name, read_commit)
from repro_torch.storage.directory import Directory

# the same skip set the recovery walk uses: a torn newest manifest (the
# writer mid-commit) sends the reader to the previous commit, never up
_READ_SKIP = (CorruptSegment, json.JSONDecodeError, struct.error, OSError)


def manifest_files(meta: dict) -> list[str]:
    """Data files commit ``meta`` references — each segment's four core
    files plus its current ``.liv`` generation — in install order. The
    manifest itself is deliberately NOT listed: it must be installed
    LAST, after the data files are durable, so a replica's directory is
    always recoverable by the ordinary ``open_latest`` walk."""
    names = []
    for n in meta["segments"]:
        names.extend(n + sfx for sfx in seg_codec.SEGMENT_SUFFIXES)
    names.extend(sorted(set(meta["liv"].values())))
    return names


def latest_commit_meta(directory: Directory):
    """Newest READABLE commit as ``(gen, meta, manifest bytes)`` or None.
    Walks newest-first like recovery: a torn or mid-write manifest is
    skipped and the previous commit serves."""
    for gen in list_commits(directory):
        name = manifest_name(gen)
        try:
            data = directory.read_file(name)
            meta = read_commit(directory, name)
        except _READ_SKIP:
            continue
        return gen, meta, data
    return None


@dataclass
class SyncPlan:
    """One replica's delta to commit ``gen``: fetch ``to_fetch`` (data
    files, install order), install ``manifest`` last, then delete
    ``to_delete`` (replication-owned files the new commit obsoletes)."""

    gen: int
    manifest: str
    to_fetch: list
    to_delete: list

    @property
    def up_to_date(self) -> bool:
        return not self.to_fetch and not self.to_delete


def plan_delta(gen: int, meta: dict, have) -> SyncPlan:
    """Delta of commit ``(gen, meta)`` against a replica holding file set
    ``have``. Immutability + never-reused names make name-presence a
    sufficient identity check; content is still checksum-verified on
    arrival by the syncer. Deletion candidates are confined to files the
    commit layer owns (``_OWNED_RE``) so a replica directory co-hosting
    anything else — a WAL, a spooled corpus — is left alone."""
    have = set(have)
    referenced = set(manifest_files(meta))
    mname = manifest_name(gen)
    to_fetch = [n for n in manifest_files(meta) if n not in have]
    to_delete = sorted(
        n for n in have
        if n not in referenced and n != mname and _OWNED_RE.match(n)
        and not (MANIFEST_RE.match(n)
                 and int(MANIFEST_RE.match(n).group(1)) > gen))
    return SyncPlan(gen=gen, manifest=mname, to_fetch=to_fetch,
                    to_delete=to_delete)


@dataclass
class _ReplicaLedger:
    gen: int = 0
    syncs: int = 0
    bytes_shipped: int = 0
    files_shipped: int = 0
    last_lag_s: float = 0.0
    max_lag_s: float = 0.0
    last_ack_t: float = 0.0
    have: set = field(default_factory=set)


class CommitPublisher:
    """Writer-side replication endpoint over the writer's Directory.

    Tracks what each registered replica holds (updated by replica acks),
    computes per-commit ``SyncPlan`` deltas, and keeps the per-replica
    lag/bytes ledger. The publisher never pushes bytes — replicas pull
    through their own ``ReplicaSyncer`` — so it is safe to run inside
    the indexer process (attach via ``Indexer(publisher=...)``
    and ``envelope_report()`` grows a ``fleet`` section) or standalone
    next to a plain ``SegmentStore``.
    """

    def __init__(self, directory: Directory):
        self.directory = directory
        self.commits_published = 0
        self.last_gen = 0
        self.last_commit_ts = 0.0
        self._replicas: dict[str, _ReplicaLedger] = {}
        self._lock = threading.Lock()

    # -- writer side --------------------------------------------------------
    def on_commit(self, gen: int, ts: float = None) -> None:
        """Record that commit ``gen`` is durable and shippable (the
        indexer calls this right after ``store.commit``)."""
        with self._lock:
            self.commits_published += 1
            self.last_gen = max(self.last_gen, int(gen))
            self.last_commit_ts = time.time() if ts is None else ts

    def register(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.setdefault(replica_id, _ReplicaLedger())

    # -- delta computation --------------------------------------------------
    def plan(self, have) -> SyncPlan | None:
        """Delta of the newest readable commit against file set ``have``
        (None when the writer has never committed)."""
        got = latest_commit_meta(self.directory)
        if got is None:
            return None
        gen, meta, _ = got
        return plan_delta(gen, meta, have)

    def plan_for(self, replica_id: str) -> SyncPlan | None:
        """Per-replica delta against the inventory its last ack reported
        (a replica that never acked plans from an empty inventory)."""
        self.register(replica_id)
        with self._lock:
            have = set(self._replicas[replica_id].have)
        return self.plan(have)

    # -- replica acks -------------------------------------------------------
    def ack(self, replica_id: str, gen: int, lag_s: float,
            bytes_shipped: int, files_shipped: int = 0,
            have=None) -> None:
        """A replica reports it installed commit ``gen``: update its
        ledger (and inventory, when reported) so the next ``plan_for``
        and ``report`` reflect it."""
        self.register(replica_id)
        with self._lock:
            led = self._replicas[replica_id]
            led.gen = max(led.gen, int(gen))
            led.syncs += 1
            led.bytes_shipped += int(bytes_shipped)
            led.files_shipped += int(files_shipped)
            led.last_lag_s = float(lag_s)
            led.max_lag_s = max(led.max_lag_s, float(lag_s))
            led.last_ack_t = time.time()
            if have is not None:
                led.have = set(have)

    # -- reporting ----------------------------------------------------------
    def report(self) -> dict:
        """The ``fleet`` section: per-replica replication lag and bytes
        shipped, plus fleet-wide aggregates."""
        with self._lock:
            per = {
                rid: {"gen": led.gen, "syncs": led.syncs,
                      "bytes_shipped": led.bytes_shipped,
                      "files_shipped": led.files_shipped,
                      "replication_lag_s": led.last_lag_s,
                      "max_lag_s": led.max_lag_s,
                      "behind": max(self.last_gen - led.gen, 0)}
                for rid, led in sorted(self._replicas.items())}
            return {
                "replicas": len(per),
                "commits_published": self.commits_published,
                "last_gen": self.last_gen,
                "bytes_shipped_total": sum(r["bytes_shipped"]
                                           for r in per.values()),
                "max_replication_lag_s": max(
                    (r["replication_lag_s"] for r in per.values()),
                    default=0.0),
                "replicas_current": sum(r["behind"] == 0
                                        for r in per.values()),
                "per_replica": per,
            }

"""Background checksum scrubber — finds bit rot before a query does.

Every committed file is a crc32-checked frame, but the checksum is only
verified when the file is *read* — and a segment that merges rarely may
not be re-read for days while its bits rot on the media. The scrubber
closes that window the way ZFS/Ceph scrubs do: a background daemon
(same shape as the indexer's ``refresh_every`` NRT thread) re-reads
every file the latest commit references and re-validates its frame, at
a bounded IO rate (reusing ``MergeRateLimiter`` — scrub reads must not
monopolize the device any more than merge IO may). Detections feed
straight into quarantine: with a ``SegmentStore`` attached the corrupt
segment is excluded from future commits (and self-healed from memory at
the next commit when it is still live); the ``on_corrupt`` callback
lets a serving-only node flip its searcher to degraded instead.

``sweep()`` is the synchronous core (one full pass, returns the corrupt
file names) so tests and operators can scrub on demand; ``start()``
runs sweeps every ``interval_s`` until ``close()``.

Scrub IO competes with ingest for the same media, so beyond the rate
limiter the scrubber can be handed a ``contention`` gate: while it
reports the device saturated (e.g. ``throttle_saturation_gate`` over
the ingest ``DeviceThrottle``), periodic sweeps are DEFERRED — rot
detection latency is traded for ingest throughput exactly while the
envelope is write-bound, and the sweep resumes on the first idle tick.
"""
from __future__ import annotations

import threading
import time

from repro_torch.storage import codec as seg_codec
from repro_torch.storage.codec import (CorruptSegment, KIND_LIV,
                                       KIND_MANIFEST, unframe)
from repro_torch.storage.commit import (LIV_NAME_RE, MANIFEST_RE,
                                        list_commits, manifest_name,
                                        read_commit)
from repro_torch.storage.directory import Directory


def expected_kind(name: str) -> int | None:
    """Frame kind a committed file must decode as, or None to skip.
    Shared with the replication layer, which verifies every fetched
    copy against the same mapping on arrival."""
    if MANIFEST_RE.match(name):
        return KIND_MANIFEST
    if LIV_NAME_RE.match(name):
        return KIND_LIV
    for sfx, kind in seg_codec._SUFFIX_KIND.items():
        if name.endswith(sfx):
            return kind
    return None


_expected_kind = expected_kind


def throttle_saturation_gate(throttle, threshold: float = 0.5):
    """Contention gate over a ``DeviceThrottle``: truthy while the share
    of wall time the device spent busy since the LAST CALL exceeds
    ``threshold``. Stateful by design — each call samples the
    (busy_s, now) deltas, so the gate measures the current regime, not
    the run's lifetime average."""
    state = {"busy": float(throttle.busy_s), "t": time.monotonic()}

    def saturated() -> bool:
        busy, now = float(throttle.busy_s), time.monotonic()
        d_busy, d_t = busy - state["busy"], now - state["t"]
        state["busy"], state["t"] = busy, now
        if d_t <= 0:
            return False
        return (d_busy / d_t) > threshold
    return saturated


class ChecksumScrubber:
    """Re-verify committed frames against their crc32, rate-limited.

    ``directory`` is scanned from its newest readable manifest each
    sweep; already-quarantined segments are skipped (their corruption is
    known). Faults during a sweep (a flaky read) skip that file and are
    counted — the scrubber degrades like everything else in this layer.
    """

    def __init__(self, directory: Directory, store=None,
                 limiter=None, interval_s: float = 0.0,
                 on_corrupt=None, contention=None):
        self.directory = directory
        self.store = store
        self.limiter = limiter          # MergeRateLimiter (or None)
        self.interval_s = interval_s
        self.on_corrupt = on_corrupt
        # no-arg callable; truthy -> the media is saturated by ingest and
        # this periodic sweep is deferred (see throttle_saturation_gate)
        self.contention = contention
        self.sweeps = 0
        self.sweeps_deferred = 0
        self.files_checked = 0
        self.bytes_verified = 0
        self.corrupt_found = 0
        self.read_errors = 0
        self.corrupt_names: list[str] = []   # cumulative, deduped
        self._thread = None
        self._stop = threading.Event()
        self._error = None
        self._lock = threading.Lock()

    # -- synchronous core ---------------------------------------------------
    def _targets(self) -> list[str]:
        """Files the newest readable commit references (manifest first,
        so a rotten manifest is itself detected)."""
        quarantined = set()
        if self.store is not None:
            with self.store._lock:
                quarantined = set(self.store.quarantined)
        for gen in list_commits(self.directory):
            mname = manifest_name(gen)
            try:
                meta = read_commit(self.directory, mname)
            except CorruptSegment:
                self._record_corrupt(mname)
                continue
            except OSError:
                with self._lock:
                    self.read_errors += 1
                continue
            names = [mname]
            for n in meta["segments"]:
                if n in quarantined or n in meta["quarantined"]:
                    continue
                names.extend(n + sfx for sfx in seg_codec.SEGMENT_SUFFIXES)
                lname = meta["liv"].get(n)
                if lname is not None:
                    names.append(lname)
            return names
        return []

    def _record_corrupt(self, name: str) -> None:
        with self._lock:
            self.corrupt_found += 1
            if name not in self.corrupt_names:
                self.corrupt_names.append(name)
        if self.store is not None and not MANIFEST_RE.match(name):
            self.store.quarantine(name)
        if self.on_corrupt is not None:
            self.on_corrupt(name)

    def sweep(self) -> list[str]:
        """One full verification pass; returns corrupt names found NOW."""
        found = []
        for name in self._targets():
            kind = _expected_kind(name)
            if kind is None:
                continue
            try:
                data = self.directory.read_file(name)
            except OSError:
                with self._lock:
                    self.read_errors += 1
                continue
            if self.limiter is not None:
                self.limiter.charge(len(data))
            try:
                unframe(data, kind)
            except CorruptSegment:
                found.append(name)
                self._record_corrupt(name)
            with self._lock:
                self.files_checked += 1
                self.bytes_verified += len(data)
        with self._lock:
            self.sweeps += 1
        return found

    def maybe_sweep(self) -> list[str] | None:
        """``sweep()`` unless the contention gate reports the media
        saturated, in which case the pass is deferred (None) and retried
        at the next interval. An explicit ``sweep()`` call always runs —
        the gate only moderates the periodic background pressure."""
        if self.contention is not None and self.contention():
            with self._lock:
                self.sweeps_deferred += 1
            return None
        return self.sweep()

    # -- daemon -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="scrubber", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.maybe_sweep()
            except BaseException as e:   # surfaced at close()
                self._error = e
                return

    def close(self) -> None:
        """Stop the daemon and re-raise anything it died of."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def report(self) -> dict:
        with self._lock:
            return {"sweeps": self.sweeps,
                    "sweeps_deferred": self.sweeps_deferred,
                    "files_checked": self.files_checked,
                    "bytes_verified": self.bytes_verified,
                    "corrupt_found": self.corrupt_found,
                    "read_errors": self.read_errors,
                    "corrupt": list(self.corrupt_names)}

"""Directory abstraction — the media seam of the storage subsystem.

Lucene's ``Directory`` is the one interface everything above the device
talks to ("On Using Non-Volatile Memory in Apache Lucene" swaps media
exactly here); we mirror that shape so the paper's source/target media
experiments become *runnable* instead of modeled:

  ``RAMDirectory``        dict-backed, for tests and as the inner store of
                          throttled in-silico experiments.
  ``FSDirectory``         one flat filesystem directory. ``write_file``
                          stages into a hidden ``.tmp.`` name and
                          ``os.replace``s it into place, so a kill mid-write
                          leaves either the old content or nothing — never a
                          torn file; ``rename`` is ``os.replace`` too, which
                          is all the two-phase commit protocol in
                          ``storage/commit.py`` needs.
  ``FaultInjectingDirectory``  wraps any Directory and injects seeded or
                          scripted faults per op — transient/persistent
                          ``IOError``, ``ENOSPC``, torn writes (prefix
                          only), silent bit flips, latency spikes — so the
                          retry / quarantine / WAL-replay machinery above
                          can be driven deterministically in tests.
  ``ThrottledDirectory``  wraps any Directory and charges every byte to a
                          ``DeviceThrottle`` — a single device timeline with
                          the bandwidth/latency profile of one of the paper's
                          media. Two throttled directories SHARING one
                          throttle model source and target on the same
                          device/controller (reads and writes serialize, the
                          paper's SSD->SSD case); separate throttles model
                          physical isolation (streams overlap).

Every Directory measures itself: ``bytes_read``/``bytes_written`` and the
wall time spent in reads/writes, so ``envelope_report`` can print measured
GB/min next to the analytic ``core/envelope.py`` prediction.
"""
from __future__ import annotations

import errno
import mmap as _mmap
import os
import random
import threading
import time
from dataclasses import dataclass


class Directory:
    """Abstract flat byte store with measured-IO accounting.

    Subclasses implement ``_write/_read/_list/_delete/_rename/_size``;
    the public methods add thread-safe byte + wall-clock accounting.
    File names are flat (no separators) — the commit layer owns naming.
    """

    def __init__(self):
        self.bytes_written = 0
        self.bytes_read = 0
        self.write_wall_s = 0.0
        self.read_wall_s = 0.0
        self.syncs = 0           # files made durable via sync()
        self.sync_wall_s = 0.0
        self._acct_lock = threading.Lock()

    # -- accounting wrappers ------------------------------------------------
    def write_file(self, name: str, data: bytes) -> int:
        _check_name(name)
        data = bytes(data)
        t0 = time.perf_counter()
        self._write(name, data)
        dt = time.perf_counter() - t0
        with self._acct_lock:
            self.bytes_written += len(data)
            self.write_wall_s += dt
        return len(data)

    def read_file(self, name: str) -> bytes:
        _check_name(name)
        t0 = time.perf_counter()
        data = self._read(name)
        dt = time.perf_counter() - t0
        with self._acct_lock:
            self.bytes_read += len(data)
            self.read_wall_s += dt
        return data

    def list_files(self) -> list[str]:
        return sorted(self._list())

    def delete_file(self, name: str) -> None:
        _check_name(name)
        self._delete(name)

    def rename(self, src: str, dst: str) -> None:
        """Atomic replace: after return, ``dst`` exists with ``src``'s
        content and ``src`` is gone — the commit point's linchpin."""
        _check_name(src)
        _check_name(dst)
        self._rename(src, dst)

    def sync(self, names) -> None:
        """Durability barrier over ``names`` (Lucene's ``Directory.sync``):
        after return, those files survive a crash. Writes themselves are
        deliberately lazy — the two-phase commit protocol batches one
        sync over every data file it is about to reference, right before
        the manifest rename, instead of paying an fsync per write. No-op
        on RAMDirectory (nothing outlives the process anyway); counted in
        the measured-IO accounting either way."""
        names = list(names)
        for n in names:
            _check_name(n)
        existing = set(self._list())
        for n in names:   # the barrier contract holds on every backend
            if n not in existing:
                raise FileNotFoundError(n)
        t0 = time.perf_counter()
        self._sync(names)
        dt = time.perf_counter() - t0
        with self._acct_lock:
            self.syncs += len(names)
            self.sync_wall_s += dt

    def file_exists(self, name: str) -> bool:
        return name in self._list()

    def file_size(self, name: str) -> int:
        _check_name(name)
        return self._size(name)

    def reset_counters(self) -> None:
        """Zero the measured-IO counters (e.g. after spooling the source
        collection, so the experiment only measures the indexing run)."""
        with self._acct_lock:
            self.bytes_written = self.bytes_read = 0
            self.write_wall_s = self.read_wall_s = 0.0

    # -- to implement -------------------------------------------------------
    def _sync(self, names):
        """Default: no-op (volatile stores have nothing to make durable)."""

    def _write(self, name, data):  # pragma: no cover - abstract
        raise NotImplementedError

    def _read(self, name):  # pragma: no cover - abstract
        raise NotImplementedError

    def _list(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _delete(self, name):  # pragma: no cover - abstract
        raise NotImplementedError

    def _rename(self, src, dst):  # pragma: no cover - abstract
        raise NotImplementedError

    def _size(self, name):  # pragma: no cover - abstract
        raise NotImplementedError


def _check_name(name: str) -> None:
    if not name or "/" in name or "\\" in name or name in (".", ".."):
        raise ValueError(f"invalid directory file name {name!r}")


class RAMDirectory(Directory):
    """In-memory Directory (a dict under a lock)."""

    def __init__(self):
        super().__init__()
        self._files: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _write(self, name, data):
        with self._lock:
            self._files[name] = data

    def _read(self, name):
        with self._lock:
            if name not in self._files:
                raise FileNotFoundError(name)
            return self._files[name]

    def _list(self):
        with self._lock:
            return list(self._files)

    def _delete(self, name):
        with self._lock:
            if name not in self._files:
                raise FileNotFoundError(name)
            del self._files[name]

    def _rename(self, src, dst):
        with self._lock:
            if src not in self._files:
                raise FileNotFoundError(src)
            self._files[dst] = self._files.pop(src)

    def _size(self, name):
        with self._lock:
            if name not in self._files:
                raise FileNotFoundError(name)
            return len(self._files[name])


class VolatileDirectory(RAMDirectory):
    """In-memory Directory that models the page cache over a durable
    store: writes land volatile, ``sync(names)`` copies those files to
    the durable side, and ``crash()`` returns a fresh ``RAMDirectory``
    holding ONLY what was synced — the survivor set a kill -9 leaves on
    real media. RAMDirectory can't express that distinction (its sync is
    a no-op and everything survives by definition), so durability tests
    — WAL group commit, commit-protocol ordering — run against this.

    ``rename`` models POSIX: the new dirent is volatile until the next
    ``sync`` of that name (which is why the commit protocol syncs the
    manifest name again after the rename). ``delete`` removes both sides
    (a removal that must survive needs no barrier here; nothing in the
    commit protocol depends on losing a deletion)."""

    def __init__(self):
        super().__init__()
        self._durable: dict[str, bytes] = {}

    def _sync(self, names):
        with self._lock:
            for n in names:
                if n in self._files:   # base pre-checked existence
                    self._durable[n] = self._files[n]

    def _delete(self, name):
        super()._delete(name)
        with self._lock:
            self._durable.pop(name, None)

    def _rename(self, src, dst):
        super()._rename(src, dst)
        with self._lock:
            self._durable.pop(src, None)

    def crash(self) -> RAMDirectory:
        """The post-kill-9 view: a directory holding only synced bytes."""
        survivor = RAMDirectory()
        with self._lock:
            survivor._files = dict(self._durable)
        return survivor


class FSDirectory(Directory):
    """One flat directory on the local filesystem.

    ``write_file`` stages the bytes into a hidden ``.tmp.<name>`` file
    and ``os.replace``s it over the target, so a mid-write failure (EIO,
    ENOSPC, kill -9) leaves the previous content — or no file — never a
    half-written one. Stale ``.tmp.`` files from a crashed writer are
    swept on construction (the recovery moment: a restart builds a fresh
    FSDirectory) and hidden from ``list_files``. Writes still do NOT
    fsync — durability is batched into the ``sync`` barrier the commit
    protocol issues over all its data files at once, one fsync per file
    plus one on the directory inode (so the renames themselves are
    durable too). ``rename`` is ``os.replace`` — atomic on POSIX — and
    is the only primitive the two-phase commit relies on.

    ``mmap=True`` serves reads through memory-mapped files (Lucene's
    MMapDirectory seam): the data path is the page cache via ``mmap(2)``
    instead of ``read(2)``. Because ``Directory.read_file`` contracts to
    return ``bytes``, one copy out of the cache is still paid per call —
    the seam's value here is the media-layer shape (and the measured
    parity test that both modes return identical bytes), not a zero-copy
    fast path; serving slices without the copy needs a reader that
    accepts memoryviews, a follow-on. Anywhere mmap is unavailable —
    zero-length files cannot be mapped, and some filesystems refuse
    ``mmap(2)`` outright — the read transparently falls back to a plain
    file read. The byte/wall accounting is unchanged either way (it
    lives in the public ``read_file`` wrapper), so measured-IO envelopes
    stay comparable across modes; ``mmap_reads`` counts how many reads
    the mapping actually served.

    Frame-length honoring: a mapped read copies exactly the bytes the
    codec frame header DECLARES (``codec.frame_declared_length``) rather
    than the whole mapping — the actual MMapDirectory shape, where a
    reader slices the region its footer describes instead of touching
    every mapped page. Trailing bytes beyond the frame (a torn rewrite,
    filesystem padding) are ignored by ``unframe`` on the plain path
    too (the declared length is authoritative), so both modes decode
    identically; a partial/truncated frame (declared length > file
    size, or an unparseable header) is returned whole and fails
    ``unframe``'s length/CRC validation with ``CorruptSegment``
    identically across both paths.
    """

    _TMP_PREFIX = ".tmp."

    def __init__(self, path: str, mmap: bool = False):
        super().__init__()
        self.path = str(path)
        self.use_mmap = bool(mmap)
        self.mmap_reads = 0
        self.stale_tmps_removed = 0
        os.makedirs(self.path, exist_ok=True)
        # recovery sweep: a crashed writer's staged files are garbage
        for n in os.listdir(self.path):
            if n.startswith(self._TMP_PREFIX) and os.path.isfile(self._p(n)):
                try:
                    os.remove(self._p(n))
                    self.stale_tmps_removed += 1
                except OSError:
                    pass

    def _p(self, name):
        return os.path.join(self.path, name)

    def _write(self, name, data):
        # stage + replace: the target name only ever holds complete bytes
        tmp = self._TMP_PREFIX + name
        try:
            with open(self._p(tmp), "wb") as f:
                f.write(data)
            os.replace(self._p(tmp), self._p(name))
        except BaseException:
            try:
                os.remove(self._p(tmp))
            except OSError:
                pass
            raise

    def _sync(self, names):
        for name in names:
            try:
                fd = os.open(self._p(name), os.O_RDONLY)
            except OSError as e:
                raise FileNotFoundError(name) from e
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        # directory inode: makes creations/renames of the synced files
        # themselves durable (POSIX requires a separate fsync for that)
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _read(self, name):
        try:
            f = open(self._p(name), "rb")
        except OSError as e:
            raise FileNotFoundError(name) from e
        with f:
            if self.use_mmap:
                try:
                    mm = _mmap.mmap(f.fileno(), 0,
                                    access=_mmap.ACCESS_READ)
                except (ValueError, OSError):
                    pass  # empty file / fs without mmap: plain read below
                else:
                    try:
                        # honor the codec frame length: copy exactly the
                        # declared frame when the mapping holds it all;
                        # shorter (truncated) or unframed files are
                        # copied whole so unframe fails identically to
                        # the plain-read path
                        from repro_torch.storage.codec import (
                            frame_declared_length)
                        declared = frame_declared_length(
                            mm[:32] if len(mm) >= 32 else mm[:])
                        if declared is not None and declared <= len(mm):
                            data = mm[:declared]
                        else:
                            data = bytes(mm)
                    finally:
                        mm.close()
                    with self._acct_lock:
                        self.mmap_reads += 1
                    return data
            return f.read()

    def _list(self):
        return [n for n in os.listdir(self.path)
                if os.path.isfile(self._p(n))
                and not n.startswith(self._TMP_PREFIX)]

    def _delete(self, name):
        os.remove(self._p(name))

    def _rename(self, src, dst):
        os.replace(self._p(src), self._p(dst))

    def _size(self, name):
        try:
            return os.path.getsize(self._p(name))
        except OSError as e:
            raise FileNotFoundError(name) from e


# ---------------------------------------------------------------------------
# media throttling
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MediaProfile:
    """Bandwidth/latency envelope of one physical medium (bytes/s)."""

    name: str
    read_bw: float
    write_bw: float
    read_latency_s: float = 0.0
    write_latency_s: float = 0.0

    def scaled(self, factor: float) -> "MediaProfile":
        """Same medium, bandwidths divided by ``factor`` — lets a KB-scale
        in-silico corpus exercise the same *ratios* the paper's 231 GB
        collection does, at measurable device times."""
        return MediaProfile(self.name, self.read_bw / factor,
                            self.write_bw / factor,
                            self.read_latency_s, self.write_latency_s)


# the paper's three media (§2): a network-attached store behind 10 GbE, a
# direct-attached disk array (fast sequential reads, slow RAID-6 writes),
# and a SATA SSD pinned near its ~500 MB/s interface ceiling both ways.
MEDIA_PROFILES = {
    "nas": MediaProfile("nas", read_bw=1.1e9, write_bw=0.5e9,
                        read_latency_s=5e-4, write_latency_s=5e-4),
    "disk": MediaProfile("disk", read_bw=2.0e9, write_bw=0.32e9,
                         read_latency_s=8e-3, write_latency_s=8e-3),
    "ssd": MediaProfile("ssd", read_bw=0.52e9, write_bw=0.50e9,
                        read_latency_s=5e-5, write_latency_s=5e-5),
}


class DeviceThrottle:
    """One device's timeline: every operation charges latency + bytes/bw.

    ``busy_read_s``/``busy_write_s`` accumulate exact *device time* — the
    measured counterpart of the envelope model's T_read/T_write stages —
    independent of how fast the backing store really is. Directories that
    share one throttle share one controller: their charges land on the same
    timeline, so total device time is the SUM of both streams (the paper's
    shared-media serialization). Directories with separate throttles
    overlap (isolation).

    ``pace`` > 0 additionally sleeps ``pace * cost`` per operation, turning
    the simulated timeline into real wall-clock (pace=1 emulates the medium
    in real time; the default 0 only accounts).
    """

    def __init__(self, profile: MediaProfile, pace: float = 0.0):
        self.profile = profile
        self.pace = pace
        self.busy_read_s = 0.0
        self.busy_write_s = 0.0
        self.ops_read = 0
        self.ops_write = 0
        self._lock = threading.Lock()

    def charge_read(self, n_bytes: int) -> float:
        cost = self.profile.read_latency_s + n_bytes / self.profile.read_bw
        with self._lock:
            self.busy_read_s += cost
            self.ops_read += 1
        if self.pace > 0:
            time.sleep(cost * self.pace)
        return cost

    def charge_write(self, n_bytes: int) -> float:
        cost = self.profile.write_latency_s + n_bytes / self.profile.write_bw
        with self._lock:
            self.busy_write_s += cost
            self.ops_write += 1
        if self.pace > 0:
            time.sleep(cost * self.pace)
        return cost

    @property
    def busy_s(self) -> float:
        return self.busy_read_s + self.busy_write_s

    def reset(self) -> None:
        with self._lock:
            self.busy_read_s = self.busy_write_s = 0.0
            self.ops_read = self.ops_write = 0


class ThrottledDirectory(Directory):
    """A Directory whose every byte pays a ``DeviceThrottle``'s toll.

    Wraps an inner Directory (RAM or FS); the inner store holds the actual
    bytes, the throttle holds the device timeline. Build the paper's
    isolated pair with two throttles, the shared pair by passing the SAME
    throttle to both the source and target directory.
    """

    def __init__(self, inner: Directory, throttle: DeviceThrottle):
        super().__init__()
        self.inner = inner
        self.throttle = throttle

    def _write(self, name, data):
        self.throttle.charge_write(len(data))
        self.inner.write_file(name, data)

    def _read(self, name):
        data = self.inner.read_file(name)
        self.throttle.charge_read(len(data))
        return data

    def _list(self):
        return self.inner._list()

    def _delete(self, name):
        self.inner.delete_file(name)

    def _rename(self, src, dst):
        # metadata-only on real media: charge latency, not bandwidth
        self.throttle.charge_write(0)
        self.inner.rename(src, dst)

    def _sync(self, names):
        # a sync barrier costs one device round-trip per file (latency,
        # no bandwidth) — the measured cost of the commit protocol's
        # batched fsync
        for _ in names:
            self.throttle.charge_write(0)
        self.inner.sync(names)

    def _size(self, name):
        return self.inner.file_size(name)


# ---------------------------------------------------------------------------
# hot-block caching
# ---------------------------------------------------------------------------

# segment files worth pinning: term dictionaries + postings streams. The
# commit manifest / liveness / WAL change under their own names and are
# deliberately NOT cached (their readers want the media truth).
_CACHE_SUFFIXES = (".dict", ".pst", ".pos", ".doc")


class CachingDirectory(Directory):
    """A Directory that pins hot frame-checksummed blocks in RAM.

    The read path re-pays media latency every time a segment file is
    (re)opened — recovery, replica sync and self-heal, reader rebuilds
    after cache eviction, degraded reopens — and on the nas/disk
    profiles that latency dominates. This layer sits ABOVE the media
    seam (wrap the throttled/fault-injected directory, not the raw
    store) and serves repeat reads of postings-bearing files from
    memory:

      * only whole files with a postings suffix are cached, and only
        after their frame passes crc validation at fill time — a block
        that fails ``unframe`` is served through but never retained, so
        the cache can't launder bit rot past the scrubber;
      * eviction is frequency-first (LFU, ties broken oldest-access
        first) under ``cap_bytes`` — head terms stay pinned while the
        long tail cycles, which is the access pattern the paper's
        serving-side memory-hierarchy argument assumes;
      * mutation of a cached name through THIS directory (write /
        delete / rename) drops the entry, and ``invalidate_base``
        drops every block of one segment family — the indexer calls it
        when a delete generation rewrites a segment's liveness or a
        merge retires its files.

    Hits/misses/evictions and resident bytes feed ``envelope_report``.
    """

    def __init__(self, inner: Directory, cap_bytes: int = 8 << 20,
                 suffixes=_CACHE_SUFFIXES):
        super().__init__()
        self.inner = inner
        self.cap_bytes = int(cap_bytes)
        self.suffixes = tuple(suffixes)
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.cache_rejected = 0   # blocks that failed crc at fill time
        self._cache: dict[str, bytes] = {}
        self._freq: dict[str, int] = {}
        self._last: dict[str, int] = {}
        self._tick = 0
        self._resident = 0
        self._cache_lock = threading.Lock()

    @property
    def cache_bytes(self) -> int:
        return self._resident

    def _cacheable(self, name: str) -> bool:
        return name.endswith(self.suffixes)

    def _verify(self, name: str, data: bytes) -> bool:
        # lazy import: scrub/codec sit above this base module
        from repro_torch.storage.codec import CorruptSegment, unframe
        from repro_torch.storage.scrub import expected_kind
        try:
            unframe(data, expected_kind(name))
        except (CorruptSegment, ValueError):
            return False
        return True

    def _evict_to_cap(self) -> None:
        # caller holds _cache_lock
        while self._resident > self.cap_bytes and self._cache:
            victim = min(self._cache,
                         key=lambda n: (self._freq[n], self._last[n]))
            self._resident -= len(self._cache.pop(victim))
            self._freq.pop(victim, None)
            self._last.pop(victim, None)
            self.cache_evictions += 1

    def _drop(self, name: str) -> None:
        with self._cache_lock:
            data = self._cache.pop(name, None)
            if data is not None:
                self._resident -= len(data)
            self._freq.pop(name, None)
            self._last.pop(name, None)

    def invalidate_base(self, base: str) -> int:
        """Drop every cached block of segment family ``base`` (matches
        ``base.*`` and delete-generation descendants ``base_dN.*``);
        returns how many blocks were dropped."""
        n = 0
        with self._cache_lock:
            for name in list(self._cache):
                stem = name.rsplit(".", 1)[0]
                if stem == base or stem.startswith(base + "_"):
                    self._resident -= len(self._cache.pop(name))
                    self._freq.pop(name, None)
                    self._last.pop(name, None)
                    n += 1
        return n

    # -- Directory ops ------------------------------------------------------
    def _read(self, name):
        if not self._cacheable(name):
            return self.inner.read_file(name)
        with self._cache_lock:
            self._tick += 1
            tick = self._tick
            data = self._cache.get(name)
            if data is not None:
                self.cache_hits += 1
                self._freq[name] = self._freq.get(name, 0) + 1
                self._last[name] = tick
                return data
            self.cache_misses += 1
        data = self.inner.read_file(name)
        if len(data) <= self.cap_bytes and self._verify(name, data):
            with self._cache_lock:
                if name not in self._cache:
                    self._cache[name] = data
                    self._resident += len(data)
                self._freq[name] = self._freq.get(name, 0) + 1
                self._last[name] = tick
                self._evict_to_cap()
        else:
            with self._cache_lock:
                self.cache_rejected += 1
        return data

    def _write(self, name, data):
        self._drop(name)
        self.inner.write_file(name, data)

    def _list(self):
        return self.inner._list()

    def _delete(self, name):
        self._drop(name)
        self.inner.delete_file(name)

    def _rename(self, src, dst):
        self._drop(src)
        self._drop(dst)
        self.inner.rename(src, dst)

    def _sync(self, names):
        self.inner.sync(names)

    def _size(self, name):
        return self.inner.file_size(name)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

FAULT_KINDS = ("transient", "persistent", "enospc", "torn", "flip",
               "latency")

# ops a fault can target; "*" in scripted faults matches any of them
_FAULT_OPS = ("write", "read", "list", "delete", "rename", "sync", "size")


class FaultInjectingDirectory(Directory):
    """A Directory wrapper that makes the media *fail* on purpose.

    Real NAS mounts, disk arrays, and SSDs throw transient EIO, run out
    of space, tear writes, rot bits, and stall — the paper's envelope
    only holds on the runs that survive them. This wrapper injects those
    faults either **seeded** (per-op probabilities drawn from one RNG,
    reproducible by seed) or **scripted** (``fail_next``/``fail_always``/
    ``corrupt_file`` for deterministic tests):

      transient   op raises ``OSError(EIO)``; the same op on the same
                  name heals after ``transient_repeat`` consecutive
                  failures, so capped retries provably recover.
      persistent  op raises ``OSError(EIO)`` forever (``fail_always``).
      enospc      write-side op raises ``OSError(ENOSPC)`` once — the
                  non-retryable class a RetryPolicy must refuse.
      torn        ``_write`` stores a strict prefix of the data, then
                  raises — the on-media state a kill mid-write leaves.
      flip        after a successful write, one random bit of the stored
                  bytes is flipped *silently* (no exception) — bit rot
                  that only crc32 validation can catch.
      latency     the op sleeps ``latency_s`` before proceeding.

    Fault and op counts land in ``injected``/``op_counts`` next to the
    byte/wall accounting every Directory already keeps. ``armed=False``
    pauses all injection (setup/teardown phases of a test).
    """

    def __init__(self, inner: Directory, seed: int = 0, *,
                 p_transient: float = 0.0, p_torn: float = 0.0,
                 p_enospc: float = 0.0, p_flip: float = 0.0,
                 p_latency: float = 0.0, latency_s: float = 0.001,
                 transient_repeat: int = 1):
        super().__init__()
        self.inner = inner
        self.p_transient = p_transient
        self.p_torn = p_torn
        self.p_enospc = p_enospc
        self.p_flip = p_flip
        self.p_latency = p_latency
        self.latency_s = latency_s
        self.transient_repeat = max(1, int(transient_repeat))
        self.armed = True
        self.injected = {k: 0 for k in FAULT_KINDS}
        self.op_counts = {op: 0 for op in _FAULT_OPS}
        self._rng = random.Random(seed)
        self._fault_lock = threading.Lock()
        # (op, name) -> [kind, remaining_failures]: a drawn fault replays
        # deterministically until exhausted, so retries are bounded
        self._pending: dict[tuple, list] = {}
        self._scripted: list[dict] = []   # fail_next queue, FIFO
        self._always: list[tuple] = []    # (op_or_*, name_substr)

    # -- scripting ----------------------------------------------------------
    def fail_next(self, op: str = "*", kind: str = "transient",
                  times: int = 1, name_substr: str = "") -> None:
        """Queue ``times`` deterministic faults for the next matching ops."""
        if kind not in ("transient", "persistent", "enospc", "torn"):
            raise ValueError(f"unknown scripted fault kind {kind!r}")
        with self._fault_lock:
            self._scripted.append({"op": op, "kind": kind,
                                   "times": int(times),
                                   "name": name_substr})

    def fail_always(self, op: str = "*", name_substr: str = "") -> None:
        """Every matching op fails persistently from now on."""
        with self._fault_lock:
            self._always.append((op, name_substr))

    def clear_faults(self) -> None:
        with self._fault_lock:
            self._scripted.clear()
            self._always.clear()
            self._pending.clear()

    def corrupt_file(self, name: str, bit: int | None = None) -> int:
        """Flip one bit of ``name``'s stored bytes right now (post-commit
        bit rot); returns the flipped bit index."""
        data = bytearray(self.inner.read_file(name))
        if not data:
            raise ValueError(f"cannot corrupt empty file {name!r}")
        if bit is None:
            bit = self._rng.randrange(len(data) * 8)
        data[bit // 8] ^= 1 << (bit % 8)
        self.inner.write_file(name, bytes(data))
        with self._fault_lock:
            self.injected["flip"] += 1
        return bit

    # -- fault engine -------------------------------------------------------
    def _count(self, kind):
        self.injected[kind] += 1

    def _match(self, spec_op, spec_name, op, name):
        return (spec_op in ("*", op)) and (spec_name in name)

    def _gate(self, op: str, name: str, writeish: bool) -> str | None:
        """Count the op; raise/sleep per scripted then seeded faults.
        Returns "torn" when the caller (``_write``) must tear the write."""
        with self._fault_lock:
            self.op_counts[op] += 1
            if not self.armed:
                return None
            # scripted faults take precedence: deterministic by order
            for spec in self._scripted:
                if spec["times"] > 0 and self._match(spec["op"],
                                                    spec["name"], op, name):
                    spec["times"] -= 1
                    kind = spec["kind"]
                    if kind == "torn" and op != "write":
                        kind = "transient"
                    self._count(kind if kind != "persistent"
                                else "persistent")
                    if kind == "torn":
                        return "torn"
                    if kind == "enospc":
                        raise OSError(errno.ENOSPC,
                                      f"injected ENOSPC: {op} {name}")
                    raise OSError(errno.EIO,
                                  f"injected {kind} fault: {op} {name}")
            for spec_op, spec_name in self._always:
                if self._match(spec_op, spec_name, op, name):
                    self._count("persistent")
                    raise OSError(errno.EIO,
                                  f"injected persistent fault: {op} {name}")
            # seeded faults: one pending state per (op, name). A drawn
            # fault fails exactly `remaining` consecutive attempts; the
            # attempt after that succeeds deterministically (no fresh
            # draw), so a retry cap >= transient_repeat provably heals.
            key = (op, name)
            st = self._pending.get(key)
            if st is not None and st[1] <= 0:
                del self._pending[key]   # healed: this attempt succeeds
            elif st is None:
                r = self._rng.random()
                if writeish and r < self.p_torn:
                    st = ["torn", self.transient_repeat]
                elif writeish and r < self.p_torn + self.p_enospc:
                    st = ["enospc", 1]
                elif r < self.p_torn + self.p_enospc + self.p_transient:
                    st = ["transient", self.transient_repeat]
                if st is not None:
                    self._pending[key] = st
            if st is not None and st[1] > 0:
                st[1] -= 1
                kind = st[0]
                self._count(kind)
                if kind == "torn":
                    return "torn"
                if kind == "enospc":
                    raise OSError(errno.ENOSPC,
                                  f"injected ENOSPC: {op} {name}")
                raise OSError(errno.EIO,
                              f"injected transient fault: {op} {name}")
            spike = (self.p_latency > 0
                     and self._rng.random() < self.p_latency)
            if spike:
                self._count("latency")
        if spike:
            time.sleep(self.latency_s)
        return None

    # -- Directory ops ------------------------------------------------------
    def _write(self, name, data):
        verdict = self._gate("write", name, writeish=True)
        if verdict == "torn":
            cut = self._rng.randrange(len(data)) if len(data) else 0
            self.inner.write_file(name, data[:cut])
            raise OSError(errno.EIO, f"injected torn write: {name}")
        self.inner.write_file(name, data)
        if self.armed and self.p_flip and self._rng.random() < self.p_flip:
            self.corrupt_file(name)

    def _read(self, name):
        self._gate("read", name, writeish=False)
        return self.inner.read_file(name)

    def _list(self):
        self._gate("list", "", writeish=False)
        return self.inner._list()

    def _delete(self, name):
        self._gate("delete", name, writeish=True)
        self.inner.delete_file(name)

    def _rename(self, src, dst):
        self._gate("rename", dst, writeish=True)
        self.inner.rename(src, dst)

    def _sync(self, names):
        self._gate("sync", ";".join(names), writeish=True)
        self.inner.sync(names)

    def _size(self, name):
        self._gate("size", name, writeish=False)
        return self.inner.file_size(name)

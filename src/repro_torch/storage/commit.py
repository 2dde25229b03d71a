"""Commit points: ``segments_N`` manifests, two-phase rename, recovery.

Lucene's durability contract, reproduced: segment files are written
freely (and non-atomically — a crash can tear them), but a segment only
*exists* once a ``segments_N`` manifest references it, and the manifest
itself appears atomically via two-phase commit:

  1. ``sync`` every data file the manifest will reference (one batched
     durability barrier — writes themselves never fsync),
  2. write ``segments_N.tmp`` (framed + checksummed like every file),
  3. ``rename`` it to ``segments_N`` (atomic ``os.replace``).

``open_latest`` recovers by scanning for the highest N whose manifest
frame validates AND whose referenced segments all decode checksum-clean;
anything else — torn segment files from a killed flush, a stranded
``.tmp``, a manifest that lost the race with the power cord — is ignored
and the previous commit wins. Every committed doc is therefore searchable
exactly once after recovery; uncommitted work is simply re-indexed.

Tombstones ride the same protocol as *delete generations*: a segment's
bitmap is committed as a tiny ``<name>_<g>.liv`` file (the segment is
never rewritten), the manifest maps each segment to AT MOST one ``.liv``
generation, and recovery re-attaches it. A crash between a ``.liv``
write and its commit therefore recovers the PREVIOUS delete generation —
deletes, like docs, exist only once a manifest says so.

``SegmentStore`` is the glue the write path uses: it names and writes
segments through a target ``Directory`` (via ``storage/codec``), tracks
encoded sizes (measured bytes, vs ``Segment.total_bytes()``'s model),
charges merge re-reads, rolls ``.liv`` generations forward at commit,
and deletes superseded files (segments AND stale ``.liv``) after each
commit.

This is the JAX package's ``storage/commit.py``. Segment encodes and
decodes run their ``pfor`` streams through the pack/unpack kernels on the
``device`` the caller names. Recovery reads and parses each segment's
files under ``try`` (a torn file, a flaky read or a bad frame skips the commit
or quarantines the segment, as in the JAX package), then unpacks them
OUTSIDE it, and only then assembles them under ``try`` again: a kernel
build, load or launch failure (``ctypes`` raises ``OSError`` when a
library fails to load) propagates instead of being read as corruption.
"""
from __future__ import annotations

import json
import re
import struct
import threading
import time
from dataclasses import dataclass, field

from repro_torch.storage import codec as seg_codec
from repro_torch.storage.codec import (CorruptSegment, KIND_MANIFEST,
                                       decode_liveness, encode_liveness,
                                       frame, unframe, write_segment)
from repro_torch.storage.directory import Directory

MANIFEST_RE = re.compile(r"^segments_(\d+)$")
_SEG_NAME_RE = re.compile(r"^s([0-9a-f]{8})\.")
LIV_NAME_RE = re.compile(r"^(s[0-9a-f]{8})_(\d+)\.liv$")
# every file name this store can produce; recovery cleanup must not touch
# anything else (an --index-dir pointed at a directory with unrelated
# files — or a co-located source spool — must leave them intact)
_OWNED_RE = re.compile(
    r"^(s[0-9a-f]{8}\.(dict|pst|pos|doc)|s[0-9a-f]{8}_\d+\.liv"
    r"|segments_\d+(\.tmp)?)$")


def manifest_name(gen: int) -> str:
    return f"segments_{gen}"


def liv_name(base: str, gen: int) -> str:
    return f"{base}_{gen}.liv"


def write_commit(directory: Directory, gen: int, names: list[str],
                 codec: str = "pfor", liv: dict = None,
                 doc_counts: dict = None, quarantined: dict = None,
                 ts: float = None) -> str:
    """Two-phase commit of one manifest; returns its file name. ``liv``
    maps a segment base name to its current delete-generation file.
    ``doc_counts`` (base name -> n_docs) makes a future quarantine's
    missing-doc count exact; ``quarantined`` (base name -> n_docs or
    None) carries forward segments already lost to corruption, so a
    degraded index stays honest about its holes across commits.

    Durability barrier first: every data file the manifest references —
    the four files of each segment plus any ``.liv`` — is synced in ONE
    batch, then the manifest tmp is synced, then renamed into place. A
    manifest can thus never outlive the bytes it points at, and the
    protocol pays fsync once per commit instead of once per write."""
    liv = dict(liv or {})
    # wall-clock commit stamp: the replication layer's lag reference
    # (a replica's replication_lag_s = install time - manifest ts)
    payload = json.dumps({"gen": gen, "codec": codec,
                          "segments": list(names), "liv": liv,
                          "doc_counts": dict(doc_counts or {}),
                          "quarantined": dict(quarantined or {}),
                          "ts": time.time() if ts is None else ts},
                         sort_keys=True).encode()
    name = manifest_name(gen)
    data_files = [n + sfx for n in names
                  for sfx in seg_codec.SEGMENT_SUFFIXES]
    data_files += sorted(liv.values())
    directory.sync(data_files)
    directory.write_file(name + ".tmp", frame(KIND_MANIFEST, payload))
    directory.sync([name + ".tmp"])
    directory.rename(name + ".tmp", name)
    # the rename's dirent must itself survive a crash before the commit
    # is acknowledged (FSDirectory syncs the directory inode too)
    directory.sync([name])
    return name


def read_commit(directory: Directory, name: str) -> dict:
    meta = json.loads(unframe(directory.read_file(name), KIND_MANIFEST))
    if not isinstance(meta.get("segments"), list):
        raise CorruptSegment(f"manifest {name} has no segment list")
    liv = meta.setdefault("liv", {})  # pre-lifecycle manifests lack it
    if not isinstance(liv, dict):
        raise CorruptSegment(f"manifest {name} has a malformed liv map")
    for k in ("doc_counts", "quarantined"):  # pre-fault-tolerance manifests
        if not isinstance(meta.setdefault(k, {}), dict):
            raise CorruptSegment(f"manifest {name} has a malformed {k} map")
    meta.setdefault("ts", 0.0)   # pre-replication manifests lack the stamp
    return meta


def list_commits(directory: Directory) -> list[int]:
    """Commit generations present (not yet validated), newest first."""
    gens = [int(m.group(1)) for m in map(MANIFEST_RE.match,
                                         directory.list_files()) if m]
    return sorted(gens, reverse=True)


@dataclass
class RecoveryInfo:
    """What recovery had to step around: skipped commits, flaky reads,
    and — in degraded mode — segments quarantined for corruption."""

    commits_skipped: int = 0
    io_errors: int = 0
    # base name -> committed n_docs (None when the manifest predates
    # doc_counts and the loss size is unknown)
    quarantined: dict = field(default_factory=dict)

    @property
    def degraded(self) -> bool:
        return bool(self.quarantined)

    @property
    def missing_docs(self) -> int:
        return sum(int(v or 0) for v in self.quarantined.values())


# what the commit walk survives: checksum/shape corruption from torn
# writes and bit rot, plus (satellite of the fault-tolerance PR) any
# OSError from a flaky read — a transient EIO mid-walk must send
# recovery to the next-oldest commit, not kill it. FileNotFoundError and
# RetriesExhausted are OSErrors, so one class covers all of them.
_RECOVERY_SKIP = (CorruptSegment, json.JSONDecodeError, struct.error,
                  OSError)


def _load_segment(directory, meta, n, device):
    """Committed segment ``n`` with its tombstones attached, as
    ``(segment, None)``, or ``(None, error)`` when a torn file, a flaky
    read or a bad frame (``_RECOVERY_SKIP``) makes it unreadable. Its
    ``pfor`` streams unpack between the two ``try`` blocks, so a kernel
    failure propagates."""
    try:
        parsed = seg_codec.parse_segment(
            seg_codec.read_segment_files(directory, n))
        lname = meta["liv"].get(n)
        liv = None if lname is None else directory.read_file(lname)
    except _RECOVERY_SKIP as e:
        return None, e
    unpacked = seg_codec.unpack_segment(parsed, device)
    try:
        seg = seg_codec.finish_segment(parsed, unpacked)
        if liv is not None:
            mask = decode_liveness(liv, seg.n_docs)
            seg = seg.with_deletes(seg.doc_ids[mask])
    except _RECOVERY_SKIP as e:
        return None, e
    return seg, None


def _count_skip(info: "RecoveryInfo", e: BaseException) -> None:
    if isinstance(e, OSError) and not isinstance(e, FileNotFoundError):
        info.io_errors += 1
    info.commits_skipped += 1


def _open_latest_full(directory: Directory, degraded: bool = False,
                      info: RecoveryInfo = None, device=None
                      ) -> tuple[int, list, list, dict, RecoveryInfo]:
    """Newest usable commit as ``(gen, segments, names, liv, info)`` —
    shared by ``open_latest`` and ``SegmentStore.open`` so the manifest
    is read (and its bytes charged to the device) exactly once. Each
    segment's committed delete generation is decoded and re-attached
    (``with_deletes``).

    Strict mode (default): a missing/torn segment or ``.liv`` — or a
    flaky read (any ``OSError``) — invalidates the whole commit and the
    walk continues to the next-oldest manifest; partial commits never
    surface partially.

    Degraded mode: when no commit fully validates (the common post-rot
    shape — older manifests are deleted at each commit, so falling back
    usually means losing *everything*), the newest commit whose manifest
    frame validates is served anyway: each unreadable segment is
    quarantined in ``info.quarantined`` (with its committed doc count
    when the manifest records one) and the rest are loaded. Segments the
    manifest itself lists as previously quarantined stay quarantined
    either way.

    Each segment's ``pfor`` streams unpack in one launch on ``device``,
    outside every ``try``.
    """
    info = info if info is not None else RecoveryInfo()
    gens = list_commits(directory)
    chosen = None
    for gen in gens:
        try:
            meta = read_commit(directory, manifest_name(gen))
        except _RECOVERY_SKIP as e:
            _count_skip(info, e)
            continue
        segs = []
        for n in meta["segments"]:
            seg, err = _load_segment(directory, meta, n, device)
            if err is not None:
                _count_skip(info, err)
                break
            segs.append(seg)
        else:
            chosen = (gen, segs, list(meta["segments"]), dict(meta["liv"]),
                      meta)
            break
    if degraded and gens and (chosen is None or chosen[0] != gens[0]):
        newer = [g for g in gens if chosen is None or g > chosen[0]]
        for gen in newer:
            try:
                meta = read_commit(directory, manifest_name(gen))
            except _RECOVERY_SKIP:
                continue  # already counted by the strict walk
            segs, names, liv, quar = [], [], {}, {}
            for n in meta["segments"]:
                seg, err = _load_segment(directory, meta, n, device)
                if err is not None:
                    quar[n] = meta["doc_counts"].get(n)
                    continue
                segs.append(seg)
                names.append(n)
                if meta["liv"].get(n) is not None:
                    liv[n] = meta["liv"][n]
            # an all-casualty commit is no better than the strict pick
            if segs or chosen is None:
                info.quarantined.update(quar)
                chosen = (gen, segs, names, liv, meta)
            break
    if chosen is None:
        return 0, [], [], {}, info
    gen, segs, names, liv, meta = chosen
    for n, count in meta["quarantined"].items():
        info.quarantined.setdefault(n, count)
    return gen, segs, names, liv, info


def open_latest(directory: Directory, device=None) -> tuple[int, list]:
    """Load the newest fully-valid commit point: ``(gen, segments)``.

    Walks commits newest-first; a commit whose manifest or any referenced
    segment file fails its checksum (torn by an interrupted run) — or
    throws a flaky-read ``OSError`` — is skipped entirely. An empty
    or never-committed directory recovers to ``(0, [])``. Recovered
    segments carry their committed tombstone bitmaps. ``pfor`` streams
    unpack on ``device`` (None: CUDA).
    """
    gen, segs, _, _, _ = _open_latest_full(directory, device=device)
    return gen, segs


def open_latest_degraded(directory: Directory, device=None
                         ) -> tuple[int, list, RecoveryInfo]:
    """Like ``open_latest``, but a commit with corrupt segments is served
    minus its casualties instead of abandoned: returns ``(gen, segments,
    info)`` where ``info.quarantined``/``info.missing_docs`` name the
    holes. Identical to the strict walk whenever everything validates."""
    gen, segs, _, _, info = _open_latest_full(directory, degraded=True,
                                              device=device)
    return gen, segs, info


def open_searcher(directory: Directory, reader_cache=None,
                  degraded: bool = False):
    """Recovery straight to the read path: load the latest commit and
    refresh a ``ReaderCache`` over it (loaded segments get fresh seg_ids,
    so the cache treats them like any live segment set). With
    ``degraded=True`` a partially-corrupt commit serves its surviving
    segments and the searcher carries ``degraded``/``missing_docs``. The
    segments decode on the cache's device."""
    from repro_torch.core.searcher import ReaderCache
    cache = reader_cache if reader_cache is not None else ReaderCache()
    if degraded:
        gen, segs, info = open_latest_degraded(directory, cache.device)
        return gen, cache.refresh(segs, recovery=info)
    gen, segs = open_latest(directory, cache.device)
    return gen, cache.refresh(segs)


@dataclass
class SegmentStore:
    """Write-path glue between the merge driver and a target Directory.

    Segments are written *before* they become live (flush installs after
    ``write``; a merge installs its output after writing it), so a commit
    of ``live_segments()`` only ever references fully-written files.

    Deletion protocol: a file may only be deleted once its segment has
    been *superseded* — the merge driver calls ``mark_superseded`` on a
    merge's inputs after installing the output, the one event after which
    a segment can never be referenced by a future commit — AND it is not
    referenced by the newest manifest (a commit whose snapshot predates
    the install still references the inputs; their files survive until
    the next commit). A segment that is merely written-but-not-yet-live
    (a flush or merge output racing a commit) is never superseded, so it
    can never be deleted out from under the thread installing it.
    """

    directory: Directory
    codec: str = "pfor"
    device: object = None            # where pfor streams pack (None: CUDA)
    gen: int = 0
    bytes_encoded_written: int = 0   # cumulative, flush + merges + .liv
    bytes_encoded_read: int = 0      # merge re-reads through the directory
    n_commits: int = 0
    heals: int = 0                   # quarantined segs rewritten from memory
    # base name -> committed n_docs (or None): segments lost to corruption,
    # excluded from commits but carried in every manifest so degraded
    # serving stays honest; fed by degraded recovery and the scrubber
    quarantined: dict = field(default_factory=dict)
    recovery: RecoveryInfo = None
    _counter: int = 0
    _names: dict = field(default_factory=dict)   # seg_id -> file base name
    _doc_counts: dict = field(default_factory=dict)  # base name -> n_docs
    _sizes: dict = field(default_factory=dict)   # base/liv name -> bytes
    _suffix_sizes: dict = field(default_factory=dict)  # base -> {sfx: bytes}
    _superseded: set = field(default_factory=set)  # names eligible to delete
    # delete generations, per base name: the monotone bitmap makes the
    # deleted-doc COUNT a sufficient fingerprint for "changed since the
    # last written .liv"
    _liv_gen: dict = field(default_factory=dict)   # base -> last gen int
    _liv_file: dict = field(default_factory=dict)  # base -> current file
    _liv_count: dict = field(default_factory=dict)  # base -> n_deleted
    _liv_dead: set = field(default_factory=set)    # superseded .liv files
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @classmethod
    def open(cls, directory: Directory, codec: str = "pfor",
             degraded: bool = False, device=None
             ) -> tuple["SegmentStore", list]:
        """Recover a store over an existing directory: load the latest
        commit, register its segments and their committed ``.liv``
        generations, delete every unreferenced store-owned file (stray
        tmp manifests, torn post-commit flushes, orphan delete
        generations — there are no concurrent writers during recovery, so
        cleanup is safe here). Files the store could not have written
        (spooled source batches, anything else living in the directory)
        are left untouched. ``degraded=True`` lets a partially-corrupt
        newest commit recover minus its casualties (quarantined, their
        files preserved as evidence) instead of falling back."""
        gen, segs, names, liv, info = _open_latest_full(
            directory, degraded=degraded, device=device)
        store = cls(directory=directory, codec=codec, device=device,
                    gen=gen)
        store.recovery = info
        store.quarantined = dict(info.quarantined)
        keep = set()
        if gen:
            for seg, name in zip(segs, names):
                store._names[seg.seg_id] = name
                store._doc_counts[name] = seg.n_docs
                store._suffix_sizes[name] = {
                    sfx: directory.file_size(name + sfx)
                    for sfx in seg_codec.SEGMENT_SUFFIXES}
                store._sizes[name] = sum(
                    store._suffix_sizes[name].values())
                keep.update(name + sfx
                            for sfx in seg_codec.SEGMENT_SUFFIXES)
                lname = liv.get(name)
                if lname is not None:
                    m = LIV_NAME_RE.match(lname)
                    store._liv_gen[name] = int(m.group(2)) if m else 0
                    store._liv_file[name] = lname
                    store._liv_count[name] = seg.n_deleted
                    store._sizes[lname] = directory.file_size(lname)
                    keep.add(lname)
            keep.add(manifest_name(gen))
        # a quarantined segment's files are evidence, not garbage: keep
        # every file belonging to a quarantined base name
        for qname in store.quarantined:
            keep.update(qname + sfx for sfx in seg_codec.SEGMENT_SUFFIXES)
            keep.update(f for f in directory.list_files()
                        if (m := LIV_NAME_RE.match(f))
                        and m.group(1) == qname)
        for f in directory.list_files():
            if f not in keep and _OWNED_RE.match(f):
                directory.delete_file(f)
        counters = [int(m.group(1), 16) for m in
                    map(_SEG_NAME_RE.match, directory.list_files()) if m]
        store._counter = max(counters, default=-1) + 1
        return store, segs

    def relabel(self, old_seg, new_seg) -> None:
        """``new_seg`` is a ``with_deletes`` copy that took over
        ``old_seg``'s place in the live set: map the new seg_id onto the
        same on-disk base name (the four core files are shared — only the
        ``.liv`` generation, written at the next commit, differs). The
        old mapping survives, because a commit snapshot taken before the
        swap may still reference the old object."""
        with self._lock:
            name = self._names.get(old_seg.seg_id)
            if name is not None:
                self._names[new_seg.seg_id] = name

    def size_of(self, name: str) -> int:
        """Encoded bytes of a written segment (or .liv) by name."""
        with self._lock:
            return self._sizes.get(name, 0)

    def write(self, seg) -> str:
        """Encode + write one segment; returns its on-disk base name.
        Registration happens only after the write completes, so a commit
        concurrent with this write cannot reference a torn segment."""
        with self._lock:
            name = f"s{self._counter:08x}"
            self._counter += 1
        n = write_segment(self.directory, name, seg, self.codec,
                          self.device)
        by_sfx = {sfx: self.directory.file_size(name + sfx)
                  for sfx in seg_codec.SEGMENT_SUFFIXES}
        with self._lock:
            self._names[seg.seg_id] = name
            self._doc_counts[name] = seg.n_docs
            self._sizes[name] = n
            self._suffix_sizes[name] = by_sfx
            self.bytes_encoded_written += n
        return name

    def read_back(self, segs) -> int:
        """Re-read segments' files through the directory (a merge re-reads
        its inputs — the measured counterpart of ``bytes_read_merge``).
        Bytes move and get charged; content is discarded, the in-memory
        Segment is authoritative."""
        total = 0
        for seg in segs:
            with self._lock:
                name = self._names.get(seg.seg_id)
            if name is None:
                continue  # segment predates the store attachment
            for sfx in seg_codec.SEGMENT_SUFFIXES:
                total += len(self.directory.read_file(name + sfx))
        with self._lock:
            self.bytes_encoded_read += total
        return total

    def quarantine(self, file_name: str) -> bool:
        """Mark the segment owning ``file_name`` (a base name, one of its
        suffixed files, or a ``.liv``) as corrupt-on-media. Its files are
        preserved but it will never be referenced by a future commit —
        unless the segment is still live in memory, in which case the
        next ``commit`` rewrites it under a fresh name (self-heal).
        Returns True when this is a new quarantine. Fed by the checksum
        scrubber and by degraded recovery."""
        m = LIV_NAME_RE.match(file_name)
        base = m.group(1) if m else file_name.split(".", 1)[0]
        with self._lock:
            if base in self.quarantined:
                return False
            self.quarantined[base] = self._doc_counts.get(base)
            return True

    def mark_superseded(self, segs) -> None:
        """Record that ``segs`` left the live set permanently (their merge
        output has been installed). Only superseded segments' files are
        ever deleted — the merge driver calls this after install."""
        with self._lock:
            for seg in segs:
                name = self._names.get(seg.seg_id)
                if name is not None:
                    self._superseded.add(name)

    def encoded_bytes_live(self, segs) -> int:
        """Encoded size of a segment set (measured files, not the model),
        including each segment's current delete-generation file."""
        with self._lock:
            total = 0
            for s in segs:
                name = self._names.get(s.seg_id)
                if name is None:
                    continue
                total += self._sizes.get(name, 0)
                lname = self._liv_file.get(name)
                if lname is not None:
                    total += self._sizes.get(lname, 0)
            return total

    def encoded_bytes_by_suffix(self, segs) -> dict:
        """Per-file-kind breakdown of ``encoded_bytes_live``: measured
        bytes-on-media of a segment set keyed by suffix (``.dict`` /
        ``.pst`` / ``.pos`` / ``.doc``, plus ``.liv`` for current delete
        generations) — where the codec actually spends its bytes."""
        with self._lock:
            out = {sfx: 0 for sfx in seg_codec.SEGMENT_SUFFIXES}
            out[".liv"] = 0
            for s in segs:
                name = self._names.get(s.seg_id)
                if name is None:
                    continue
                for sfx, n in self._suffix_sizes.get(name, {}).items():
                    out[sfx] += n
                lname = self._liv_file.get(name)
                if lname is not None:
                    out[".liv"] += self._sizes.get(lname, 0)
            return out

    def commit(self, live_segments) -> int:
        """Durably publish ``live_segments`` as commit ``gen+1``: roll a
        new ``.liv`` generation for every segment whose bitmap grew since
        the last one (the segment files themselves are never rewritten),
        two-phase-write the manifest referencing exactly one generation
        per segment, then delete files that are superseded AND
        unreferenced by this manifest — dead segments, stale ``.liv``
        generations, and all older manifests.

        Self-heal: a live segment whose on-media copy was quarantined
        (scrubber-detected rot) is rewritten from memory under a fresh
        name first — the in-memory Segment is authoritative, so a live
        writer recovers from bit rot with zero loss; the corrupt files
        are superseded and deleted like any dead segment's."""
        live_segments = list(live_segments)
        with self._lock:
            quarantined_now = set(self.quarantined)
        if quarantined_now:
            for s in live_segments:
                with self._lock:
                    old = self._names.get(s.seg_id)
                if old in quarantined_now:
                    self.write(s)   # re-registers seg_id under a new name
                    with self._lock:
                        self.quarantined.pop(old, None)
                        self._superseded.add(old)
                        self.heals += 1
        with self._lock:
            try:
                names = [self._names[s.seg_id] for s in live_segments]
            except KeyError as e:
                raise ValueError("cannot commit a segment this store never "
                                 f"wrote (seg_id {e.args[0]})") from e
            self.gen += 1
            gen = self.gen
            to_write, liv = [], {}
            for s, name in zip(live_segments, names):
                if not s.has_deletes:
                    continue
                if self._liv_count.get(name) != s.n_deleted:
                    to_write.append((name, self._liv_gen.get(name, 0) + 1,
                                     s.deletes))
                else:
                    liv[name] = self._liv_file[name]
        # like segment files, a .liv is REGISTERED only after its write
        # completed — a failed write leaves the previous generation
        # current, and the next commit simply retries
        for name, g, mask in to_write:
            fname = liv_name(name, g)
            n = self.directory.write_file(fname, encode_liveness(mask))
            with self._lock:
                old = self._liv_file.get(name)
                if old is not None:
                    self._liv_dead.add(old)
                self._liv_gen[name] = g
                self._liv_file[name] = fname
                self._liv_count[name] = int(mask.sum())
                self._sizes[fname] = n
                self.bytes_encoded_written += n
                liv[name] = fname
        with self._lock:
            doc_counts = {n: self._doc_counts[n] for n in names
                          if n in self._doc_counts}
            quarantined = dict(self.quarantined)
        write_commit(self.directory, gen, names, self.codec, liv=liv,
                     doc_counts=doc_counts, quarantined=quarantined)
        with self._lock:
            self.n_commits += 1
            live = set(names)
            dead = [n for n in self._superseded if n not in live]
            for n in dead:
                self._superseded.discard(n)
                self._sizes.pop(n, None)
                self._suffix_sizes.pop(n, None)
                self._doc_counts.pop(n, None)
                # a dead segment's delete generation dies with it
                lname = self._liv_file.pop(n, None)
                if lname is not None:
                    self._liv_dead.add(lname)
                self._liv_gen.pop(n, None)
                self._liv_count.pop(n, None)
            gone = set(dead)
            self._names = {sid: n for sid, n in self._names.items()
                           if n not in gone}
            dead_liv = sorted(self._liv_dead)
            self._liv_dead.clear()
            for f in dead_liv:
                self._sizes.pop(f, None)
        for n in dead:
            for sfx in seg_codec.SEGMENT_SUFFIXES:
                try:
                    self.directory.delete_file(n + sfx)
                except FileNotFoundError:
                    pass
        for f in dead_liv:
            try:
                self.directory.delete_file(f)
            except FileNotFoundError:
                pass
        for old in list_commits(self.directory):
            if old < gen:
                try:
                    self.directory.delete_file(manifest_name(old))
                except FileNotFoundError:
                    pass
        return gen

"""Write-ahead log for the ingest buffer — the durability gap closer.

The indexer acks ``index_batch``/``delete`` as soon as the ops are in
its in-memory buffer; segments only reach the Directory at flush and
only become visible at commit. A kill -9 between ack and flush
therefore used to lose acked documents silently — exactly the buffered
write path the incremental-indexing literature calls the
durability-critical piece. The WAL closes that gap:

  * every acked op is first appended as one ``wal_<seq>`` file holding
    one frame-v2 record (``KIND_WAL``, crc32-checked like every other
    frame) and synced *before* the ack;
  * on recovery, records are replayed in sequence order through the
    normal ingest paths — doc-id allocation is deterministic (replay
    order equals original order, ``_next_doc`` resumes from the
    committed max), so every acked doc reappears with its original id,
    exactly once;
  * a torn tail record (the op that was mid-append at the kill) fails
    its crc and is skipped: it was never acked, so nothing is lost;
  * at commit, every record the flushed segments now cover is deleted
    (``truncate_upto``), keeping the log bounded by the commit cadence.

Group commit (``append(sync=False)`` + ``sync_upto``): under concurrent
ingest, one fsync per ack makes the sync barrier THE bottleneck — the
classic database fix is to let concurrent ackers share one barrier.
Appenders write their record file (cheap, page cache) and then wait on
``sync_upto(seq)``: the first waiter becomes the sync LEADER, grabs the
entire unsynced tail, and issues ONE batched ``directory.sync`` for all
of it; followers whose seq the batch covered return without ever
touching the device. Durability semantics per ack are unchanged —
``sync_upto`` returns only once the record is on media — the fsync cost
is just amortized over ``group_acks / group_commits`` records.

Rotation + recycling (the log's own storage hygiene):

  * ``rotate_bytes > 0`` caps every ``wal_N`` file: an acked add batch
    whose framed record would exceed the cap is split row-wise across
    consecutive sequence files (each counted in ``rotations``). The
    split is atomic on replay — every part but the last carries a
    continuation flag, and a group missing any part (the kill landed
    mid-rotation, before the batched sync, so the batch was never
    acked) is dropped whole; a complete group reassembles into the
    original batch, so the acked-doc set still survives exactly.
  * ``recycle_keep > 0``: ``truncate_upto`` RENAMES covered files ahead
    to future sequence slots (up to ``recycle_keep`` parked at a time)
    instead of deleting them — the classic WAL-segment recycling that
    spares the create/delete metadata churn; a later append overwrites
    the parked file when its sequence comes up. Every record embeds its
    own sequence number, so replay detects a parked file still holding
    its pre-rename record (name seq != embedded seq), reclaims it, and
    never replays it as a live op.

Record payloads (little-endian, inside the frame, after a
``u64 seq | u8 flags`` envelope):

  add     ``b"A" | u64 D | u64 L | D*L * i32 tokens``
  delete  ``b"D" | u64 n | n * i64 doc_ids``
"""
from __future__ import annotations

import re
import struct
import threading

import numpy as np

from repro_torch.storage.codec import (_FRAME_OVERHEAD, CorruptSegment,
                                       KIND_WAL, frame, unframe)
from repro_torch.storage.directory import Directory

WAL_RE = re.compile(r"^wal_(\d{10})$")

# per-record envelope: the record's own sequence number (recycling guard —
# a parked file's embedded seq disagrees with its name) + flags
_ENV = struct.Struct("<QB")
_F_CONT = 1          # more parts of this logical op follow at seq + 1
_F_TAIL = 2          # not the first part of its group: replay must never
#                      treat a surviving tail run whose head was lost as
#                      a complete (truncated!) batch
_ADD_HEADER = 17     # b"A" + u64 D + u64 L


def wal_name(seq: int) -> str:
    return f"wal_{seq:010d}"


def encode_wal_add(tokens: np.ndarray) -> bytes:
    tokens = np.asarray(tokens, dtype=np.int32)
    if tokens.ndim != 2:
        raise ValueError(f"wal add expects (D, L) tokens, got "
                         f"{tokens.shape}")
    d, l = tokens.shape
    return (b"A" + struct.pack("<QQ", d, l)
            + tokens.astype("<i4").tobytes())


def encode_wal_delete(doc_ids) -> bytes:
    ids = np.asarray(doc_ids, dtype=np.int64)
    return b"D" + struct.pack("<Q", ids.size) + ids.astype("<i8").tobytes()


def decode_wal(payload: bytes):
    """-> ("add", tokens (D, L) int32) | ("delete", ids int64)."""
    if not payload:
        raise CorruptSegment("empty wal record")
    tag = payload[:1]
    if tag == b"A":
        if len(payload) < 17:
            raise CorruptSegment("wal add header truncated")
        d, l = struct.unpack("<QQ", payload[1:17])
        body = payload[17:]
        if len(body) != d * l * 4:
            raise CorruptSegment(
                f"wal add body {len(body)}B != {d}x{l} i32")
        return "add", np.frombuffer(body, dtype="<i4").reshape(
            d, l).astype(np.int32)
    if tag == b"D":
        if len(payload) < 9:
            raise CorruptSegment("wal delete header truncated")
        (n,) = struct.unpack("<Q", payload[1:9])
        body = payload[9:]
        if len(body) != n * 8:
            raise CorruptSegment(
                f"wal delete body {len(body)}B != {n} i64")
        return "delete", np.frombuffer(body, dtype="<i8").astype(np.int64)
    raise CorruptSegment(f"unknown wal record tag {tag!r}")


class WriteAheadLog:
    """Sequenced one-record-per-file log over a Directory.

    File names (``wal_0000000042``) deliberately do not match the
    commit layer's owned-file pattern, so segment recovery cleanup
    leaves the log alone; only ``truncate_upto`` deletes records.
    """

    def __init__(self, directory: Directory, rotate_bytes: int = 0,
                 recycle_keep: int = 0):
        self.directory = directory
        self.rotate_bytes = int(rotate_bytes)
        self.recycle_keep = int(recycle_keep)
        seqs = self._seqs()
        self._next_seq = (max(seqs) + 1) if seqs else 0
        self.appended = 0
        self.replayed = 0
        self.skipped = 0
        # rotation + recycling counters (envelope_report surfaces these)
        self.rotations = 0          # extra files capped appends spilled into
        self.recycled = 0           # truncated files parked ahead for reuse
        self.recycle_reused = 0     # parked files a later append overwrote
        self.recycle_reclaimed = 0  # stale parked files dropped at replay
        self._recycle_slots: set[int] = set()   # future seqs holding parks
        # group-commit state (see module doc): records appended with
        # sync=False queue here until a sync_upto leader flushes them
        self.group_commits = 0   # batched sync barriers issued
        self.group_acks = 0      # records those barriers made durable
        self.group_max = 0       # largest single group
        self._cond = threading.Condition()
        self._unsynced: list[tuple[int, str]] = []   # (seq, name), ordered
        self._synced_upto = self._next_seq - 1
        self._sync_leader = False

    def _seqs(self) -> list[int]:
        return sorted(int(m.group(1))
                      for n in self.directory.list_files()
                      if (m := WAL_RE.match(n)))

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def _split(self, payload: bytes) -> list[bytes]:
        """Row-wise split of an oversized add record so every framed
        ``wal_N`` file stays under ``rotate_bytes``; anything that cannot
        split (deletes, single-doc adds, uncapped logs) passes through
        whole."""
        cap = self.rotate_bytes
        overhead = _FRAME_OVERHEAD + _ENV.size + _ADD_HEADER
        if (not cap or len(payload) + overhead - _ADD_HEADER <= cap
                or payload[:1] != b"A" or len(payload) < _ADD_HEADER):
            return [payload]
        d, l = struct.unpack("<QQ", payload[1:_ADD_HEADER])
        row = int(l) * 4
        if d <= 1 or row == 0:
            return [payload]
        per = max(1, (cap - overhead) // row)
        body = payload[_ADD_HEADER:]
        return [b"A" + struct.pack("<QQ", min(per, d - s), l)
                + body[s * row:(s + per) * row]
                for s in range(0, int(d), int(per))]

    def append(self, payload: bytes, sync: bool = True) -> int:
        """Write one logical record; returns the sequence number its ack
        barrier must cover (the LAST part, when rotation split it). With
        ``sync`` (default) every part is synced — one batched barrier —
        before returning; a failed write/sync rolls the sequence window
        back (the next append overwrites the torn files), so the
        indexer's never-acked accounting holds. ``sync=False`` defers
        the barrier to a later ``sync_upto(seq)`` (group commit): the
        caller must not ack until that returns."""
        with self._cond:
            parts = self._split(payload)
            first = self._next_seq
            names = []
            # records are framed before the try (part i takes seq first+i)
            records = [frame(KIND_WAL, _ENV.pack(
                first + i, (_F_CONT if i < len(parts) - 1 else 0)
                | (_F_TAIL if i else 0)) + part)
                for i, part in enumerate(parts)]
            try:
                for record in records:
                    seq = self._next_seq
                    name = wal_name(seq)
                    self.directory.write_file(name, record)
                    if seq in self._recycle_slots:
                        self._recycle_slots.discard(seq)
                        self.recycle_reused += 1
                    names.append((seq, name))
                    self._next_seq = seq + 1
                if sync:
                    self.directory.sync([n for _, n in names])
            except BaseException:
                self._next_seq = first   # seqs not consumed, never acked
                raise
            last = names[-1][0]
            self.appended += len(parts)
            self.rotations += len(parts) - 1
            if not sync:
                self._unsynced.extend(names)
            elif not self._unsynced:
                # safe only while nothing earlier awaits its barrier (the
                # watermark asserts everything <= it is durable)
                self._synced_upto = max(self._synced_upto, last)
            return last

    def sync_upto(self, seq: int) -> None:
        """Block until record ``seq`` is durable. The first waiter
        becomes the LEADER: it takes the whole unsynced tail and issues
        one batched ``directory.sync``; every waiter whose record the
        batch covered returns without issuing its own. On a sync failure
        the batch is re-queued (no record is silently marked durable)
        and the error propagates to the leader's caller."""
        while True:
            with self._cond:
                if self._synced_upto >= seq:
                    return
                if self._sync_leader:
                    self._cond.wait(timeout=0.5)
                    continue
                self._sync_leader = True
                batch = self._unsynced
                self._unsynced = []
            try:
                # a record truncate_upto already deleted (its ops were
                # committed durably via the manifest) needs no barrier;
                # re-filter once if a truncation races the existence check
                names = [n for _, n in batch
                         if self.directory.file_exists(n)]
                while True:
                    try:
                        if names:
                            self.directory.sync(names)
                        break
                    except FileNotFoundError:
                        names = [n for n in names
                                 if self.directory.file_exists(n)]
            except BaseException:
                with self._cond:
                    self._unsynced = batch + self._unsynced
                    self._sync_leader = False
                    self._cond.notify_all()
                raise
            with self._cond:
                if batch:
                    self._synced_upto = max(self._synced_upto,
                                            batch[-1][0])
                    self.group_commits += 1
                    self.group_acks += len(batch)
                    self.group_max = max(self.group_max, len(batch))
                self._sync_leader = False
                self._cond.notify_all()

    def replay(self):
        """Yield ``(seq, op, payload)`` for every readable logical record
        in sequence order; corrupt (torn / bit-rotted, never-acked)
        records are counted in ``skipped`` and passed over. A rotated add
        group reassembles into one batch before yielding — or, if ANY
        part is missing/torn (the kill landed before the group's batched
        sync, so it was never acked), the whole group is dropped. Parked
        recycle files still holding their pre-rename record are reclaimed
        (deleted), never replayed."""
        pending: list = []   # buffered token parts of an open add group
        expect = None        # seq the open group needs next
        for seq in self._seqs():
            self._next_seq = max(self._next_seq, seq + 1)
            try:
                data = self.directory.read_file(wal_name(seq))
                payload = unframe(data, KIND_WAL)
                if len(payload) < _ENV.size:
                    raise CorruptSegment("wal envelope truncated")
                env_seq, flags = _ENV.unpack_from(payload)
                if env_seq != seq:
                    # a recycled slot parked ahead by truncate_upto: its
                    # stale record was already covered by a commit
                    self.recycle_reclaimed += 1
                    try:
                        self.directory.delete_file(wal_name(seq))
                    except FileNotFoundError:
                        pass
                    continue
                op, body = decode_wal(payload[_ENV.size:])
            except (CorruptSegment, FileNotFoundError):
                self.skipped += 1 + len(pending)
                pending, expect = [], None
                continue
            if expect is not None and (seq != expect or op != "add"
                                       or not flags & _F_TAIL):
                # the group's run broke: its sync never completed
                self.skipped += len(pending)
                pending, expect = [], None
            if flags & _F_TAIL and expect is None:
                # a continuation whose head was lost (torn / missing):
                # the group was never acked — drop the orphan instead of
                # replaying a tail slice as a complete batch
                self.skipped += 1
                continue
            if flags & _F_CONT:
                if op != "add":   # only adds rotate; anything else is rot
                    self.skipped += 1 + len(pending)
                    pending, expect = [], None
                    continue
                pending.append(body)
                expect = seq + 1
                continue
            if pending:
                body = np.concatenate(pending + [body], axis=0)
                pending, expect = [], None
            self.replayed += 1
            yield seq, op, body
        self.skipped += len(pending)   # group ran off the log's tail

    def truncate_upto(self, seq: int) -> int:
        """Retire every record with sequence <= ``seq`` (they are covered
        by flushed-and-committed segments); returns how many. With
        ``recycle_keep`` the first files retired while fewer than that
        many parks are outstanding are RENAMED ahead to future sequence
        slots instead of deleted — a later append overwrites the parked
        file in place."""
        n = 0
        with self._cond:
            for s in self._seqs():
                if s > seq:
                    break
                name = wal_name(s)
                try:
                    if (self.recycle_keep
                            and len(self._recycle_slots) < self.recycle_keep
                            and s not in self._recycle_slots):
                        slot = max([self._next_seq]
                                   + [p + 1 for p in self._recycle_slots])
                        self.directory.rename(name, wal_name(slot))
                        self._recycle_slots.add(slot)
                        self.recycled += 1
                    else:
                        self.directory.delete_file(name)
                    n += 1
                except FileNotFoundError:
                    pass
        return n

"""Durable segment storage: Directory media seam + codec + commit points.

The storage subsystem turns the envelope model's *predicted* media
behavior into something measured: segments become checksummed bytes
written through a ``Directory`` (RAM / filesystem / bandwidth-throttled
media emulation), commits make them durable, recovery reloads them.

The fault-tolerance layer hardens the same seam: inject faults
(``FaultInjectingDirectory``), retry past transient ones
(``RetryPolicy``/``RetryingDirectory``), log acked ingest before it is
flushed (``wal``), serve a partially-corrupt commit minus its
quarantined casualties (``open_latest_degraded``), and scrub committed
frames for bit rot in the background (``ChecksumScrubber``).

The port's copy of the JAX package's ``repro.storage``, with the same
exports; ``pfor`` streams go through the port's pack/unpack kernels.
"""
from repro_torch.storage.codec import (
    AUTO, CODECS, CorruptSegment, SEGMENT_SUFFIXES, decode_liveness,
    decode_segment, encode_liveness, encode_segment, read_segment,
    stream_codec_name, write_segment)
from repro_torch.storage.commit import (
    RecoveryInfo, SegmentStore, list_commits, liv_name, open_latest,
    open_latest_degraded, open_searcher, read_commit, write_commit)
from repro_torch.storage.directory import (
    MEDIA_PROFILES, CachingDirectory, DeviceThrottle, Directory,
    FaultInjectingDirectory, FSDirectory, MediaProfile, RAMDirectory,
    ThrottledDirectory, VolatileDirectory)
from repro_torch.storage.retry import (
    RetriesExhausted, RetryingDirectory, RetryPolicy, is_transient_error)
from repro_torch.storage.scrub import (
    ChecksumScrubber, expected_kind, throttle_saturation_gate)
from repro_torch.storage.wal import (
    WriteAheadLog, decode_wal, encode_wal_add, encode_wal_delete)

__all__ = [
    "AUTO", "CODECS", "CorruptSegment", "SEGMENT_SUFFIXES",
    "decode_liveness", "decode_segment", "encode_liveness",
    "encode_segment", "read_segment", "stream_codec_name", "write_segment",
    "RecoveryInfo", "SegmentStore", "list_commits", "liv_name",
    "open_latest", "open_latest_degraded", "open_searcher", "read_commit",
    "write_commit",
    "MEDIA_PROFILES", "CachingDirectory", "DeviceThrottle", "Directory",
    "FaultInjectingDirectory", "FSDirectory", "MediaProfile",
    "RAMDirectory", "ThrottledDirectory", "VolatileDirectory",
    "RetriesExhausted", "RetryingDirectory", "RetryPolicy",
    "is_transient_error",
    "ChecksumScrubber", "expected_kind", "throttle_saturation_gate",
    "WriteAheadLog", "decode_wal", "encode_wal_add", "encode_wal_delete",
]

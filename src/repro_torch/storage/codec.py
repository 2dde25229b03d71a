"""Versioned on-disk segment codec: delta streams behind a codec registry.

Pibiri & Venturini's survey point carried into practice: the codec decides
how many bytes actually cross the device, so the storage layer offers the
survey's menu behind one ``codec=`` seam (the stream codec id is stored
per stream, so readers need no out-of-band knob):

  ``raw``       plain int64 — the incompressible baseline
  ``pfor``      128-lane blocks bit-packed at each block's max width via
                the ``kernels/postings_pack`` bit-plane transpose (the
                pack kernel on a CUDA device, its plain version on the
                CPU), compacted to ``sum(bw) * 16`` bytes
                (``compact_planes``) — the device-kernel layout
  ``adaptive``  per-sub-block adaptive bit widths: 32-value sub-blocks,
                each packed horizontally at its own max width (finer-
                grained than ``pfor``'s 128-lane width, so one outlier
                inflates 32 values instead of 128)
  ``pef``       partitioned Elias-Fano over the stream's prefix sums,
                128-value chunks, per-chunk universe — the sparse-list
                frontier; no uint32 ceiling

Every codec decodes bit-identically and has a naive pure-python decode
oracle (``decode_stream_naive``) asserted against in tests.

One segment = four files, each independently framed and checksummed:

  ``<name>.dict``  term dictionary: term-id deltas + per-term df
  ``<name>.pst``   postings: per-term rebased doc deltas + tf
  ``<name>.pos``   positions: per-posting rebased position deltas
  ``<name>.doc``   doc table: generation, doc-id deltas, doc lengths

plus, when the segment carries tombstones, a *delete generation* file
(Lucene's ``.liv`` shape) that is written WITHOUT rewriting the segment:

  ``<name>_<g>.liv``  packed delete bitmap over the segment's doc table

The four core files of a segment never change once written; every new
batch of deletes bumps ``g`` and writes a fresh tiny ``.liv``, the commit
manifest references exactly one generation per segment, and superseded
generations are deleted after commit.

Frame format (every storage file, including ``segments_N`` manifests):

  magic "RSEG" | u32 version | u8 kind | u64 payload_len | payload
  | u32 crc32(prefix)

The declared payload length is AUTHORITATIVE: validation covers exactly
the declared frame and ignores trailing bytes, so a plain read and an
``mmap`` read that maps only the declared frame agree bit-for-bit on
every file — valid, torn, or trailing-garbage alike
(``frame_declared_length`` is the mmap-side helper). A torn, truncated,
or bit-flipped file fails ``unframe`` with ``CorruptSegment`` instead of
decoding garbage — recovery depends on it. Decoding is bit-identical to
the encoded ``Segment`` (hypothesis oracle in tests/test_storage.py),
including the optional merge-time doc-id ``reorder`` permutation carried
by the ``.doc`` table.

This is the JAX package's ``storage/codec.py`` with the ``pfor`` streams
moved onto the port's pack ops; every frame is byte-identical to the
JAX package's. Each ``pfor`` stream packs in one launch of the pack
kernel, and the streams of one segment unpack in one launch of the unpack
kernel, on the ``device`` the caller names (None: CUDA, raising without
it; ``"cpu"``: the plain versions). Everything else stays numpy on the host, as in the JAX
package (PyTorch's CPU build has no uint32/uint64 arithmetic).

Decoding is split so that no kernel runs under a ``try``: ``parse_segment``
validates the frames and parses every stream header (pfor streams stay
packed, as ``PforStream``), ``unpack_streams`` runs the unpack kernel
over them, and ``finish_segment`` assembles and validates the
``Segment``. ``decode_segment`` is the three in a row.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.segments import Segment
from repro_torch.device import resolve_device
from repro_torch.kernels.postings_pack import ops as pack_ops

MAGIC = b"RSEG"
VERSION = 2
# magic + u32 version + u8 kind + u64 payload length | ... | u32 crc32
_HEADER_LEN = 17
_FRAME_OVERHEAD = _HEADER_LEN + 4

# frame kinds
KIND_DICT, KIND_PST, KIND_POS, KIND_DOC = 1, 2, 3, 4
KIND_MANIFEST, KIND_SPOOL = 5, 6
KIND_LIV = 7
KIND_WAL = 8

SEGMENT_SUFFIXES = (".dict", ".pst", ".pos", ".doc")
_SUFFIX_KIND = {".dict": KIND_DICT, ".pst": KIND_PST,
                ".pos": KIND_POS, ".doc": KIND_DOC}

# stream codec ids
_RAW, _PFOR, _ADW, _PEF = 0, 1, 2, 3
CODECS = ("raw", "pfor", "adaptive", "pef")
# write-time pseudo-codec: every stream is encoded with whichever of the
# compressed codecs comes out smallest for ITS values; the choice is
# recorded in the stream's leading id byte, so the decoder needs no
# out-of-band knob and mixed-codec segment files read back exactly
AUTO = "auto"

_ADW_SUB = 32      # adaptive codec sub-block size (values per width)
_PEF_CHUNK = 128   # partitioned Elias-Fano chunk size (values per universe)


class CorruptSegment(Exception):
    """A storage file failed validation (magic/version/kind/crc/shape)."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def frame(kind: int, payload: bytes) -> bytes:
    body = (MAGIC + struct.pack("<IBQ", VERSION, kind, len(payload))
            + payload)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def frame_declared_length(data: bytes) -> int | None:
    """Total frame length the header declares, or ``None`` when the header
    itself is absent/torn. ``FSDirectory(mmap=True)`` uses this to map
    exactly the frame instead of whole files; a file shorter than the
    declared length then fails ``unframe`` identically on both paths."""
    if len(data) < _HEADER_LEN or data[:4] != MAGIC:
        return None
    version, _kind, plen = struct.unpack_from("<IBQ", data, 4)
    if version != VERSION:
        return None
    return _FRAME_OVERHEAD + plen


def unframe(data: bytes, kind: int) -> bytes:
    if len(data) < _FRAME_OVERHEAD:
        raise CorruptSegment(f"file truncated to {len(data)} bytes")
    if data[:4] != MAGIC:
        raise CorruptSegment(f"bad magic {data[:4]!r}")
    version, got_kind, plen = struct.unpack_from("<IBQ", data, 4)
    if version != VERSION:
        raise CorruptSegment(f"unknown codec version {version}")
    if got_kind != kind:
        raise CorruptSegment(f"expected kind {kind}, found {got_kind}")
    # the declared length is authoritative: validate exactly the declared
    # frame and ignore trailing bytes, so plain and mmap reads agree
    total = _FRAME_OVERHEAD + plen
    if len(data) < total:
        raise CorruptSegment(
            f"frame declares {total} bytes, file holds {len(data)}")
    (crc,) = struct.unpack_from("<I", data, total - 4)
    if zlib.crc32(data[:total - 4]) & 0xFFFFFFFF != crc:
        raise CorruptSegment("checksum mismatch (torn or corrupted file)")
    return data[_HEADER_LEN:total - 4]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _bit_widths(mx: np.ndarray) -> np.ndarray:
    """Per-element bit widths of non-negative uint32 maxima, vectorized.
    Exact for the full uint32 range (integers < 2**53 are float64-exact,
    and log2 of an exact float is correctly rounded)."""
    return np.ceil(np.log2(mx.astype(np.float64) + 1.0)).astype(np.uint8)


@dataclass
class PforStream:
    """A parsed ``pfor`` stream, still packed: its value count, per-block
    bit widths and compacted plane rows (``sum(bw) * 4`` words)."""

    n: int
    bw: np.ndarray     # (nb,) int64
    rows: np.ndarray   # (sum(bw) * 4,) little-endian uint32 words


def _enc_pfor(arr: np.ndarray, device=None) -> bytes:
    n = arr.size
    nb = -(-n // pack_ops.BLOCK) if n else 0
    head = struct.pack("<BQQ", _PFOR, n, nb)
    if not nb:
        return head
    padded = np.zeros(nb * pack_ops.BLOCK, np.uint32)
    padded[:n] = arr.astype(np.uint32)
    blocks = torch.from_numpy(padded.view(np.int32)).reshape(
        nb, pack_ops.BLOCK).to(resolve_device(device))
    packed, bw = pack_ops.pack(blocks)
    rows = pack_ops.compact_planes(packed, bw).cpu().numpy().view(np.uint32)
    return (head + bw.cpu().numpy().astype(np.uint8).tobytes()
            + rows.astype("<u4").tobytes())


def unpack_streams(streams: list, device) -> list:
    """Values of parsed ``pfor`` streams as int64 arrays: the blocks of
    all of them go through one unpack launch on ``device``."""
    nbs = [s.bw.size for s in streams]
    if not sum(nbs):
        return [np.zeros(0, np.int64) for _ in streams]
    dev = resolve_device(device)
    bw = torch.from_numpy(np.concatenate([s.bw for s in streams]).astype(
        np.int32)).to(dev)
    rows = np.concatenate([s.rows for s in streams]).astype(np.uint32)
    rows = torch.from_numpy(rows.view(np.int32)).reshape(
        -1, pack_ops.WORDS_PER_PLANE).to(dev)
    vals = pack_ops.unpack(pack_ops.expand_planes(rows, bw), bw)
    vals = vals.cpu().numpy().view(np.uint32)
    out, b0 = [], 0
    for s, nb in zip(streams, nbs):
        out.append(vals[b0:b0 + nb].reshape(-1)[:s.n].astype(np.int64))
        b0 += nb
    return out


def _enc_adaptive(arr: np.ndarray) -> bytes:
    """Per-sub-block adaptive widths: 32-value sub-blocks, each stored at
    its own max bit width as a horizontal LSB-first bitstream. 32·bw bits
    per sub-block keeps every sub-block byte-aligned."""
    n = arr.size
    ns = -(-n // _ADW_SUB) if n else 0
    head = struct.pack("<BQQ", _ADW, n, ns)
    if not ns:
        return head
    padded = np.zeros(ns * _ADW_SUB, np.uint32)
    padded[:n] = arr.astype(np.uint32)
    u = padded.reshape(ns, _ADW_SUB)
    bw = _bit_widths(u.max(axis=1))
    # (ns, 32 values, 32 bits) LSB-first bit tensor; keep bits j < bw[s]
    bits = np.unpackbits(u.view(np.uint8).reshape(ns, _ADW_SUB, 4),
                         axis=2, bitorder="little")
    keep = np.arange(32)[None, None, :] < bw[:, None, None]
    payload = np.packbits(bits[np.broadcast_to(keep, bits.shape)],
                          bitorder="little")
    return head + bw.tobytes() + payload.tobytes()


def _ef_params(m: int, u: int) -> tuple[int, int]:
    """Elias-Fano low-bit count and high-part unary length for a chunk of
    ``m`` values over universe ``u``."""
    l = max(0, (u // m).bit_length() - 1) if u > 0 else 0
    return l, m + (u >> l)


def _enc_pef(arr: np.ndarray) -> bytes:
    """Partitioned Elias-Fano over the stream's prefix sums: 128-value
    chunks, each rebased to its predecessor's last prefix sum, with the
    chunk universe table up front. Chunk bit lengths are fully determined
    by (m, universe), so decode walks chunks without extra offsets."""
    n = arr.size
    head = struct.pack("<BQ", _PEF, n)
    if not n:
        return head
    cum = np.cumsum(arr, dtype=np.int64)
    if int(cum[-1]) >= 1 << 62:
        raise ValueError("pef stream prefix sums overflow int64 headroom")
    nc = -(-n // _PEF_CHUNK)
    universes = np.zeros(nc, np.int64)
    parts = []
    base = 0
    for c in range(nc):
        rel = cum[c * _PEF_CHUNK:(c + 1) * _PEF_CHUNK] - base
        m = rel.size
        u = int(rel[-1])
        universes[c] = u
        base += u
        l, high_len = _ef_params(m, u)
        bits = np.zeros(m * l + high_len, np.uint8)
        if l:
            bits[:m * l] = ((rel[:, None] >> np.arange(l)) & 1).reshape(-1)
        bits[m * l + (rel >> l) + np.arange(m)] = 1
        parts.append(np.packbits(bits, bitorder="little").tobytes())
    return head + universes.astype("<u8").tobytes() + b"".join(parts)


def _enc_stream(arr: np.ndarray, codec: str, device=None) -> bytes:
    """One non-negative int64 stream -> length-prefixed bytes."""
    arr = np.asarray(arr, np.int64)
    if arr.size and int(arr.min()) < 0:
        raise ValueError("streams must be non-negative after rebasing")
    if codec == AUTO:
        # smallest of the compressed codecs for THIS stream (pfor, then
        # adaptive, then pef on ties); a candidate whose value domain the
        # stream exceeds (pfor/adaptive cap at uint32, pef at int64
        # prefix-sum headroom) just drops out, and only when every one
        # refuses does the ceiling-free raw stream carry the values. The
        # uint32 cap is checked here, so the pack kernel runs under no try
        fits = not arr.size or int(arr.max()) < 1 << 32
        cands = [_enc_pfor(arr, device), _enc_adaptive(arr)] if fits else []
        try:
            cands.append(_enc_pef(arr))
        except ValueError:
            pass
        return min(cands, key=len) if cands else _enc_stream(arr, "raw")
    if codec == "raw":
        return (struct.pack("<BQ", _RAW, arr.size)
                + arr.astype("<i8").tobytes())
    if codec == "pef":
        return _enc_pef(arr)
    if codec not in ("pfor", "adaptive"):
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    if arr.size and int(arr.max()) >= 1 << 32:
        raise ValueError(f"{codec} streams must fit uint32 after deltas")
    return _enc_pfor(arr, device) if codec == "pfor" else _enc_adaptive(arr)


def _parse_pfor(buf: bytes, off: int) -> tuple:
    """Validate one ``pfor`` stream's header, widths and extent; its
    planes stay packed (``PforStream``) for ``unpack_streams``."""
    n, nb = struct.unpack_from("<QQ", buf, off + 1)
    off += 17
    if not nb:
        if n:
            raise CorruptSegment("non-empty stream with zero blocks")
        return np.zeros(0, np.int64), off
    bw = np.frombuffer(buf[off:off + nb], np.uint8).astype(np.int64)
    if bw.size != nb or (bw > 32).any():
        raise CorruptSegment("bit-width table truncated or invalid")
    off += nb
    n_words = int(bw.sum()) * pack_ops.WORDS_PER_PLANE
    end = off + n_words * 4
    if end > len(buf):
        raise CorruptSegment("pfor stream truncated")
    if n > nb * pack_ops.BLOCK:
        raise CorruptSegment("stream count exceeds packed blocks")
    return PforStream(n=n, bw=bw, rows=np.frombuffer(buf[off:end], "<u4")), \
        end


def _dec_adaptive(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    n, ns = struct.unpack_from("<QQ", buf, off + 1)
    off += 17
    if not ns:
        if n:
            raise CorruptSegment("non-empty stream with zero sub-blocks")
        return np.zeros(0, np.int64), off
    if n > ns * _ADW_SUB:
        raise CorruptSegment("stream count exceeds sub-blocks")
    bw = np.frombuffer(buf[off:off + ns], np.uint8)
    if bw.size != ns or (bw > 32).any():
        raise CorruptSegment("bit-width table truncated or invalid")
    off += ns
    total_bits = int(bw.sum(dtype=np.int64)) * _ADW_SUB
    end = off + total_bits // 8
    if end > len(buf):
        raise CorruptSegment("adaptive stream truncated")
    payload = np.unpackbits(np.frombuffer(buf[off:end], np.uint8),
                            bitorder="little")[:total_bits]
    bits = np.zeros((ns, _ADW_SUB, 32), np.uint8)
    keep = np.arange(32)[None, None, :] < bw[:, None, None]
    bits[np.broadcast_to(keep, bits.shape)] = payload
    words = np.packbits(bits, axis=2, bitorder="little")
    vals = words.reshape(-1).view("<u4")[:n]
    return vals.astype(np.int64), end


def _dec_pef(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    """Vectorized across chunks: every chunk's bit length is determined by
    (m, universe), so one unpackbits covers the whole stream and the unary
    high parts of ALL chunks decode through a single ragged gather +
    flatnonzero (the repeat/arange CSR trick). Low parts batch by distinct
    bit width (typically one or two widths per stream). Bit-identical to
    the per-chunk decode it replaced and to ``decode_stream_naive``."""
    (n,) = struct.unpack_from("<Q", buf, off + 1)
    off += 9
    if not n:
        return np.zeros(0, np.int64), off
    nc = -(-n // _PEF_CHUNK)
    end = off + nc * 8
    if end > len(buf):
        raise CorruptSegment("pef universe table truncated")
    universes = np.frombuffer(buf[off:end], "<u8").astype(np.int64)
    if (universes < 0).any():
        raise CorruptSegment("pef universe overflows int64")
    off = end
    m = np.full(nc, _PEF_CHUNK, np.int64)
    m[-1] = n - (nc - 1) * _PEF_CHUNK
    # vectorized _ef_params: l = max(0, floor_log2(u // m)). frexp's
    # exponent is exact floor_log2 below 2^52; larger quotients (universe
    # near the int64 headroom) take the scalar exact path.
    q = universes // m
    l = np.zeros(nc, np.int64)
    small = (q > 0) & (q < (1 << 52))
    l[small] = np.frexp(q[small].astype(np.float64))[1] - 1
    big = q >= (1 << 52)
    if big.any():
        l[big] = [int(v).bit_length() - 1 for v in q[big]]
    high_len = m + (universes >> l)
    nbits = m * l + high_len
    nbytes = -(-nbits // 8)
    byte0 = off + np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    end = int(byte0[-1] + nbytes[-1])
    if end > len(buf):
        raise CorruptSegment("pef stream truncated")
    allbits = np.unpackbits(np.frombuffer(buf[off:end], np.uint8),
                            bitorder="little")
    bit0 = (byte0 - off) * 8              # chunk start bit in allbits
    # unary high parts, all chunks at once: gather the concatenated high
    # regions, flatnonzero, then count per chunk via the region boundaries
    h_off = np.concatenate([[0], np.cumsum(high_len)[:-1]])
    idx_h = (np.repeat(bit0 + m * l - h_off, high_len)
             + np.arange(int(high_len.sum())))
    ones = np.flatnonzero(allbits[idx_h])
    cnt = np.diff(np.searchsorted(ones, np.cumsum(high_len)), prepend=0)
    if (cnt != m).any():
        raise CorruptSegment("pef high bits hold a wrong value count")
    mcum = np.concatenate([[0], np.cumsum(m)[:-1]])
    i_local = np.arange(n) - np.repeat(mcum, m)      # rank within chunk
    h = (ones - np.repeat(h_off, m)) - i_local       # unary-decoded highs
    rel = h << np.repeat(l, m)
    # low parts, batched by distinct bit width: chunks sharing l decode as
    # one (values, l) bit matrix dotted with the LSB-first weight vector
    for lv in np.unique(l[l > 0]):
        sel = np.flatnonzero(l == lv)
        vsel = (np.repeat(mcum[sel] - np.concatenate(
            [[0], np.cumsum(m[sel])[:-1]]), m[sel])
            + np.arange(int(m[sel].sum())))          # global value ids
        base_bits = np.repeat(bit0[sel], m[sel]) \
            + i_local[vsel] * lv                     # each value's bit 0
        mat = allbits[base_bits[:, None]
                      + np.arange(lv)[None, :]].astype(np.int64)
        rel[vsel] |= mat @ (np.int64(1) << np.arange(lv))
    # per-chunk monotone-to-universe validation (chunk-crossing diffs are
    # exempt: each chunk rebases to its own universe)
    d = np.diff(rel)
    d[mcum[1:] - 1] = 0
    if (d < 0).any() or (rel[mcum + m - 1] != universes).any():
        raise CorruptSegment("pef chunk is not monotone to its universe")
    base = np.repeat(np.concatenate([[0], np.cumsum(universes)[:-1]]), m)
    return np.diff(base + rel, prepend=np.int64(0)), end


def _parse_stream(buf: bytes, off: int) -> tuple:
    """One stream at ``off`` -> ``(values or PforStream, end offset)``;
    every host codec decodes here, ``pfor`` only parses."""
    try:
        (codec_id,) = struct.unpack_from("<B", buf, off)
        if codec_id == _RAW:
            (n,) = struct.unpack_from("<Q", buf, off + 1)
            off += 9
            end = off + n * 8
            if end > len(buf):
                raise CorruptSegment("raw stream truncated")
            arr = np.frombuffer(buf[off:end], "<i8").astype(np.int64)
            return arr, end
        if codec_id == _PFOR:
            return _parse_pfor(buf, off)
        if codec_id == _ADW:
            return _dec_adaptive(buf, off)
        if codec_id == _PEF:
            return _dec_pef(buf, off)
        raise CorruptSegment(f"unknown stream codec id {codec_id}")
    except struct.error as e:
        raise CorruptSegment("stream header truncated") from e


def _dec_stream(buf: bytes, off: int, device=None) -> tuple:
    """One stream at ``off`` -> ``(int64 values, end offset)``."""
    item, end = _parse_stream(buf, off)
    if isinstance(item, PforStream):
        item = unpack_streams([item], device)[0]
    return item, end


def stream_codec_name(buf: bytes, off: int = 0) -> str:
    """Name of the codec that encoded the stream starting at ``off`` —
    its leading id byte, which is also the per-stream record of what
    ``codec="auto"`` chose at write time."""
    if off >= len(buf):
        raise CorruptSegment("stream offset past end of buffer")
    cid = buf[off]
    if cid >= len(CODECS):
        raise CorruptSegment(f"unknown stream codec id {cid}")
    return CODECS[cid]


# ---------------------------------------------------------------------------
# naive decode oracles (tests assert the vectorized decoders against these)
# ---------------------------------------------------------------------------

class _BitReader:
    """LSB-first bit reader over bytes — the scalar oracle's only tool."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, k: int) -> int:
        v = 0
        for i in range(k):
            p = self.pos + i
            v |= ((self.data[p >> 3] >> (p & 7)) & 1) << i
        self.pos += k
        return v


def decode_stream_naive(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    """Scalar pure-python decode of one stream — one loop per value, no
    numpy bit tricks. The per-codec oracle the vectorized ``_dec_stream``
    must agree with bit-for-bit."""
    (codec_id,) = struct.unpack_from("<B", buf, off)
    if codec_id == _RAW:
        (n,) = struct.unpack_from("<Q", buf, off + 1)
        off += 9
        vals = [struct.unpack_from("<q", buf, off + 8 * i)[0]
                for i in range(n)]
        return np.asarray(vals, np.int64), off + 8 * n
    if codec_id == _PFOR:
        n, nb = struct.unpack_from("<QQ", buf, off + 1)
        off += 17
        bw = list(buf[off:off + nb])
        off += nb
        vals = []
        for b in range(nb):
            words = [[struct.unpack_from("<I", buf, off + (b_row * 4 + w)
                                         * 4)[0]
                      for w in range(4)]
                     for b_row in range(sum(bw[:b]),
                                        sum(bw[:b]) + bw[b])]
            for lane in range(pack_ops.BLOCK):
                v = 0
                for j in range(bw[b]):
                    v |= ((words[j][lane // 32] >> (lane % 32)) & 1) << j
                vals.append(v)
        off += sum(bw) * 4 * 4
        return np.asarray(vals[:n], np.int64), off
    if codec_id == _ADW:
        n, ns = struct.unpack_from("<QQ", buf, off + 1)
        off += 17
        bw = list(buf[off:off + ns])
        off += ns
        r = _BitReader(buf[off:], 0)
        vals = [r.take(bw[s]) for s in range(ns) for _ in range(_ADW_SUB)]
        return np.asarray(vals[:n], np.int64), off + r.pos // 8
    if codec_id == _PEF:
        (n,) = struct.unpack_from("<Q", buf, off + 1)
        off += 9
        nc = -(-n // _PEF_CHUNK)
        universes = [struct.unpack_from("<Q", buf, off + 8 * c)[0]
                     for c in range(nc)]
        off += 8 * nc
        cum, base = [], 0
        for c in range(nc):
            m = min(n, (c + 1) * _PEF_CHUNK) - c * _PEF_CHUNK
            u = universes[c]
            l, high_len = _ef_params(m, u)
            r = _BitReader(buf[off:], 0)
            lows = [r.take(l) for _ in range(m)]
            highs, h, i = [], 0, 0
            while i < m:
                if r.take(1):
                    highs.append(h)
                    i += 1
                else:
                    h += 1
            cum.extend(base + (hi << l | lo)
                       for hi, lo in zip(highs, lows))
            base += u
            off += -(-(m * l + high_len) // 8)
        vals = [c - p for p, c in zip([0] + cum, cum)]
        return np.asarray(vals, np.int64), off
    raise CorruptSegment(f"unknown stream codec id {codec_id}")


def _rebase_encode(vals: np.ndarray, starts: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """Delta-encode a CSR-partitioned stream; each run's first element is
    stored absolute (runs restart, so the cross-run diff is meaningless)."""
    vals = np.asarray(vals, np.int64)
    d = np.diff(vals, prepend=np.int64(0))
    nz = np.asarray(counts) > 0
    s = np.asarray(starts, np.int64)[nz]
    d[s] = vals[s]
    return d


def _rebase_decode(d: np.ndarray, starts: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    if d.size == 0:
        return d.astype(np.int64)
    csum = np.cumsum(d, dtype=np.int64)
    counts = np.asarray(counts, np.int64)
    nz = counts > 0
    s = np.asarray(starts, np.int64)[nz]
    base = csum[s] - d[s]
    return csum - np.repeat(base, counts[nz])


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def encode_segment(seg: Segment, codec: str = "pfor",
                   device=None) -> dict[str, bytes]:
    """Segment -> {suffix: framed bytes}, decodable bit-identically. Its
    ``pfor`` streams pack on ``device``."""
    P = seg.n_postings
    if int(seg.term_start[0]) != 0 or int(seg.term_start[-1]) != P:
        raise ValueError("term_start is not a CSR over the postings")
    if int(seg.pos_start[-1]) != len(seg.positions):
        raise ValueError("pos_start is not a CSR over the positions")
    df = np.diff(seg.term_start).astype(np.int64)
    term_delta = np.diff(seg.terms, prepend=np.int64(0))
    doc_delta = _rebase_encode(seg.docs, seg.term_start[:-1], df)
    pos_delta = _rebase_encode(seg.positions, seg.pos_start[:-1], seg.tf)
    docid_delta = np.diff(seg.doc_ids, prepend=np.int64(0))
    # merge-time BP doc-id reassignment rides the doc table: the local
    # permutation (rank -> original local slot) is tiny next to postings
    # and must survive the durable round-trip so recovered readers keep
    # the clustered block layout
    reorder = getattr(seg, "reorder", None)
    if reorder is None:
        rpart = b"\x00"
    else:
        rpart = b"\x01" + _enc_stream(np.asarray(reorder, np.int64), codec,
                                      device)
    files = {
        ".dict": frame(KIND_DICT, _enc_stream(term_delta, codec, device)
                       + _enc_stream(df, codec, device)),
        ".pst": frame(KIND_PST, _enc_stream(doc_delta, codec, device)
                      + _enc_stream(seg.tf, codec, device)),
        ".pos": frame(KIND_POS, _enc_stream(pos_delta, codec, device)),
        ".doc": frame(KIND_DOC, struct.pack("<I", seg.generation)
                      + _enc_stream(docid_delta, codec, device)
                      + _enc_stream(seg.doc_len, codec, device) + rpart),
    }
    return files


@dataclass
class ParsedSegment:
    """A segment's validated frames with every stream parsed: host-codec
    streams decoded, ``pfor`` streams still packed (``PforStream``)."""

    generation: int
    streams: dict   # name -> int64 values or PforStream


def parse_segment(files: dict[str, bytes]) -> ParsedSegment:
    """Frame checks and stream parsing of ``{suffix: framed bytes}``;
    raises ``CorruptSegment``. Runs no kernel."""
    for sfx in SEGMENT_SUFFIXES:
        if sfx not in files:
            raise CorruptSegment(f"segment file {sfx} missing")
    p_dict = unframe(files[".dict"], KIND_DICT)
    p_pst = unframe(files[".pst"], KIND_PST)
    p_pos = unframe(files[".pos"], KIND_POS)
    p_doc = unframe(files[".doc"], KIND_DOC)

    st = {}
    st["term_delta"], off = _parse_stream(p_dict, 0)
    st["df"], _ = _parse_stream(p_dict, off)
    st["doc_delta"], off = _parse_stream(p_pst, 0)
    st["tf"], _ = _parse_stream(p_pst, off)
    st["pos_delta"], _ = _parse_stream(p_pos, 0)
    if len(p_doc) < 4:
        raise CorruptSegment("doc table truncated")
    (generation,) = struct.unpack_from("<I", p_doc, 0)
    st["docid_delta"], off = _parse_stream(p_doc, 4)
    st["doc_len"], off = _parse_stream(p_doc, off)
    if off >= len(p_doc):
        raise CorruptSegment("doc table reorder flag missing")
    if p_doc[off] == 1:
        st["reorder"], _ = _parse_stream(p_doc, off + 1)
    elif p_doc[off] != 0:
        raise CorruptSegment("doc table reorder flag invalid")
    return ParsedSegment(generation=int(generation), streams=st)


def unpack_segment(parsed: ParsedSegment, device) -> dict:
    """The parsed segment's ``pfor`` values as int64 arrays by stream
    name; its streams unpack in one launch on ``device``."""
    names = [k for k, v in parsed.streams.items()
             if isinstance(v, PforStream)]
    return dict(zip(names, unpack_streams([parsed.streams[k]
                                           for k in names], device)))


def finish_segment(parsed: ParsedSegment, unpacked: dict) -> Segment:
    """Assemble and validate the ``Segment`` from its parsed streams and
    the unpacked ``pfor`` values (a fresh process-unique seg_id; on-disk
    identity lives in the commit manifest). Raises ``CorruptSegment``."""
    st = {**parsed.streams, **unpacked}
    term_delta, df, tf = st["term_delta"], st["df"], st["tf"]
    terms = np.cumsum(term_delta, dtype=np.int64)
    term_start = np.concatenate([[0], np.cumsum(df)]).astype(np.int64)
    docs = _rebase_decode(st["doc_delta"], term_start[:-1], df)
    pos_start = np.concatenate([[0], np.cumsum(tf)]).astype(np.int64)
    positions = _rebase_decode(st["pos_delta"], pos_start[:-1], tf)
    doc_ids = np.cumsum(st["docid_delta"], dtype=np.int64)
    doc_len = st["doc_len"]
    reorder = st.get("reorder")
    if reorder is not None:
        perm = np.sort(reorder)
        if (reorder.size != doc_ids.size
                or not np.array_equal(perm, np.arange(perm.size))):
            raise CorruptSegment("reorder is not a doc permutation")

    if (terms.size != df.size or docs.size != int(term_start[-1])
            or tf.size != docs.size
            or positions.size != int(pos_start[-1])
            or doc_ids.size != doc_len.size):
        raise CorruptSegment("stream lengths are mutually inconsistent")
    return Segment(terms=terms, term_start=term_start, docs=docs, tf=tf,
                   positions=positions, pos_start=pos_start,
                   doc_ids=doc_ids, doc_len=doc_len,
                   generation=parsed.generation, reorder=reorder)


def decode_segment(files: dict[str, bytes], device=None) -> Segment:
    """{suffix: framed bytes} -> a fresh Segment; the ``pfor`` streams
    unpack in one launch on ``device``."""
    parsed = parse_segment(files)
    return finish_segment(parsed, unpack_segment(parsed, device))


def encode_liveness(deletes: np.ndarray) -> bytes:
    """(D,) bool tombstone mask (True = deleted) -> framed ``.liv`` bytes:
    doc count + packed bitset, crc-protected like every storage file."""
    mask = np.asarray(deletes, bool)
    payload = struct.pack("<Q", mask.size) + np.packbits(mask).tobytes()
    return frame(KIND_LIV, payload)


def decode_liveness(data: bytes, n_docs: int) -> np.ndarray:
    """Framed ``.liv`` bytes -> (n_docs,) bool tombstone mask. The stored
    doc count must match the segment it annotates — a ``.liv`` torn or
    attached to the wrong segment fails ``CorruptSegment`` cleanly."""
    payload = unframe(data, KIND_LIV)
    if len(payload) < 8:
        raise CorruptSegment("liveness payload truncated")
    (n,) = struct.unpack_from("<Q", payload, 0)
    if n != n_docs:
        raise CorruptSegment(
            f"liveness covers {n} docs, segment has {n_docs}")
    bits = np.frombuffer(payload[8:], np.uint8)
    if bits.size != -(-n // 8):
        raise CorruptSegment("liveness bitset truncated")
    return np.unpackbits(bits)[:n].astype(bool)


def write_segment(directory, name: str, seg: Segment,
                  codec: str = "pfor", device=None) -> int:
    """Encode ``seg`` into ``directory`` as ``<name><suffix>`` files;
    returns the encoded byte total (what actually crossed the device)."""
    files = encode_segment(seg, codec, device)
    return sum(directory.write_file(name + sfx, data)
               for sfx, data in files.items())


def read_segment_files(directory, name: str) -> dict[str, bytes]:
    """``<name>.*`` as ``{suffix: bytes}``; a missing file raises
    ``CorruptSegment`` (a half-written segment must never half-load)."""
    files = {}
    for sfx in SEGMENT_SUFFIXES:
        try:
            files[sfx] = directory.read_file(name + sfx)
        except FileNotFoundError as e:
            raise CorruptSegment(f"segment file {name + sfx} missing") from e
    return files


def read_segment(directory, name: str, device=None) -> Segment:
    """Read + verify + decode ``<name>.*``; any missing/torn file raises
    ``CorruptSegment``."""
    return decode_segment(read_segment_files(directory, name), device)

"""The Hopper kernels' algorithms, checked on the CPU before the card runs
them: numpy emulations of what each warp does, held bit for bit against
the plain versions (and, for pack, unpack and compact, the JAX package's
oracles).

* pack (``csrc/postings_pack.cu::pack_kernel``): the grid-stride loop
  with the next block's loads issued early, and the five-stage
  ``__shfl_xor_sync`` butterfly that transposes each 32 x 32 bit chunk
  (32 lanes as the last array axis; a shuffle is an index by lane ^ s).
* unpack (``postings_pack.cu::unpack_kernel``): the same loop with each
  block's bw loaded a step before its planes, a 16-byte load per live
  plane only (garbage in dead planes never read), the same transpose.
* compact (``csrc/bm25_blockmax.cu::bm25_compact_kernel``): a warp per
  block, the next block's metadata loaded early, live rows only, both
  streams transposed, four warp scans plus lane 31's carry in uint32,
  and the plain version's f32 order.
* bm25_blocks (``bm25_blockmax.cu::bm25_kernel``): compact's design over
  the dense (S, 32, 4) planes, live planes only (garbage in dead planes
  never read); with partials, each warp's per-lane running max as int32
  bits, folded by the CTA and then into a zeroed output by atomicMax.
* midgrid (``csrc/bm25_blockmax.cu::midgrid_walk_kernel``): the walk over
  staged chunks, with the floor after the first step and each step's fold
  taken as int32 ``atomicMax`` on the floats' bits in a shuffled order.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bm25_blockmax import ref as jbref
from repro.kernels.bm25_blockmax.kernel import bm25_blocks_pallas
from repro.kernels.postings_pack import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.bm25_blockmax import ref as bref
from repro_torch.kernels.postings_pack import ref as pref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels" / "csrc"
LANE = np.arange(32)
STAGES = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
          (2, 0x33333333), (1, 0x55555555))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# --- pack -----------------------------------------------------------------

def transpose32(x: np.ndarray) -> np.ndarray:
    """``transpose32x4``: x (..., 32) uint32, lane t holding row t of a bit
    matrix -> lane p holding column p (bit t = bit p of lane t's word)."""
    for s, m in STAGES:
        m = np.uint32(m)
        hi = (LANE & s) != 0
        keep = np.where(hi, x & ~m, x & m)
        send = np.where(hi, (x & m) << np.uint32(s), (x & ~m) >> np.uint32(s))
        x = keep | send[..., LANE ^ s]        # __shfl_xor_sync(send, s)
    return x


def _grid_stride(n: int, n_warps: int, ahead: int) -> None:
    """The kernels' grid-stride loop over n blocks with ``n_warps`` warps,
    a register filled ``ahead`` steps before it is consumed: every block
    is handled once, and by its own loads."""
    seen = []
    for g in range(min(n_warps, n)):
        mine = list(range(g, n, n_warps))
        pipe = mine[:ahead]
        for i, b in enumerate(mine):
            seen.append((b, pipe[0]))
            pipe = pipe[1:] + ([mine[i + ahead]] if i + ahead < len(mine)
                               else [])
    assert sorted(b for b, _ in seen) == list(range(n))
    assert all(b == src for b, src in seen)


def pack_emulated(d: np.ndarray, n_warps: int):
    """``pack_kernel`` with ``n_warps`` warps in the grid: (nb, 128) uint32
    -> (packed (nb, 32, 4) uint32, bw (nb,) int32)."""
    nb = d.shape[0]
    _grid_stride(nb, n_warps, 1)             # values loaded a step early
    x = d.reshape(nb, 4, 32)                 # chunk w, lane t: value 32w+t
    m = x.max(axis=1).max(axis=-1).astype(np.int64)   # __reduce_max_sync
    bw = np.where(m == 0, 0, np.floor(np.log2(np.maximum(m, 1))) + 1)
    words = transpose32(x)                   # lane p: plane p's word w
    return words.transpose(0, 2, 1), bw.astype(np.int32)


def _pack_inputs(nb: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (nb, 128), dtype=np.uint64)
    d >>= rng.integers(0, 33, (nb, 1)).astype(np.uint64)
    d = d.astype(np.uint32)
    d[0] = 0                                  # bw 0
    if nb > 2:
        d[1], d[2] = 0xFFFFFFFF, 1            # bw 32, bw 1
    return d


def test_transpose32_is_the_bit_transpose():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, (64, 32), dtype=np.uint64).astype(np.uint32)
    bits = (x[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1  # [t, p]
    want = (bits.transpose(0, 2, 1).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    np.testing.assert_array_equal(transpose32(x), want)
    np.testing.assert_array_equal(transpose32(transpose32(x)), x)


@pytest.mark.parametrize("nb,n_warps", [(1, 8), (31, 8), (33, 8),
                                        (97, 24), (300, 1), (4097, 256)])
def test_pack_emulation_matches_pack_ref(nb, n_warps):
    d = _pack_inputs(nb, nb)
    got, bw = pack_emulated(d, n_warps)
    want, want_bw = pref.pack_ref(_t(d))
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    np.testing.assert_array_equal(bw, want_bw.numpy())
    assert bw[0] == 0
    if nb > 2:
        assert bw[1] == 32 and bw[2] == 1


@pytest.mark.parametrize("fill,want_bw", [(0, 0), (0xFFFFFFFF, 32),
                                          (1, 1), (2 ** 31, 32)])
def test_pack_emulation_edge_widths_match_jax(fill, want_bw):
    d = np.full((5, 128), fill, np.uint32)
    d[3] = np.arange(128, dtype=np.uint32) * (fill // 128 + 1)
    got, bw = pack_emulated(d, 2)
    p_j, bw_j = jref.pack_ref(jnp.asarray(d))
    np.testing.assert_array_equal(got, np.asarray(p_j))
    np.testing.assert_array_equal(bw, np.asarray(bw_j))
    assert bw[0] == want_bw


# --- unpack ---------------------------------------------------------------

def unpack_emulated(packed: np.ndarray, bw: np.ndarray,
                    n_warps: int) -> np.ndarray:
    """``unpack_kernel`` with ``n_warps`` warps: (nb, 32, 4) uint32 +
    (nb,) int32 -> (nb, 128) uint32."""
    nb = packed.shape[0]
    _grid_stride(nb, n_warps, 1)                  # planes a step early
    _grid_stride(nb, n_warps, 2)                  # their bw a step before
    live = LANE[None, :] < bw[:, None]            # lane p < bw: one load
    x = np.where(live[:, :, None], packed, np.uint32(0))
    vals = transpose32(x.transpose(0, 2, 1))      # lane p -> lane t
    return vals.reshape(nb, 128)                  # word w, lane t: 32w+t


def _unpack_inputs(nb: int, seed: int):
    """Blocks at bw 0, 1, 31, 32, 33 and 255 (a uint8 header holds the
    last two) and random widths, packed, with random nonzero garbage in
    every dead plane."""
    rng = np.random.default_rng(seed)
    bw = rng.integers(0, 33, nb).astype(np.int32)
    bw[:6] = (0, 1, 31, 32, 33, 255)
    vals = rng.integers(0, 2 ** 32, (nb, 128), dtype=np.uint64)
    vals &= (np.uint64(1) << np.minimum(bw, 32).astype(np.uint64)[:, None]) \
        - np.uint64(1)
    vals = vals.astype(np.uint32)
    packed = pref.pack_ref(_t(vals))[0].numpy().view(np.uint32).copy()
    dead = np.arange(32)[None, :] >= bw[:, None]
    garbage = rng.integers(1, 2 ** 32, packed.shape, dtype=np.uint64)
    packed[dead] = garbage.astype(np.uint32)[dead]
    return packed, bw, vals


@pytest.mark.parametrize("nb,n_warps", [(6, 8), (131, 1), (131, 8),
                                        (300, 16), (1031, 256)])
def test_unpack_emulation_matches_unpack_refs(nb, n_warps):
    packed, bw, vals = _unpack_inputs(nb, nb * 7 + n_warps)
    assert (packed[0] != 0).all() and (packed[1, 1:] != 0).all()
    got = unpack_emulated(packed, bw, n_warps)
    np.testing.assert_array_equal(got, vals)
    want = pref.unpack_ref(_t(packed), torch.from_numpy(bw))
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    j_want = jref.unpack_ref(jnp.asarray(packed), jnp.asarray(bw))
    np.testing.assert_array_equal(got, np.asarray(j_want))


# --- compact --------------------------------------------------------------

def compact_emulated(rows_d, coff_d, bw_d, first, rows_t, coff_t, bw_t, idf,
                     active, k1: float, n_warps: int):
    """``bm25_compact_kernel`` with ``n_warps`` warps: uint32 rows (P, 4),
    int32 / f32 per-block metadata (S,) -> (doc int32, tf f32, num f32),
    each (S, 128)."""
    S = coff_d.shape[0]
    _grid_stride(S, n_warps, 1)          # metadata loaded one step ahead
    act = active > 0                     # uniform over the warp

    def planes(rows, coff, bw):
        row = coff.astype(np.int64)[:, None] + LANE          # lane p's row
        live = act[:, None] & (LANE < bw[:, None]) & (row >= 0) \
            & (row < rows.shape[0])
        x = np.where(live[:, :, None],
                     rows[np.clip(row, 0, rows.shape[0] - 1)], np.uint32(0))
        return transpose32(x.transpose(0, 2, 1))  # word w, lane t: 32w+t

    return _score(planes(rows_d, coff_d, bw_d), planes(rows_t, coff_t, bw_t),
                  first, idf, act, k1)


def _score(gap, tfu, first, idf, act, k1: float):
    """``score_block`` where ``act``, ``zero_block`` elsewhere: gap and tf
    words (S, 4, 32) uint32 (word w of lane t: value 32w + t) -> four warp
    scans plus lane 31's carry in uint32, tf and num in the plain version's
    f32 order; (doc int32, tf f32, num f32), each (S, 128)."""
    S = gap.shape[0]
    for off in (1, 2, 4, 8, 16):         # __shfl_up_sync, per word
        gap = np.where(LANE >= off, gap + gap[..., np.maximum(LANE - off, 0)],
                       gap)
    doc = np.empty_like(gap)
    carry = first.view(np.uint32).copy()
    for w in range(4):
        doc[:, w] = carry[:, None] + gap[:, w]
        carry += gap[:, w, 31]           # lane 31's total, broadcast
    tf = tfu.astype(np.float32)          # __uint2float_rn
    ic = idf.astype(np.float32) * np.float32(k1 + 1.0)       # f32(k1 + 1)
    num = ic[:, None, None] * tf
    a = act[:, None, None]
    return (np.where(a, doc, 0).view(np.int32).reshape(S, 128),
            np.where(a, tf, np.float32(0)).reshape(S, 128),
            np.where(a, num, np.float32(0)).reshape(S, 128))


def _compact_case(S: int, seed: int):
    """Compact rows of 40 blocks per stream (bw 0 and 32 among them, 32
    zero tail rows) and an S-block selection holding bw-0 and bw-32
    blocks, the last block before the tail rows and inactive blocks, with
    first doc ids and gaps that carry the prefix sum past 2^31 and 2^32."""
    rng = np.random.default_rng(seed)
    nb = 40
    streams = []
    for name in ("docs", "tf"):
        vals = rng.integers(0, 2 ** 32, (nb, 128), dtype=np.uint64)
        vals >>= rng.integers(0, 33, (nb, 1)).astype(np.uint64)
        vals = vals.astype(np.uint32)
        vals[0], vals[1] = 0, 0xFFFFFFFF
        vals[-1] = 0x80000000 if name == "docs" else 7
        packed, bw = pref.pack_ref(_t(vals))
        rows = torch.cat([pref.compact_planes(packed, bw),
                          torch.zeros((32, 4), dtype=torch.int32)])
        streams.append((rows, (torch.cumsum(bw, 0) - bw).to(torch.int32),
                        bw))
    flat = rng.integers(0, nb, S)
    flat[:min(S, 4)] = [nb - 1, 0, 1, 2][:min(S, 4)]
    first = rng.integers(-(2 ** 31), 2 ** 31, S).astype(np.int32)
    first[:min(S, 2)] = 2 ** 31 - 5
    idf = (rng.random(S) * 8).astype(np.float32)
    active = (rng.random(S) < 0.75).astype(np.int32)
    active[rng.random(S) < 0.1] = -3
    active[:min(S, 3)] = 1
    if S > 4:
        active[3] = 0
    (rd, cd, bd), (rt, ct, bt) = streams
    return (rd, cd[flat], bd[flat], torch.from_numpy(first), rt, ct[flat],
            bt[flat], torch.from_numpy(idf), torch.from_numpy(active))


@pytest.mark.parametrize("S,n_warps", [(1, 8), (37, 8), (300, 40)])
def test_compact_emulation_matches_compact_refs(S, n_warps):
    args = _compact_case(S, S * 3 + n_warps)
    np_args = [a.numpy() for a in args]
    for i in (0, 4):                     # rows: uint32 words; the rest int
        np_args[i] = np_args[i].view(np.uint32)
    got = compact_emulated(*np_args, k1=0.9, n_warps=n_warps)
    want = bref.bm25_blocks_compact_ref(*args, k1=0.9)
    j_want = jbref.bm25_blocks_compact_ref(*[jnp.asarray(a)
                                             for a in np_args], k1=0.9)
    for g, w, j in zip(got, want, j_want):
        w, j = w.numpy(), np.asarray(j)
        assert g.dtype == w.dtype == j.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
        np.testing.assert_array_equal(g.view(np.uint32), j.view(np.uint32))
    if S > 1:      # the first block's ids wrap past 2^31 (int32 sign)
        assert (got[0][0] < 0).any() and (got[0][0] > 0).any()
    if S > 4:      # inactive blocks, bw 0 or not, write zeros
        assert (got[1][args[8].numpy() <= 0] == 0).all()
        assert (args[8].numpy() < 0).any()


# --- bm25_blocks ----------------------------------------------------------

def bm25_emulated(pd, bwd, first, pt, bwt, idf, active, k1: float, b: float,
                  n_warps: int, cta_warps: int):
    """``bm25_kernel<true>`` with ``n_warps`` warps in CTAs of
    ``cta_warps``: uint32 planes (S, 32, 4), per-block metadata (S,) ->
    (doc, tf, num) each (S, 128) and the (1, 128) partials."""
    S = pd.shape[0]
    _grid_stride(S, n_warps, 1)          # metadata loaded one step ahead
    act = active > 0

    def planes(packed, bw):               # lane p: plane p if p < bw
        live = act[:, None] & (LANE[None, :] < bw[:, None])
        x = np.where(live[:, :, None], packed, np.uint32(0))
        return transpose32(x.transpose(0, 2, 1))
    doc, tf, num = _score(planes(pd, bwd), planes(pt, bwt), first, idf, act,
                          k1)
    min_norm = np.float32(k1 * (1.0 - b))   # the wrapper's f32 rounding
    with np.errstate(divide="ignore", invalid="ignore"):
        part = np.where(tf > 0, num / (tf + min_norm), np.float32(0))
    bits = part.astype(np.float32).view(np.int32)
    # each warp's lanes: a running int32 max from 0 over its blocks
    warp_max = np.zeros((n_warps, 128), np.int32)
    np.maximum.at(warp_max, np.arange(S) % n_warps, bits)
    # atomicMax of the values > 0 into the CTA's shared row (zeroed), then
    # of the CTA's values > 0 into the output (zeroed by the entry point)
    cta = np.zeros((-(-n_warps // cta_warps), 128), np.int32)
    for g in range(n_warps):
        row = cta[g // cta_warps]
        row[:] = np.where(warp_max[g] > 0, np.maximum(row, warp_max[g]), row)
    out = np.zeros(128, np.int32)
    for row in cta:
        out = np.where(row > 0, np.maximum(out, row), out)
    return doc, tf, num, out.view(np.float32)[None, :]


def _bm25_case(S: int, seed: int, signed_zero: bool = False):
    """Packed gap and tf blocks at bw 0, 1, 32 and random widths, bw 33 /
    255 headers on some bw-32 blocks, random nonzero garbage in every dead
    plane, first doc ids that carry the prefix sum past 2^31 and 2^32,
    inactive blocks (0 and negative). With ``signed_zero``: idf -0.0 or
    negative on some blocks, blocks whose tf is all 0, and lanes 0-7 live
    only in blocks of idf -0.0 or < 0, so their partial max is a zero."""
    rng = np.random.default_rng(seed)
    arrays = []
    for name in ("docs", "tf"):
        vals = rng.integers(0, 2 ** 32, (S, 128), dtype=np.uint64)
        vals >>= rng.integers(0, 33, (S, 1)).astype(np.uint64)
        vals = vals.astype(np.uint32)
        if name == "tf":
            vals %= np.uint32(40)
        vals[0] = 0
        if S > 2:
            vals[1], vals[2] = 0xFFFFFFFF, 1
        packed, bw = pref.pack_ref(_t(vals))
        packed = packed.numpy().view(np.uint32).copy()
        bw = bw.numpy().copy()
        dead = np.arange(32)[None, :] >= bw[:, None]
        junk = rng.integers(1, 2 ** 32, packed.shape, dtype=np.uint64)
        packed[dead] = junk.astype(np.uint32)[dead]
        wide = np.flatnonzero(bw == 32)
        bw[wide[::3]], bw[wide[1::3]] = 33, 255
        arrays += [packed, bw.astype(np.int32)]
    first = rng.integers(-(2 ** 31), 2 ** 31, S).astype(np.int32)
    first[:min(S, 3)] = 2 ** 31 - 5     # block 2 (gaps 1) wraps past 2^31
    idf = (rng.random(S) * 8).astype(np.float32)
    active = (rng.random(S) < 0.8).astype(np.int32)
    active[rng.random(S) < 0.1] = -2
    active[:min(S, 3)] = 1
    (pd, bwd), (pt, bwt) = arrays[:2], arrays[2:]
    if signed_zero:
        idf[rng.random(S) < 0.2] = -0.0
        idf[rng.random(S) < 0.1] = -1.5
        zero_tf = rng.random(S) < 0.1
        pt[zero_tf], bwt[zero_tf] = 0, 0
        # lanes 0-7: tf > 0 only where idf is -0.0 or negative; block 0
        # (active, idf -0.0) has tf > 0 there, so a max over the blocks in
        # order meets -0.0 before any +0.0
        idf[0] = -0.0
        pos = ~((idf < 0) | np.signbit(idf))
        tf_words = pref.unpack_ref(_t(pt), torch.from_numpy(bwt)).numpy()
        tf_words = tf_words.view(np.uint32).copy()
        tf_words[pos, :8] = 0
        tf_words[0, :8] = 3
        pt, bwt = (a.numpy() for a in pref.pack_ref(_t(tf_words)))
        pt = pt.view(np.uint32)
    return pd, bwd, first, pt, bwt, idf, active


def _bm25_refs(args, partials: bool):
    """The port's plain version and the JAX kernel (interpret mode) on the
    same arrays."""
    tw = [_t(a) if a.dtype == np.uint32 else torch.from_numpy(a)
          for a in args]
    S = args[0].shape[0]
    rows = max(d for d in range(1, 65) if S % d == 0)
    jax_out = bm25_blocks_pallas(*[jnp.asarray(a) for a in args], k1=0.9,
                                 b=0.4, block_rows=rows, interpret=True,
                                 partials=partials)
    if partials:
        return bref.bm25_blocks_partials_ref(*tw, 0.9, 0.4), jax_out
    return bref.bm25_blocks_ref(*tw, 0.9), jax_out


def _bit_equal(got, want, j_want):
    for g, w, j in zip(got, want, j_want):
        w, j = w.numpy(), np.asarray(j)
        assert g.dtype == w.dtype == j.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
        np.testing.assert_array_equal(g.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("S,n_warps,cta_warps", [
    (1, 8, 8), (37, 8, 8), (37, 40, 8), (300, 24, 8), (300, 7, 4)])
def test_bm25_blocks_emulation_matches_refs(S, n_warps, cta_warps):
    args = _bm25_case(S, S * 5 + n_warps)
    got = bm25_emulated(*args, k1=0.9, b=0.4, n_warps=n_warps,
                        cta_warps=cta_warps)
    _bit_equal(got[:3], *_bm25_refs(args, partials=False))
    if S > 4:      # garbage in dead planes, wrapped ids, inactive zeros
        assert (args[0][args[1] < 32] != 0).any()
        assert (got[0][2] < 0).any() and (got[0][2] > 0).any()
        assert (got[1][args[6] <= 0] == 0).all() and (args[6] < 0).any()


@pytest.mark.parametrize("S,n_warps,cta_warps", [
    (8, 8, 8), (64, 16, 8), (300, 40, 8), (300, 9, 2)])
def test_bm25_partials_emulation_matches_refs(S, n_warps, cta_warps):
    args = _bm25_case(S, S * 11 + n_warps, signed_zero=True)
    got = bm25_emulated(*args, k1=0.9, b=0.4, n_warps=n_warps,
                        cta_warps=cta_warps)
    want, j_want = _bm25_refs(args, partials=True)
    _bit_equal(got, want, j_want)
    part = got[3][0]
    # lanes 0-7 saw only -0.0 and negative partials, -0.0 first: +0.0
    # from the +0.0 start (a plain max over the blocks would give -0.0);
    # the rest saw positive ones
    assert (part[:8].view(np.uint32) == 0).all()
    lanes = np.where(got[1] > 0, got[2] / (got[1] + np.float32(0.9 * 0.6)),
                     np.float32(0))[:, :8]
    assert np.signbit(lanes[0]).all() and (lanes <= 0).all()
    assert (part[8:] > 0).all()
    tf = got[1]
    assert ((tf == 0).all(axis=1) & (args[6] > 0)).any()   # all-zero rows


# --- both: 16-byte alignment ----------------------------------------------

def test_misaligned_views_are_refused():
    buf = torch.zeros(4 * 32 * 4 + 4, dtype=torch.int32)
    _build.check_aligned(buf[:-4].view(4, 32, 4), "packed")
    _build.check_aligned(buf[4:].view(-1, 4), "rows")  # a whole row on
    for off in (1, 2, 3):
        view = buf[off:off + 4 * 32 * 4].view(4, 32, 4)
        assert view.is_contiguous()
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.check_aligned(view, "packed")


@pytest.mark.parametrize("header,includers", [
    ("warp_block.cuh", {"postings_pack", "bm25_blockmax"}),
    ("tma.cuh", {"flash_attention", "flash_attention_tc"})])
def test_editing_the_shared_header_renames_its_includers_only(
        tmp_path, monkeypatch, header, includers):
    before = {n: _build._target(n) for n in _build.SOURCES}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    after = {n: _build._target(n) for n in _build.SOURCES}
    for n in _build.SOURCES:
        includes = f'#include "{header}"' in (CSRC / f"{n}.cu").read_text()
        assert (after[n] != before[n]) == includes, n
    assert {n for n in after if after[n] != before[n]} == includers


# --- midgrid --------------------------------------------------------------

def walk_emulated(active, rows, ubf, theta, kth, block_rows: int,
                  chunk_steps: int, rng) -> np.ndarray:
    """``midgrid_walk_kernel``: the skip flags, staged ``chunk_steps``
    steps at a time; each step's fold as int32 atomicMax on the floats'
    bits, lanes in a random order."""
    S = rows.shape[0]
    chunk = chunk_steps * block_rows
    L = theta.astype(np.float32).reshape(128).copy()
    skip = np.zeros(S, np.int32)
    for b0 in range(0, S, chunk):
        n = min(chunk, S - b0)
        r, act = rows[b0:b0 + n].copy(), active[b0:b0 + n].copy()
        ub, kt = ubf[b0:b0 + n].copy(), kth[b0:b0 + n].copy()
        flags = np.zeros(n, np.int32)          # shared memory
        for st in range(n // block_rows):
            sl = slice(st * block_rows, (st + 1) * block_rows)
            rr = r[sl]
            inr = (rr >= 0) & (rr < 128)
            lr = np.where(inr, L[np.clip(rr, 0, 127)], np.float32(0))
            sk = (act[sl] > 0) & (ub[sl] < lr)
            flags[sl] = sk
            fold = np.where(sk, np.float32(0), kt[sl]).astype(np.float32)
            if b0 == 0 and st == 0:
                L = np.fmax(L, np.float32(0))  # fmaxf(L, 0)
            Li, fi = L.view(np.int32), fold.view(np.int32)
            for j in rng.permutation(block_rows):
                if inr[j]:
                    Li[rr[j]] = max(Li[rr[j]], fi[j])
        skip[b0:b0 + n] = flags                # the chunk's write-back
    return skip


def _midgrid_inputs(S: int, block_rows: int, seed: int, theta_kind: str):
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 50, (S, 128)).astype(np.uint32)
    gaps[:, 0] = 0
    tfs = rng.integers(0, 30, (S, 128)).astype(np.uint32)
    tfs[rng.random(S) < 0.05] = 0
    pd, bwd = pref.pack_ref(_t(gaps))
    pt, bwt = pref.pack_ref(_t(tfs))
    first = torch.from_numpy(rng.integers(0, 1 << 20, S).astype(np.int32))
    idf = torch.from_numpy((rng.random(S) * 4).astype(np.float32))
    act = torch.from_numpy((rng.random(S) < 0.85).astype(np.int32))
    rows = rng.integers(0, 128, S).astype(np.int32)
    edge = rng.random(S) < 0.05
    rows[edge] = rng.choice(np.array([-1, 128, 1000, -(2 ** 31)],
                                     np.int32), int(edge.sum()))
    ubf = (rng.random(S) * 8).astype(np.float32)
    ubf[rng.random(S) < 0.05] = np.inf
    if theta_kind == "zero":
        theta = np.zeros((1, 128), np.float32)
    else:
        theta = rng.random((1, 128)).astype(np.float32)
        theta[0, :4] = (-1.5, -0.0, np.inf, 0.0)
    # step 0 decides on theta as given and only then floors L at 0: an
    # active block of row 0 (theta -1.5) in step 1 with a negative bound,
    # its row untouched by step 0, is skipped only after the floor
    b = block_rows
    rows[:b][rows[:b] == 0] = 5
    rows[b], ubf[b] = 0, -0.5
    act[b] = 1
    blocks = [pd, bwd, first, pt, bwt, idf, act]
    return blocks, rows, ubf, theta, rng


def _kth(blocks, nmax: float, k: int) -> np.ndarray:
    """The k-th values the decode launch hands the walk (kth scratch)."""
    _, tf, num = bref._decode(*blocks[:6], 0.9)
    return bref.midgrid_kth_ref(tf, num, blocks[6], nmax, k).numpy()


@pytest.mark.parametrize("theta_kind", ["zero", "random"])
@pytest.mark.parametrize("block_rows,S,chunk_steps", [
    (1, 230, 37), (8, 616, 10), (8, 616, 77), (24, 720, 7),
    (100, 1000, 3), (128, 1280, 4)])
def test_walk_emulation_matches_midgrid_ref(block_rows, S, chunk_steps,
                                            theta_kind):
    blocks, rows, ubf, theta, rng = _midgrid_inputs(
        S, block_rows, block_rows * 1000 + S, theta_kind)
    k, nmax = 10, 1.2
    want = bref.bm25_blocks_midgrid_ref(
        *blocks, torch.from_numpy(rows), torch.from_numpy(ubf),
        torch.from_numpy(theta), nmax, k=k, block_rows=block_rows)[3]
    kth = _kth(blocks, nmax, k)
    for _ in range(3):                         # three fold orders
        got = walk_emulated(blocks[6].numpy(), rows, ubf, theta, kth,
                            block_rows, chunk_steps, rng)
        np.testing.assert_array_equal(got, want.numpy())
    assert want.sum() > 0, "no block was skipped: the walk went untested"


@pytest.mark.parametrize("block_rows", [8, 128])
def test_walk_emulation_at_the_kernels_chunk(block_rows):
    """Past one staged chunk of the kernel's own size (``kWalkChunk``)."""
    chunk_blocks = _constant("bm25_blockmax.cu", "kWalkChunk")
    chunk_steps = chunk_blocks // block_rows
    S = chunk_steps * block_rows + 3 * block_rows
    blocks, rows, ubf, theta, rng = _midgrid_inputs(S, block_rows, S,
                                                    "random")
    nmax = 1.2
    want = bref.bm25_blocks_midgrid_ref(
        *blocks, torch.from_numpy(rows), torch.from_numpy(ubf),
        torch.from_numpy(theta), nmax, k=1, block_rows=block_rows)[3]
    kth = _kth(blocks, nmax, 1)
    got = walk_emulated(blocks[6].numpy(), rows, ubf, theta, kth,
                        block_rows, chunk_steps, rng)
    np.testing.assert_array_equal(got, want.numpy())
    assert want[chunk_steps * block_rows:].sum() > 0

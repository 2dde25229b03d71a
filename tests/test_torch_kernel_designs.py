"""The Hopper kernels' algorithms, checked on the CPU before the card runs
them: numpy emulations of what each warp does, held bit for bit against
the plain versions (and, for pack, the JAX package's oracle).

* pack (``csrc/postings_pack.cu::pack_kernel``): the grid-stride loop
  with the next block's loads issued early, and the five-stage
  ``__shfl_xor_sync`` butterfly that transposes each 32 x 32 bit chunk
  (32 lanes as the last array axis; a shuffle is an index by lane ^ s).
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

from repro.kernels.postings_pack import ref as jref
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


def pack_emulated(d: np.ndarray, n_warps: int):
    """``pack_kernel`` with ``n_warps`` warps in the grid: (nb, 128) uint32
    -> (packed (nb, 32, 4) uint32, bw (nb,) int32)."""
    nb = d.shape[0]
    # the grid-stride loop with its early loads: which block's values each
    # store transposes (cur), and that every block is stored exactly once
    src = np.full(nb, -1, np.int64)
    for g in range(n_warps):
        cur = g if g < nb else None
        b = g
        while b < nb:
            nxt = b + n_warps if b + n_warps < nb else None
            assert src[b] == -1
            src[b] = cur
            cur, b = nxt, b + n_warps
    assert (src == np.arange(nb)).all()
    x = d[src].reshape(nb, 4, 32)            # chunk w, lane t: value 32w+t
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

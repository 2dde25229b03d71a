"""Port parity: the PyTorch plain versions of the BM25 block kernels vs the
JAX package's oracles and its Pallas kernel (interpret mode), on the same
numpy inputs. Doc ids, skip flags and every f32 output bit-equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bm25_blockmax import ref as jref
from repro.kernels.bm25_blockmax.kernel import bm25_blocks_pallas
from repro.kernels.bm25_blockmax.ops import _midgrid_ref_jit
from repro.kernels.postings_pack import ref as jpack
from repro_torch.kernels.bm25_blockmax import ops as tops
from repro_torch.kernels.bm25_blockmax import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# jitted JAX oracles: one compile per shape instead of op-by-op dispatch
_plain_ref_jit = jax.jit(jref.bm25_blocks_ref)
_kth_ref_jit = functools.partial(jax.jit, static_argnames=("k",))(
    jref._kth_lane_partial)


def _blocks(nb, seed, tf_lo=0):
    rng = np.random.default_rng(seed)
    deltas = rng.integers(0, 50, (nb, 128)).astype(np.uint32)
    deltas[:, 0] = 0
    tf = rng.integers(tf_lo, 30, (nb, 128)).astype(np.uint32)
    pd, bwd = jpack.pack_ref(jnp.asarray(deltas))
    pt, bwt = jpack.pack_ref(jnp.asarray(tf))
    first = rng.integers(0, 5000, nb).astype(np.int32)
    idf = (rng.random(nb) * 4).astype(np.float32)
    act = (rng.random(nb) < 0.85).astype(np.int32)
    return rng, [np.asarray(pd), np.asarray(bwd), first, np.asarray(pt),
                 np.asarray(bwt), idf, act]


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype or (g.dtype == np.int32
                                     and want.dtype == np.uint32), \
        (g.dtype, want.dtype)
    np.testing.assert_array_equal(g.view(want.dtype) if g.dtype != want.dtype
                                  else g, want)
    if want.dtype == np.float32:  # bit-equal, not just value-equal
        np.testing.assert_array_equal(g.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("nb", [4, 32, 37])
def test_bm25_blocks_matches_jax(nb):
    _, args = _blocks(nb, nb)
    want = _plain_ref_jit(*map(jnp.asarray, args))
    got = tops.bm25_blocks(*map(_torch, args))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("nb", [8, 64, 256])
def test_bm25_partials_match_pallas_interpret(nb):
    """The ``partials`` flag: outputs plus the running (1, 128) carry, vs
    the Pallas kernel run in interpret mode."""
    _, args = _blocks(nb, nb + 1)
    want = bm25_blocks_pallas(*map(jnp.asarray, args), block_rows=min(
        64, nb), interpret=True, partials=True)
    got = tops.bm25_blocks_partials(*map(_torch, args))
    assert got[3].shape == (1, 128)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(tref.lane_partials_ref(got[1], got[2]),
        jref.lane_partials_ref(want[1], want[2]))


@pytest.mark.parametrize("k", [1, 2, 10, 32])
def test_kth_lane_partial_matches_jax(k):
    rng = np.random.default_rng(k)
    part = np.round(rng.random((16, 128)) * 8, 1).astype(np.float32)
    part[3] = 0.0
    part[5, :4] = 7.5        # ties at the top
    _eq(tref._kth_lane_partial(torch.from_numpy(part), k),
        _kth_ref_jit(jnp.asarray(part), k=k))


@pytest.mark.parametrize("nb", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_midgrid_matches_jax_every_bucket(nb, k):
    """Every pow2 survivor bucket the compacted path emits, the serving
    k's, and real mid-grid skips: (docids, tf, num, skip) bit-equal."""
    rng, args = _blocks(nb, nb * 31 + k)
    n_rows = int(rng.integers(1, 129))
    rows = rng.integers(0, n_rows, nb).astype(np.int32)
    ubf = (rng.random(nb) * 8).astype(np.float32)
    ubf[rng.random(nb) < 0.05] = np.inf          # unconditional probe keeps
    theta = np.zeros((1, 128), np.float32)
    theta[0, :n_rows] = rng.random(n_rows).astype(np.float32)
    nmax = np.float32(0.9 * (1.0 - 0.4 + 0.4 * 2.0))
    full = args + [rows, ubf, theta]
    for br in ((8, 4) if nb == 64 else (8,)):
        want = _midgrid_ref_jit(*map(jnp.asarray, full), jnp.float32(nmax),
                                k=k, block_rows=br)
        got = tops.bm25_blocks_midgrid(*map(_torch, full),
                                       torch.tensor(nmax), k=k,
                                       block_rows=br)
        for g, w in zip(got, want):
            _eq(g, w)
    if nb >= 128 and k == 1:
        assert got[3].sum() > 0, "carry never engaged on a large bucket"


@pytest.mark.parametrize("n_rows", [1, 2, 127, 128])
def test_midgrid_row_edges(n_rows):
    """Row attribution at the carry's edges: one row, and all 128 lanes."""
    rng, args = _blocks(64, n_rows)
    rows = rng.integers(0, n_rows, 64).astype(np.int32)
    ubf = (rng.random(64) * 6).astype(np.float32)
    theta = np.zeros((1, 128), np.float32)
    theta[0, :n_rows] = (rng.random(n_rows) * 2).astype(np.float32)
    full = args + [rows, ubf, theta]
    want = _midgrid_ref_jit(*map(jnp.asarray, full), jnp.float32(1.2),
                            k=10, block_rows=8)
    got = tops.bm25_blocks_midgrid(*map(_torch, full), 1.2, k=10)
    for g, w in zip(got, want):
        _eq(g, w)

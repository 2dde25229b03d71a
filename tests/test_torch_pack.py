"""Port parity: the PyTorch plain version of lane-blocked PFor packing vs
the JAX package's oracle and its Pallas kernel (interpret mode), on the
same numpy inputs. Words must match bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.postings_pack import ref as jref
from repro.kernels.postings_pack.kernel import pack_pallas, unpack_pallas
from repro_torch.kernels.postings_pack import ops as tops
from repro_torch.kernels.postings_pack import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("nb", [8, 64, 256])
@pytest.mark.parametrize("scale", [1, 7, 1000, 2 ** 20, 2 ** 31 - 1])
def test_pack_matches_jax(nb, scale):
    rng = np.random.default_rng(nb * 7 + scale % 97)
    d = rng.integers(0, scale, size=(nb, 128), dtype=np.int64
                     ).astype(np.uint32)
    p_j, bw_j = jref.pack_ref(jnp.asarray(d))
    p_t, bw_t = tops.pack(_t(d))
    np.testing.assert_array_equal(_u32(p_t), np.asarray(p_j))
    np.testing.assert_array_equal(bw_t.numpy(), np.asarray(bw_j))
    assert bw_t.dtype == torch.int32 and p_t.shape == (nb, 32, 4)
    if nb == 64:  # the Pallas kernel itself, once per scale
        p_k, bw_k = pack_pallas(jnp.asarray(d), block_rows=64)
        np.testing.assert_array_equal(_u32(p_t), np.asarray(p_k))
        np.testing.assert_array_equal(bw_t.numpy(), np.asarray(bw_k))
    np.testing.assert_array_equal(_u32(tops.unpack(p_t, bw_t)), d)


@pytest.mark.parametrize("fill,want_bw", [(0, 0), (0xFFFFFFFF, 32),
                                          (1, 1), (2 ** 31, 32)])
def test_pack_edge_widths(fill, want_bw):
    d = np.full((16, 128), fill, np.uint32)
    p_t, bw_t = tops.pack(_t(d))
    assert (bw_t.numpy() == want_bw).all()
    p_k, bw_k = pack_pallas(jnp.asarray(d), block_rows=16)
    np.testing.assert_array_equal(_u32(p_t), np.asarray(p_k))
    u_k = unpack_pallas(p_k, bw_k, block_rows=16)
    np.testing.assert_array_equal(_u32(tops.unpack(p_t, bw_t)),
                                  np.asarray(u_k))
    np.testing.assert_array_equal(_u32(tops.unpack(p_t, bw_t)), d)


@pytest.mark.parametrize("seed", range(4))
def test_unpack_matches_jax_on_jax_packed_words(seed):
    """Unpack words the JAX oracle packed (mixed widths in one array)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 33, 32)
    d = np.stack([rng.integers(0, 2 ** int(w), 128, dtype=np.uint64)
                  for w in widths]).astype(np.uint32)
    p_j, bw_j = jref.pack_ref(jnp.asarray(d))
    got = tref.unpack_ref(_t(np.asarray(p_j)),
                          torch.from_numpy(np.array(bw_j)))
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(jref.unpack_ref(p_j, bw_j)))
    np.testing.assert_array_equal(
        tref.bit_width(_t(d.max(axis=1))).numpy(),
        np.asarray(jref.bit_width(jnp.asarray(d.max(axis=1)))))
    assert tref.packed_bytes(torch.from_numpy(np.array(bw_j))) == float(
        jref.packed_bytes(bw_j))


def test_compact_planes_roundtrip_matches_jax():
    rng = np.random.default_rng(50)
    vals = rng.integers(0, 1 << 16, (6, 128)).astype(np.uint32)
    vals[0] = 0                       # bw = 0
    vals[1] = 0xFFFFFFFF              # bw = 32
    p_j, bw_j = jref.pack_ref(jnp.asarray(vals))
    rows_j = jref.compact_planes(np.asarray(p_j), np.asarray(bw_j))
    p_t, bw_t = tops.pack(_t(vals))
    rows_t = tref.compact_planes(p_t, bw_t)
    np.testing.assert_array_equal(_u32(rows_t), rows_j)
    back = tref.expand_planes(rows_t, bw_t)
    np.testing.assert_array_equal(
        _u32(back), jref.expand_planes(rows_j, np.asarray(bw_j)))
    np.testing.assert_array_equal(_u32(tops.unpack(back, bw_t)), vals)
    with pytest.raises(ValueError):
        tref.expand_planes(rows_t[:-1], bw_t)


def test_pad_to_blocks():
    s = torch.arange(1, 300, dtype=torch.int32)
    blocks, n = tops.pad_to_blocks(s, fill=0)
    assert n == 299 and blocks.shape == (3, 128)
    assert blocks.reshape(-1)[299:].eq(0).all()
    assert torch.equal(blocks.reshape(-1)[:299], s)

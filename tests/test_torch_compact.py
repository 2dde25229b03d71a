"""Port parity of the compact index layout and its fused
decompress-and-score op (``bm25_blocks_compact``) against the JAX
package, on the CPU:

  * the compact ``build_block_index`` equals the JAX package's compact
    build field for field, and its plane rows expand to the dense build's
    planes;
  * ``bm25_blocks_compact_ref`` (the plain version the CUDA kernel is held
    against) equals the JAX package's ``bm25_blocks_compact_ref`` and its
    ``bm25_blocks_ref`` over ``expand_planes``, with bw-0 and bw-32 blocks
    and the last block of the rows array selected (the Pallas form fails in
    interpret mode on this JAX, so the jnp oracles stand in for it);
  * the slice: a committed multi-segment index recovered through
    ``open_searcher(..., ReaderCache(compact=True))`` serves the same top-k
    values, ids and PruneStats as the JAX package's, the same values and
    ids as the port's dense layout, and pruned equals exhaustive.

Inputs come from numpy seeds; integers are equal and f32 is equal bit for
bit everywhere."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.searcher import ReaderCache as JReaderCache
from repro.core.searcher import build_block_index as j_build
from repro.core.segments import Segment as JSegment
from repro.kernels.bm25_blockmax import ref as jbm25
from repro.kernels.postings_pack import ref as jpack
from repro.storage import commit as jcommit
from repro.storage import directory as jdir
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.convert import block_index_from_repro
from repro_torch.core.indexer import Indexer
from repro_torch.core.merge import merge_segments, reassign_doc_ids
from repro_torch.core.searcher import IndexSearcher, ReaderCache
from repro_torch.core.searcher import build_block_index as t_build
from repro_torch.core.segments import Segment
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.kernels.bm25_blockmax import ops as tops
from repro_torch.kernels.bm25_blockmax import ref as tbm25
from repro_torch.kernels.postings_pack import ref as tpack
from repro_torch.storage import commit as tcommit
from repro_torch.storage import directory as tdir

COMPACT_FIELDS = ("terms", "term_block_start", "idf", "bw_docs", "bw_tf",
                  "first_doc", "max_tf", "doc_norm", "min_dl", "last_doc",
                  "cplanes_docs", "coff_docs", "cplanes_tf", "coff_tf")
STAT_FIELDS = ("queries", "batches", "segments_visited", "segments_skipped",
               "blocks_candidate", "blocks_survived", "blocks_scored",
               "terms_eliminated", "blocks_skipped_midgrid")
SEG_ARRAYS = ("terms", "term_start", "docs", "tf", "positions", "pos_start",
              "doc_ids", "doc_len", "deletes", "reorder", "generation")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 \
        else t.numpy()


# ---------------------------------------------------------------------------
# the kernel module: bm25_blocks_compact's plain version
# ---------------------------------------------------------------------------

def _compact_inputs(seed, S, nb=48):
    """Random blocks packed into compact rows, and an S-block selection
    that includes a bw-0 block, a bw-32 block and the rows array's last
    block (whose 32-row window ends in the tail padding)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("docs", "tf"):
        widths = rng.integers(0, 33, nb)
        widths[:2] = (0, 32)
        widths[-1] = 32 if name == "docs" else int(rng.integers(1, 33))
        vals = np.stack([rng.integers(0, 1 << int(w), 128, dtype=np.uint64)
                         if w else np.zeros(128, np.uint64)
                         for w in widths]).astype(np.uint32)
        packed, bw = tpack.pack_ref(torch.from_numpy(vals.view(np.int32)))
        rows = torch.cat([tpack.compact_planes(packed, bw),
                          torch.zeros((32, 4), dtype=torch.int32)])
        out[name] = (rows, (torch.cumsum(bw, 0) - bw).to(torch.int32), bw,
                     packed)
    flat = rng.integers(0, nb, S)
    flat[:min(S, 3)] = [0, 1, nb - 1][:min(S, 3)]
    first = rng.integers(-(1 << 31), 1 << 31, nb).astype(np.int32)
    first[1] = (1 << 31) - 5          # the prefix sum wraps around
    idf = rng.random(S).astype(np.float32) * 8
    active = (rng.random(S) < 0.8).astype(np.int32)
    active[:min(S, 3)] = 1
    return out, torch.from_numpy(flat), torch.from_numpy(first), \
        torch.from_numpy(idf), torch.from_numpy(active)


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_bm25_blocks_compact_ref_matches_jax(seed, S):
    planes, flat, first, idf, active = _compact_inputs(seed, S)
    rows_d, coff_d, bw_d, packed_d = planes["docs"]
    rows_t, coff_t, bw_t, packed_t = planes["tf"]
    args = (rows_d, coff_d[flat], bw_d[flat], first[flat], rows_t,
            coff_t[flat], bw_t[flat], idf, active)
    got = tbm25.bm25_blocks_compact_ref(*args, k1=0.9)
    # the CPU dispatch is the plain version
    for a, b in zip(tops.bm25_blocks_compact(*args, k1=0.9), got):
        assert torch.equal(a, b)
    j_args = [jnp.asarray(_as_u32(a)) for a in args]
    want = jbm25.bm25_blocks_compact_ref(*j_args, k1=0.9)
    # and the fixed-stride oracle over the expanded planes
    expanded = [jpack.expand_planes(_as_u32(r)[:-32], _as_u32(b).astype(
        np.int64))[_as_u32(flat)] for r, b in ((rows_d, bw_d),
                                              (rows_t, bw_t))]
    np.testing.assert_array_equal(expanded[0], _as_u32(packed_d[flat]))
    plain = jbm25.bm25_blocks_ref(
        jnp.asarray(expanded[0]), j_args[2], j_args[3],
        jnp.asarray(expanded[1]), j_args[6], j_args[7], j_args[8], k1=0.9)
    for g, w, p in zip(got, want, plain):
        w, p = np.asarray(w), np.asarray(p)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))
        np.testing.assert_array_equal(w.view(np.uint32), p.view(np.uint32))
    assert bool((got[1][:min(S, 3)] >= 0).all())


# ---------------------------------------------------------------------------
# the compact build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """A committed three-segment index (tombstones in two segments)
    written by the port's durable indexer, with the port's own live
    segments and query vocabulary. It is written with the ``adaptive``
    codec: the JAX package decodes ``pfor`` streams eagerly, compiling
    per stream shape (seconds each), and the ``pfor`` recovery path is
    held in ``test_torch_storage.py``."""
    path = tmp_path_factory.mktemp("compact_index")
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    ix = Indexer(cfg=dataclasses.replace(SMOKE, codec="adaptive"),
                 device="cpu", target_dir=tdir.FSDirectory(str(path)))
    for i in range(3):
        ix.index_batch(corpus.batch(i, 32))
    rng = np.random.default_rng(5)
    live = ix.merger.live_segments()
    ix.delete(np.concatenate([rng.choice(s.doc_ids, s.n_docs // 5,
                                         replace=False)
                              for s in live[::2]]))
    ix.commit()
    segs = ix.merger.live_segments()
    ix.close()
    vocab = np.unique(np.concatenate([s.terms for s in segs]))
    return str(path), segs, vocab


def _j_segment(seg):
    return JSegment(**{n: getattr(seg, n) for n in SEG_ARRAYS})


def test_compact_build_matches_jax_field_for_field(committed):
    _, segs, _ = committed
    merged = merge_segments(list(segs[:2]))
    perm = reassign_doc_ids(merged, min_partition=16)
    assert perm is not None
    merged = dataclasses.replace(merged, reorder=perm)
    for seg in [*segs, merged]:
        want = j_build(_j_segment(seg), compact=True)
        got = t_build(seg, compact=True, device="cpu")
        assert got.compact and want.compact
        assert got.packed_docs is None and want.packed_docs is None
        for name in COMPACT_FIELDS:
            w, g = np.asarray(getattr(want, name)), getattr(got, name)
            g = _as_u32(g) if w.dtype == np.uint32 else g.numpy()
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)
        for name in ("n_docs", "max_blocks_per_term", "avgdl", "k1", "b"):
            assert getattr(got, name) == getattr(want, name), name
        dense = t_build(seg, device="cpu")
        for rows, bw, packed in ((got.cplanes_docs, got.bw_docs,
                                  dense.packed_docs),
                                 (got.cplanes_tf, got.bw_tf, dense.packed_tf)):
            assert bool((rows[-32:] == 0).all())
            assert torch.equal(tpack.expand_planes(rows[:-32], bw), packed)
        # the converter carries the JAX package's compact index over
        conv = block_index_from_repro(want)
        for name in COMPACT_FIELDS:
            assert torch.equal(getattr(conv, name), getattr(got, name)), name


# ---------------------------------------------------------------------------
# the slice: recovered commit served through the compact layout
# ---------------------------------------------------------------------------

def _queries(vocab, seed, B=8, Q=4):
    rng = np.random.default_rng(seed)
    q = rng.choice(vocab[:64], size=(B, Q)).astype(np.int32)  # head-heavy
    q[:, 1] = rng.choice(vocab, size=B)
    q[1, 3] = -1                       # padding
    q[2, 2] = 10 ** 6                  # absent everywhere
    return q


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


@pytest.mark.parametrize("tombstones", [True, False])
def test_compact_serving_matches_jax_and_dense(committed, tombstones):
    path, segs, vocab = committed
    if tombstones:
        cache_t = ReaderCache(compact=True, device="cpu")
        _, ts = tcommit.open_searcher(tdir.FSDirectory(path), cache_t)
        _, js = jcommit.open_searcher(jdir.FSDirectory(path),
                                      JReaderCache(compact=True))
        _, dense = tcommit.open_searcher(tdir.FSDirectory(path),
                                         ReaderCache(device="cpu"))
    else:
        # the same segments minus their tombstones: the dense layout's
        # midgrid gate opens, the compact one's stays shut
        plain = [Segment(**{n: getattr(s, n) for n in SEG_ARRAYS
                            if n != "deletes"}) for s in segs]
        ts = ReaderCache(compact=True, device="cpu").refresh(plain)
        js = JReaderCache(compact=True).refresh(
            [_j_segment(s) for s in plain])
        dense = ReaderCache(device="cpu").refresh(plain)
    assert ts.n_segments == 3 and ts.n_docs == js.n_docs
    assert all(r.index.compact for r in ts.readers)
    exhaustive = IndexSearcher(readers=ts.readers, prune=False,
                               device="cpu")
    for seed, k in ((0, 10), (2, 32)):
        q = _queries(vocab, seed)
        v_t, i_t = ts.search_batched(q, k)
        v_j, i_j = js.search_batched(q, k)
        np.testing.assert_array_equal(_bits(v_t), _bits(v_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        v_d, i_d = dense.search_batched(q, k)
        np.testing.assert_array_equal(_bits(v_t), _bits(v_d))
        np.testing.assert_array_equal(i_t.numpy(), i_d.numpy())
        v_e, _ = exhaustive.search_batched(q, k)
        np.testing.assert_array_equal(_bits(v_t), _bits(v_e))
        # every id carries its true score (ties may reorder ids)
        v_all, i_all = exhaustive.search_batched(q, ts.n_docs)
        for b in range(q.shape[0]):
            truth = dict(zip(i_all[b].tolist(), _bits(v_all[b]).tolist()))
            for d, bits in zip(i_t[b].tolist(), _bits(v_t[b]).tolist()):
                assert d < 0 or truth[d] == bits
    for f in STAT_FIELDS:
        assert getattr(ts.prune_stats, f) == getattr(js.prune_stats, f), f
    assert ts.prune_stats.blocks_skipped_midgrid == 0
    assert ts.prune_stats.blocks_scored > 0

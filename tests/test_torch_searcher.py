"""Port parity of the read path: the block-max reader build, field by field,
and multi-segment pruned search (BMW and midgrid each on and off, with
tombstones and a BP-reordered segment) against the JAX package on
identical segments — top-k values bit-identical, ids identical, every
PruneStats counter equal — plus the port's own invariant, pruned ==
exhaustive bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lucene_envelope import SMOKE as J_SMOKE
from repro.core.indexer import DistributedIndexer
from repro.core.merge import merge_segments, reassign_doc_ids
from repro.core.query import bm25_exhaustive as j_exhaustive
from repro.core.searcher import ReaderCache as JReaderCache
from repro.core.searcher import build_block_index as j_build
from repro.data.corpus import TINY, SyntheticCorpus
from repro_torch.convert import block_index_from_repro, segment_from_repro
from repro_torch.core.query import bm25_exhaustive, bm25_topk
from repro_torch.core.searcher import IndexSearcher, ReaderCache
from repro_torch.core.searcher import build_block_index as t_build

INDEX_FIELDS = ("terms", "term_block_start", "idf", "packed_docs", "bw_docs",
                "packed_tf", "bw_tf", "first_doc", "max_tf", "doc_norm",
                "min_dl", "last_doc")
STAT_FIELDS = ("queries", "batches", "segments_visited", "segments_skipped",
               "blocks_candidate", "blocks_survived", "blocks_scored",
               "terms_eliminated", "blocks_skipped_midgrid")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def seg_sets():
    """JAX-indexed live segments (merged tier + fresh flushes) in three
    variants — plain, tombstoned, one BP-reordered merge output — each
    with its port copy made by ``convert.segment_from_repro``."""
    corpus = SyntheticCorpus(TINY, doc_buffer_len=J_SMOKE.doc_len)
    ix = DistributedIndexer(cfg=J_SMOKE)
    for i in range(10):
        ix.index_batch(corpus.batch(i, 32))
    ix._flush()
    plain = ix.merger.live_segments()
    rng = np.random.default_rng(5)
    tomb = [s.with_deletes(rng.choice(s.doc_ids, size=s.n_docs // 5,
                                      replace=False)) if i % 2 == 0 else s
            for i, s in enumerate(plain)]
    merged = merge_segments(list(plain[:2]))
    perm = reassign_doc_ids(merged, min_partition=16)
    assert perm is not None
    reordered = [dataclasses.replace(merged, reorder=perm)] + plain[2:]
    vocab = np.unique(np.concatenate([s.terms for s in plain]))
    out = {}
    for name, segs in (("plain", plain), ("tombstoned", tomb),
                       ("reordered", reordered)):
        base_ids = {}
        out[name] = (segs, [segment_from_repro(s, base_ids) for s in segs])
    return out, vocab


def _queries(vocab, seed, B=8, Q=4):
    rng = np.random.default_rng(seed)
    q = rng.choice(vocab[:64], size=(B, Q)).astype(np.int32)  # head-heavy
    q[:, 1] = rng.choice(vocab, size=B)
    q[1, 3] = -1                       # padding
    q[2, 2] = 10 ** 6                  # absent everywhere
    return q


@pytest.mark.parametrize("variant", ["plain", "tombstoned", "reordered"])
def test_build_block_index_matches_jax(seg_sets, variant):
    sets, _ = seg_sets
    j_segs, t_segs = sets[variant]
    for js, ts in zip(j_segs, t_segs):
        want, got = j_build(js), t_build(ts, device="cpu")
        for name in INDEX_FIELDS:
            w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
            if w.dtype == np.uint32:
                g = g.view(np.uint32)
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)
        for name in ("n_docs", "max_blocks_per_term", "avgdl", "k1", "b"):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("variant,bmw,midgrid", [
    ("plain", True, True), ("plain", True, False), ("plain", False, True),
    ("plain", False, False), ("tombstoned", True, True),
    ("reordered", True, True)])
def test_search_batched_matches_jax(seg_sets, variant, bmw, midgrid):
    sets, vocab = seg_sets
    j_segs, t_segs = sets[variant]
    js = JReaderCache(bmw=bmw, midgrid=midgrid).refresh(j_segs)
    ts = ReaderCache(bmw=bmw, midgrid=midgrid, device="cpu").refresh(t_segs)
    assert ts.n_docs == js.n_docs and ts.avgdl == js.avgdl
    cases = ((0, 10), (2, 32)) if (bmw and midgrid) else ((0, 10),)
    for seed, k in cases:
        q = _queries(vocab, seed)
        v_j, i_j = js.search_batched(q, k)
        v_t, i_t = ts.search_batched(q, k)
        np.testing.assert_array_equal(v_t.numpy().view(np.uint32),
                                      np.asarray(v_j).view(np.uint32))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    for f in STAT_FIELDS:
        assert getattr(ts.prune_stats, f) == getattr(js.prune_stats, f), f
    if variant == "plain" and midgrid:
        assert ts.prune_stats.segments_visited > 0


@pytest.mark.parametrize("variant", ["plain", "tombstoned", "reordered"])
def test_pruned_equals_exhaustive(seg_sets, variant):
    """The port's own contract: pruned top-k == dense exhaustive top-k,
    bit for bit, on the same readers; and the dense path == JAX's."""
    sets, vocab = seg_sets
    j_segs, t_segs = sets[variant]
    pruned = ReaderCache(device="cpu").refresh(t_segs)
    dense = IndexSearcher(readers=pruned.readers, prune=False, device="cpu")
    j_dense = JReaderCache(prune=False).refresh(j_segs)
    q = _queries(vocab, 7)
    v_p, _ = pruned.search_batched(q, 10)
    v_d, i_d = dense.search_batched(q, 10)
    np.testing.assert_array_equal(v_p.numpy().view(np.uint32),
                                  v_d.numpy().view(np.uint32))
    v_j, i_j = j_dense.search_batched(q, 10)
    np.testing.assert_array_equal(v_d.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(i_d.numpy(), np.asarray(i_j))
    assert pruned.prune_stats.blocks_scored > 0


def test_converted_index_single_query_paths(seg_sets):
    """``convert.block_index_from_repro`` carries the JAX package's packed
    index over field for field (equal to the port's own build of the same
    segment), and the port's single-query paths score it exactly: pruned
    with and without midgrid == exhaustive == JAX exhaustive."""
    sets, vocab = seg_sets
    merged = merge_segments(list(sets["plain"][0]))
    j_idx = j_build(merged)
    t_idx = block_index_from_repro(j_idx)
    own = t_build(segment_from_repro(merged), device="cpu")
    for name in INDEX_FIELDS:
        assert torch.equal(getattr(t_idx, name), getattr(own, name)), name
    q = _queries(vocab, 21)[0]
    j_ex = jax.jit(lambda qq: j_exhaustive(j_idx, qq, 10)[:2])
    v_je, i_je = j_ex(jnp.asarray(q))
    v_e, i_e, _ = bm25_exhaustive(t_idx, q, 10)
    np.testing.assert_array_equal(v_e.numpy(), np.asarray(v_je))
    np.testing.assert_array_equal(i_e.numpy(), np.asarray(i_je))
    for midgrid in (True, False):
        v_t, i_t, st = bm25_topk(t_idx, q, 10, midgrid=midgrid)
        np.testing.assert_array_equal(v_t.numpy().view(np.uint32),
                                      v_e.numpy().view(np.uint32))
        assert st["prune_stats"].blocks_scored > 0

"""Port parity: sort inversion (``invert_shard``, ``doc_vectors``) and the
host ``Segment`` built from its run, PyTorch vs the JAX package on the same
token buffers — every field exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import invert as jinv
from repro.core.segments import segment_from_run as j_segment_from_run
from repro.data.corpus import TINY as J_TINY
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro_torch.core import invert as tinv
from repro_torch.core.segments import segment_from_run
from repro_torch.data.corpus import TINY, SyntheticCorpus


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(seed, D=24, L=40, vocab=50):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (D, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, D)
    toks[np.arange(L)[None, :] >= lens[:, None]] = 0
    return toks


def test_corpus_batches_identical():
    """The port's copy of the generator emits the JAX package's batches."""
    for i in (0, 3):
        np.testing.assert_array_equal(
            SyntheticCorpus(TINY, doc_buffer_len=64).batch(i, 16),
            JCorpus(J_TINY, doc_buffer_len=64).batch(i, 16))


@pytest.mark.parametrize("seed", range(4))
def test_invert_shard_matches_jax(seed):
    toks = _tokens(seed)
    base = 1000 * seed
    want = jinv.invert_shard(jnp.asarray(toks), base)
    got = tinv.invert_shard(torch.from_numpy(toks), base)
    for name in jinv.InvertedRun._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.int32, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    run_j = {k: np.asarray(getattr(want, k)) for k in want._fields}
    run_t = {k: getattr(got, k).numpy() for k in got._fields}
    D = toks.shape[0]
    seg_j = j_segment_from_run(run_j, np.arange(base, base + D),
                               run_j["doc_len"])
    seg_t = segment_from_run(run_t, np.arange(base, base + D),
                             run_t["doc_len"])
    for name in ("terms", "term_start", "docs", "tf", "positions",
                 "pos_start", "doc_ids", "doc_len"):
        np.testing.assert_array_equal(getattr(seg_t, name),
                                      getattr(seg_j, name), err_msg=name)


def test_invert_corpus_batch_matches_jax():
    toks = SyntheticCorpus(TINY, doc_buffer_len=64).batch(2, 32)
    want = jinv.invert_shard(jnp.asarray(toks), 64)
    got = tinv.invert_shard(torch.from_numpy(toks), 64)
    for name in jinv.InvertedRun._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_scatter_targets_unique_outside_trash(seed):
    """The compaction scatters may collide only in the trash slot N: on
    CUDA ``index_put_`` picks an arbitrary winner among duplicates, which
    is harmless there and nowhere else."""
    toks = torch.from_numpy(_tokens(seed, D=16, L=32, vocab=12))
    D, L = toks.shape
    N = D * L
    term = torch.where(toks > 0, toks, tinv.TERM_PAD).reshape(-1)
    doc = torch.arange(D)[:, None].expand(D, L).reshape(-1)
    s_term, order = torch.sort(term, stable=True)
    s_doc = doc[order]
    valid = s_term != tinv.TERM_PAD
    new_term = (s_term != tinv._shift_right(s_term, -1)) & valid
    new_doc = (new_term | (s_doc != tinv._shift_right(s_doc, -1))) & valid
    for flag in (new_doc, new_term):
        tgt = torch.where(flag, torch.cumsum(flag, 0) - 1, N)
        kept = tgt[tgt < N]
        assert kept.numel() == int(flag.sum())
        assert torch.unique(kept).numel() == kept.numel()
    assert (tgt == N).sum() > 1   # the trash slot does take duplicates


def test_doc_vectors_match_jax():
    toks = _tokens(7, D=12, L=30, vocab=9)
    want = jinv.doc_vectors(jnp.asarray(toks))
    got = tinv.doc_vectors(torch.from_numpy(toks))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

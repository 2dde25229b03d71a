"""``Indexer.envelope_report`` of the port against the JAX package's
``DistributedIndexer.envelope_report`` on the same corpus batches, in four
runs: the 8 media pairs of ``examples/index_corpus.py`` in memory;
throttled ``nas -> ssd`` (two throttles) and ``ssd -> ssd`` (one shared
throttle) through ``index_spooled`` and ``finalize``; the WAL with deletes
and updates, committed, then dropped and reopened; and a ``QueryScheduler``
with a ``ResultCache`` attached. The reports hold the same keys and equal
values, except the keys read from a clock (``WALL``; with no throttle
also ``DEVICE_S``) and the process-global ``evaluator_cache_hits``;
throttle device seconds agree within 1e-9 relative and the throttles'
operation counts exactly. Commit manifests carry a timestamp, whose
printed length would move the bytes written by a byte or two: it is
pinned in both packages."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core.indexer import DistributedIndexer
from repro.data.corpus import (CW09B_SMALL as J_CW09B, SyntheticCorpus as
                               JCorpus, spool_corpus as j_spool)
from repro.serving.query_scheduler import (QueryRequest as JRequest,
                                           QueryScheduler as JScheduler)
from repro.serving.steady import ResultCache as JCache
from repro import storage as jst
from repro.storage import commit as j_commit
from repro_torch import storage as tst
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core import envelope as tenv
from repro_torch.core.indexer import Indexer
from repro_torch.data.corpus import (CW09B_SMALL, SyntheticCorpus,
                                     spool_corpus)
from repro_torch.serving.query_scheduler import QueryRequest, QueryScheduler
from repro_torch.serving.steady import ResultCache
from repro_torch.storage import commit as t_commit

JCFG = get_arch("lucene-envelope").smoke
WALL = {"wall_s_host", "merge_wall_s", "merge_io_paused_s",
        "t_envelope_measured_s", "evaluator_cache_hits"}
# device seconds with throttles (1e-9 relative), wall seconds without
DEVICE_S = {"t_source_busy_s", "t_target_busy_s", "t_io_measured_s",
            "gb_per_min_measured"}
K = 5
PAIRS = [("ceph", "zfs"), ("zfs", "zfs"), ("ceph", "xfs"), ("xfs", "xfs"),
         ("ceph", "ssd"), ("zfs", "ssd"), ("xfs", "ssd"), ("ssd", "ssd")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pinned_ts(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.25)
    for mod in (j_commit, t_commit):
        monkeypatch.setattr(mod, "time", clock)


def _batches(n, per):
    t = SyntheticCorpus(CW09B_SMALL, doc_buffer_len=SMOKE.doc_len)
    j = JCorpus(J_CW09B, doc_buffer_len=JCFG.doc_len)
    out = [t.batch(i, per) for i in range(n)]
    for i, b in enumerate(out):          # the two corpora are one corpus
        np.testing.assert_array_equal(b, j.batch(i, per))
    return out


def _compare(j: dict, t: dict, throttled: bool = False):
    assert set(j) == set(t), set(j) ^ set(t)
    skip = WALL if throttled else WALL | DEVICE_S
    for k in sorted(j):
        if k in skip:
            continue
        if k in DEVICE_S:
            assert t[k] == pytest.approx(j[k], rel=1e-9, abs=0.0), k
        elif k == "result_cache":
            jc, tc = dict(j[k]), dict(t[k])
            # the port's ids are int64 where the JAX package's are int32:
            # 4 more bytes per id of every stored entry
            assert tc.pop("bytes") == jc.pop("bytes") + 4 * K * jc[
                "entries"], k
            assert tc == jc, k
        else:
            assert t[k] == j[k], (k, j[k], t[k])
            assert type(t[k] == j[k]) in (bool, np.bool_), k


def test_media_pairs_in_memory_match_jax():
    """``examples/index_corpus.py``'s sweep: one indexer per pair over
    the same 12 batches, force-merged, then the report."""
    batches = _batches(12, 64)
    for src, tgt in PAIRS:
        j = DistributedIndexer(cfg=JCFG, source=src, target=tgt)
        t = Indexer(cfg=SMOKE, device="cpu", source=src, target=tgt)
        for ix in (j, t):
            for b in batches:
                ix.index_batch(b)
            ix.finalize()
        jr, tr = j.envelope_report(), t.envelope_report()
        _compare(jr, tr)
        assert tr["bound"] == jr["bound"] and tr["n_merges"] > 0
        j.close()
        t.close()


@pytest.mark.parametrize("pair", [("nas", "ssd"), ("ssd", "ssd")])
def test_throttled_pairs_through_spooled_source_match_jax(tmp_path, pair,
                                                         pinned_ts):
    """``benchmarks/run.py::envelope_measured``'s shape at 4 x 32 docs:
    spool into a throttled RAM source, ``index_spooled`` into a throttled
    FS target, ``finalize``. One throttle for both streams when the
    profile names match (the shared controller)."""
    sp, tp = pair
    reps, thr = {}, {}
    for name, st, cls, spool in (("jax", jst, DistributedIndexer, j_spool),
                                 ("torch", tst, Indexer, spool_corpus)):
        th_t = st.DeviceThrottle(st.MEDIA_PROFILES[tp])
        th_s = th_t if sp == tp else st.DeviceThrottle(st.MEDIA_PROFILES[sp])
        src = st.ThrottledDirectory(st.RAMDirectory(), th_s)
        tgt = st.ThrottledDirectory(st.FSDirectory(tmp_path / name), th_t)
        corpus = (JCorpus(J_CW09B, doc_buffer_len=JCFG.doc_len)
                  if name == "jax" else
                  SyntheticCorpus(CW09B_SMALL, doc_buffer_len=SMOKE.doc_len))
        spooled = spool(corpus, src, 4, 32)
        src.reset_counters()
        th_s.reset()
        kw = {} if name == "jax" else {"device": "cpu"}
        ix = cls(cfg=JCFG if name == "jax" else SMOKE,
                 source=tenv.PROFILE_TO_MEDIA[sp],
                 target=tenv.PROFILE_TO_MEDIA[tp], source_dir=src,
                 target_dir=tgt, **kw)
        assert ix.index_spooled() == 4 * 32
        ix.finalize()
        reps[name] = ix.envelope_report()
        thr[name] = [(th.ops_read, th.ops_write)
                     for th in dict.fromkeys((th_s, th_t))]
        assert reps[name]["bytes_read_measured"] == spooled
        ix.close()
    _compare(reps["jax"], reps["torch"], throttled=True)
    assert thr["torch"] == thr["jax"]
    t = reps["torch"]
    assert t["shared_media_measured"] == (sp == tp)
    assert t["t_io_measured_s"] > 0 and t["index_bytes_encoded"] > 0


def test_wal_deletes_updates_match_jax(tmp_path, pinned_ts):
    """The WAL counters: acked adds, deletes and updates, a commit that
    truncates, one more uncommitted batch, then a reopen that replays
    (the raw codec: the pfor streams are the throttled runs' part)."""
    batches = _batches(5, 32)
    reps = {}
    for name, st, cls in (("jax", jst, DistributedIndexer),
                          ("torch", tst, Indexer)):
        kw = {} if name == "jax" else {"device": "cpu"}
        cfg = dataclasses.replace(JCFG if name == "jax" else SMOKE,
                                  codec="raw")
        ix = cls(cfg=cfg, target_dir=st.FSDirectory(tmp_path / name),
                 wal=True, **kw)
        for b in batches[:3]:
            ix.index_batch(b)
        ix.delete([3, 5, 40])
        ix.update(7, batches[3][0])
        ix.update(50, batches[3][1])
        ix.commit()
        ix.index_batch(batches[4])
        ix.delete([70, 71])
        first = ix.envelope_report()
        ix.close()
        ix2 = cls(cfg=cfg, target_dir=st.FSDirectory(tmp_path / name),
                  wal=True, **kw)
        ix2.refresh()
        reps[name] = (first, ix2.envelope_report())
        ix2.close()
    for j, t in zip(reps["jax"], reps["torch"]):
        _compare(j, t)
    first, reopened = reps["torch"]
    assert first["wal_appends"] > 0 and first["deletes_acked"] == 7
    assert first["updates_acked"] == 2 and reopened["wal_replayed"] > 0


def test_attached_scheduler_and_result_cache_match_jax():
    """``attach_serving``: refreshes swap the scheduler's searcher, and
    the report carries its ``serve_*`` counters and the result cache's."""
    batches = _batches(4, 32)
    rng = np.random.default_rng(3)
    vocab = np.unique(batches[0][batches[0] > 0])
    qs = [rng.choice(vocab, 3, replace=False).astype(np.int32)
          for _ in range(6)]
    reps = {}
    for name in ("jax", "torch"):
        if name == "jax":
            ix = DistributedIndexer(cfg=JCFG)
            mk = lambda s: JScheduler(searcher=s, slots=4, max_terms=3,  # noqa: E731
                                      k=K, cache=JCache())
            req = JRequest
        else:
            ix = Indexer(cfg=SMOKE, device="cpu")
            mk = lambda s: QueryScheduler(searcher=s, slots=4,  # noqa: E731
                                          max_terms=3, k=K,
                                          cache=ResultCache(), device="cpu")
            req = QueryRequest
        for b in batches[:2]:
            ix.index_batch(b)
        sched = mk(ix.refresh())
        ix.attach_serving(sched)
        rid = 0
        for rnd in range(2):
            for q in qs + qs[:3]:          # the repeats hit the cache
                sched.submit(req(rid=rid, terms=q, k=K))
                rid += 1
                sched.run_to_completion()
            ix.index_batch(batches[2 + rnd])
            ix.delete([rnd + 1])
            assert ix.refresh() is sched.searcher   # swapped by the hook
        reps[name] = ix.envelope_report()
        ix.close()
    _compare(reps["jax"], reps["torch"])
    t = reps["torch"]
    assert t["serve_served"] == 12 and t["serve_cached"] == 6
    assert t["result_cache"]["hits"] == 6

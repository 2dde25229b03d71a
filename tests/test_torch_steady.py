"""Steady-state serving on the port (``repro_torch.serving.steady``): the
cases of ``tests/test_steady.py`` on ``repro_torch`` (continuous batching
bit-identical to wait-for-full and to the searcher, the launch rule,
admission control, the result cache's LRU-by-bytes mechanics and exact
invalidation, generations, the interleaving oracle, the open-loop driver
under churn and past saturation), ``warm_searcher``, and one seeded
sequence of submit / step / swap / churn ticks driven by hand on one
thread through both packages: equal answers bit for bit and equal
``ResultCache.report()`` (the port's ids are int64 where the JAX
package's are int32, 4 more bytes per stored id)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.registry import get_arch
from repro.core.indexer import DistributedIndexer
from repro.serving import steady as jsteady
from repro.serving.query_scheduler import (QueryRequest as JRequest,
                                           QueryScheduler as JScheduler)
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core.indexer import Indexer
from repro_torch.serving.query_scheduler import _bucket
from repro_torch.serving.steady import (LoadReport, Overloaded, QueryRequest,
                                        QueryScheduler, ResultCache,
                                        make_churn, run_open_loop,
                                        warm_searcher)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _toks(rng, n=16):
    return rng.integers(1, 4096, (n, 64)).astype(np.int32)


def _queries(rng, n, q=3):
    return [rng.choice(np.arange(1, 4096), q,
                       replace=False).astype(np.int32) for _ in range(n)]


def _ix():
    return Indexer(cfg=SMOKE, device="cpu")


def _sched(s, **kw):
    return QueryScheduler(searcher=s, device="cpu", **kw)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), np.asarray(b, np.float32).view(np.uint32)
    np.testing.assert_array_equal(a, b)


def test_bucket_is_pow2_and_capped():
    assert [_bucket(n, 8) for n in (1, 2, 3, 4, 5, 7, 8, 9)] \
        == [1, 2, 4, 4, 8, 8, 8, 8]


def test_continuous_batching_bit_identical_to_full_batch():
    rng = np.random.default_rng(0)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 24))
        s = ix.refresh()
        queries = _queries(rng, 7)
        full = _sched(s, slots=4, max_terms=3, k=5, full_batch=True)
        cont = _sched(s, slots=4, max_terms=3, k=5, max_wait_ms=0.0)
        fr = [full.submit(QueryRequest(rid=i, terms=q, k=5))
              for i, q in enumerate(queries)]
        cr = []
        for i, q in enumerate(queries):
            cr.append(cont.submit(QueryRequest(rid=i, terms=q, k=5)))
            cont.maybe_step()
        full.run_to_completion()
        cont.run_to_completion()
        assert cont.steps == 7 and cont.partial_steps == 7
        assert full.steps == 2
        for a, b in zip(fr, cr):
            assert a.done and b.done
            _eq(a.scores, b.scores)
            _eq(a.doc_ids, b.doc_ids)
            v, i = s.search(a.terms, 5)
            _eq(a.scores, v)
            _eq(a.doc_ids, i)
    finally:
        ix.close()


def test_partial_launch_waits_for_max_wait_ms():
    rng = np.random.default_rng(1)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 8))
        s = ix.refresh()
        sched = _sched(s, slots=4, max_terms=3, k=5, max_wait_ms=50.0)
        sched.submit(QueryRequest(rid=0, terms=_queries(rng, 1)[0], k=5),
                     now=100.0)
        assert not sched.ready(now=100.0 + 0.049)
        assert sched.ready(now=100.0 + 0.051)
        for i in range(1, 4):
            sched.submit(QueryRequest(rid=i, terms=_queries(rng, 1)[0],
                                      k=5), now=100.0)
        assert sched.ready(now=100.0)
        oracle = _sched(s, slots=4, max_terms=3, k=5, full_batch=True)
        oracle.submit(QueryRequest(rid=9, terms=_queries(rng, 1)[0], k=5),
                      now=100.0)
        assert not oracle.ready(now=100.0 + 10.0)
        assert sched.maybe_step(now=100.0) and sched.partial_steps == 0
    finally:
        ix.close()


def test_admission_control_sheds_typed_overloaded():
    rng = np.random.default_rng(2)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 16))
        s = ix.refresh()
        sched = _sched(s, slots=4, max_terms=3, k=5, full_batch=True,
                       admit_cap=2)
        qs = _queries(rng, 4)
        admitted = [sched.submit(QueryRequest(rid=i, terms=q, k=5))
                    for i, q in enumerate(qs[:2])]
        for i, q in enumerate(qs[2:], start=2):
            with pytest.raises(Overloaded):
                sched.submit(QueryRequest(rid=i, terms=q, k=5))
        assert sched.rejected == 2 and sched.queue_depth == 2
        sched.run_to_completion()
        for r in admitted:
            assert r.done
            _eq(r.scores, s.search(r.terms, 5)[0])
        assert sched.served == 2
    finally:
        ix.close()


def _entry(tag, gen=1, k=5):
    key = ((tag.encode() * 3, k), gen)
    return key, (np.full(k, 1.5, np.float32), np.arange(k, dtype=np.int32))


def test_result_cache_lru_bytes_and_counters():
    cap = 3 * 107   # 20 B scores + 20 B ids + 3 B key + 64 B overhead
    c = ResultCache(cap_bytes=cap)
    k1, v1 = _entry("a")
    assert c.get(k1) is None and c.misses == 1
    for tag in ("a", "b", "c"):
        c.put(*_entry(tag))
    assert len(c) == 3 and c.bytes == cap
    got = c.get(k1)
    assert c.hits == 1
    np.testing.assert_array_equal(got[0], v1[0])
    c.put(*_entry("d"))               # over cap: evicts the LRU ("b")
    assert c.evictions == 1 and len(c) == 3 and c.bytes <= cap
    assert c.get(_entry("b")[0]) is None
    assert c.get(k1) is not None and c.get(_entry("d")[0]) is not None
    c.put(k1, v1)
    assert c.bytes == cap and len(c) == 3
    c.put(_entry("z")[0], (np.zeros(4096, np.float32),
                           np.zeros(4096, np.int32)))
    assert len(c) == 3
    rep = c.report()
    assert rep["entries"] == 3 and rep["bytes"] == cap
    assert rep["hits"] == c.hits and rep["evictions"] == 1
    c.clear()
    assert len(c) == 0 and c.bytes == 0


def test_result_cache_generations_are_distinct_keys():
    c = ResultCache()
    key_g1, val = _entry("q", gen=1)
    key_g2, _ = _entry("q", gen=2)
    c.put(key_g1, val)
    assert c.get(key_g2) is None
    assert c.get(key_g1) is not None


def test_generation_bumps_exactly_on_content_change():
    rng = np.random.default_rng(3)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 8))
        g1 = ix.refresh().generation
        assert g1 > 0
        assert ix.refresh().generation == g1       # no-op refresh
        ix.index_batch(_toks(rng, 8))
        g2 = ix.refresh().generation
        assert g2 != g1
        ix.delete([0])
        assert ix.refresh().generation not in (g1, g2)
    finally:
        ix.close()


def test_no_stale_hit_survives_a_swap():
    rng = np.random.default_rng(4)
    ix = _ix()
    try:
        toks = _toks(rng, 16)
        ix.index_batch(toks)
        sched = _sched(ix.refresh(), slots=4, max_terms=3, k=5,
                       cache=ResultCache())
        q = toks[0, :3].astype(np.int32)
        r1 = sched.submit(QueryRequest(rid=0, terms=q, k=5))
        sched.run_to_completion()
        r2 = sched.submit(QueryRequest(rid=1, terms=q, k=5))
        assert r2.cached and r2.done and sched.served_cached == 1
        _eq(r1.scores, r2.scores)
        top = int(np.asarray(r1.doc_ids)[0])
        assert float(np.asarray(r1.scores)[0]) > 0
        ix.delete([top])
        sched.swap_searcher(ix.refresh())
        r3 = sched.submit(QueryRequest(rid=2, terms=q, k=5))
        assert not r3.cached
        sched.run_to_completion()
        hits = np.asarray(r3.doc_ids)[np.asarray(r3.scores) > 0]
        assert top not in set(hits.tolist())
        _eq(r3.scores, sched.searcher.search(q, 5)[0])
    finally:
        ix.close()


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10 ** 6),
       st.lists(st.sampled_from(["index", "delete", "refresh", "query"]),
                min_size=6, max_size=12))
def test_cached_results_bit_identical_under_interleaving(seed, ops):
    rng = np.random.default_rng(seed)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 8))
        cache = ResultCache()
        sched = _sched(ix.refresh(), slots=4, max_terms=3, k=5, cache=cache)
        rid = 0
        for op in ops + ["query"]:
            if op == "index":
                ix.index_batch(_toks(rng, 4))
            elif op == "delete":
                if ix._next_doc:
                    ix.delete([int(rng.integers(0, ix._next_doc))])
            elif op == "refresh":
                sched.swap_searcher(ix.refresh())
            else:
                q = _queries(rng, 1)[0]
                pair = []
                for _ in range(2):
                    r = QueryRequest(rid=rid, terms=q, k=5)
                    rid += 1
                    sched.submit(r)
                    sched.run_to_completion()
                    assert r.done
                    pair.append(r)
                assert pair[1].cached
                v, i = sched.searcher.search(q, 5)
                for r in pair:
                    _eq(r.scores, v)
                    _eq(r.doc_ids, i)
        assert cache.hits >= 1
    finally:
        ix.close()


def test_open_loop_driver_sustains_load_under_churn():
    rng = np.random.default_rng(5)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 16))
        cache = ResultCache()
        sched = _sched(ix.refresh(), slots=4, max_terms=3, k=5, cache=cache,
                       max_wait_ms=1.0)
        pool = _queries(rng, 6)
        warm_searcher(sched.searcher, pool, 4, 3, 5)
        rep = run_open_loop(sched, pool, qps=120, duration_s=0.4, seed=7,
                            churn=make_churn(ix, sched, rng))
        assert isinstance(rep, LoadReport)
        assert rep.offered == 48
        assert rep.completed == rep.offered and rep.rejected == 0
        assert all(r.done for r in rep.requests)
        assert 0 <= rep.p50_ms <= rep.p99_ms <= rep.p999_ms
        assert rep.qps_achieved > 0 and rep.wall_s > 0
        assert rep.cached == sched.served_cached
        assert rep.max_queue_depth >= 0 and rep.mean_queue_depth >= 0
        row = rep.row()
        assert row["offered"] == 48 and "requests" not in row
    finally:
        ix.close()


def test_open_loop_counts_shed_arrivals_without_measuring_them():
    rng = np.random.default_rng(6)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 16))
        sched = _sched(ix.refresh(), slots=2, max_terms=3, k=5,
                       max_wait_ms=0.5, admit_cap=2)
        pool = _queries(rng, 4)
        warm_searcher(sched.searcher, pool, 2, 3, 5)
        rep = run_open_loop(sched, pool, qps=400, duration_s=0.15, seed=9)
        assert rep.completed + rep.rejected == rep.offered
        assert rep.rejected == sched.rejected
        for r in rep.requests[:5]:
            _eq(r.scores, sched.searcher.search(r.terms, 5)[0])
    finally:
        ix.close()


def test_warm_searcher_probes_every_bucket_and_occupancy():
    """One probe batch per pow2 bucket b <= slots and per pow2 occupancy
    r <= b: batch shapes (b, max_terms), r real lanes, the rest -1."""
    rng = np.random.default_rng(8)
    ix = _ix()
    try:
        ix.index_batch(_toks(rng, 16))
        s = ix.refresh()
        seen = []
        real = s.search_batched

        def spy(q, k, theta0=None):
            seen.append((q.shape, int((q[:, 0] >= 0).sum()), k))
            return real(q, k, theta0=theta0)

        s.search_batched = spy
        warm_searcher(s, _queries(rng, 3), 8, 3, 5)
        assert seen == [((b, 3), r, 5) for b in (1, 2, 4, 8)
                        for r in (1, 2, 4, 8) if r <= b]
    finally:
        ix.close()


def _hand_driven(pkg: str, seed: int = 11):
    """One seeded sequence of ops through one package, on one thread:
    submits, launch-rule steps (the clock given), full drains, manual
    swaps and ``make_churn`` ticks. Returns every finished request (rid
    order), the cache's report and the scheduler's counters."""
    rng = np.random.default_rng(seed)
    churn_rng = np.random.default_rng(seed + 1)
    if pkg == "jax":
        ix = DistributedIndexer(cfg=get_arch("lucene-envelope").smoke)
        cache, req = jsteady.ResultCache(), JRequest
        mk = lambda s: JScheduler(searcher=s, slots=4, max_terms=3, k=5,  # noqa: E731
                                  cache=cache, max_wait_ms=2.0)
        churn_of = jsteady.make_churn
    else:
        ix = Indexer(cfg=SMOKE, device="cpu")
        cache, req = ResultCache(), QueryRequest
        mk = lambda s: _sched(s, slots=4, max_terms=3, k=5,  # noqa: E731
                              cache=cache, max_wait_ms=2.0)
        churn_of = make_churn
    try:
        ix.index_batch(_toks(rng, 24))
        sched = mk(ix.refresh())
        churn = churn_of(ix, sched, churn_rng, docs_per_tick=4, doc_len=12,
                         vocab=500, delete_every=2)
        pool = _queries(rng, 5) + [np.array([7, 9], np.int32)]
        ops = rng.choice(["submit", "submit", "submit", "step", "drain",
                          "churn", "swap"], 60)
        done, rid, now = [], 0, 1000.0
        for op in ops:
            now += 0.001
            if op == "submit":
                sched.submit(req(rid=rid, terms=pool[int(rng.integers(
                    len(pool)))], k=5), now=now)
                rid += 1
            elif op == "step":
                done += sched.maybe_step(now=now)
            elif op == "drain":
                done += sched.run_to_completion()
            elif op == "churn":
                done += sched.run_to_completion()
                churn()
            else:
                ix.index_batch(_toks(rng, 2))
                sched.swap_searcher(ix.refresh())
        done += sched.run_to_completion()
        counters = (sched.served, sched.served_cached, sched.steps,
                    sched.partial_steps, sched.rejected)
        return ([(r.rid, r.cached, np.asarray(r.scores),
                  np.asarray(r.doc_ids)) for r in sorted(
                    done, key=lambda r: r.rid)], cache.report(), counters,
                rid)
    finally:
        ix.close()


def test_hand_driven_sequence_matches_jax():
    j_done, j_rep, j_cnt, j_n = _hand_driven("jax")
    t_done, t_rep, t_cnt, t_n = _hand_driven("torch")
    assert t_n == j_n and t_cnt == j_cnt
    # cached submits finish at submit and are not returned by a step
    assert len(t_done) == len(j_done) == j_cnt[0]
    for (jr, jc, jv, ji), (tr, tc, tv, ti) in zip(j_done, t_done):
        assert (tr, tc) == (jr, jc)
        _eq(tv, jv)
        _eq(ti, ji)
    t_bytes, j_bytes = t_rep.pop("bytes"), j_rep.pop("bytes")
    assert t_bytes == j_bytes + 4 * 5 * j_rep["entries"]
    assert t_rep == j_rep
    assert t_rep["hits"] > 0 and t_rep["puts"] > 0 and j_cnt[1] > 0

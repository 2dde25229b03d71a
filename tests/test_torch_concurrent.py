"""Background merges and the NRT refresh daemon of the port: the cases of
``tests/test_concurrent.py`` on ``repro_torch`` (slow, failing and flaky
merges monkeypatched into ``repro_torch.core.merge``), the end state of a
concurrent and of a daemon-refreshed run against the JAX package's
synchronous run, bit for bit, and the daemon's life: it starts, ticks,
folds acknowledged deletes within two ticks, stops on ``close()`` and
re-raises there what it died of. Every pool and daemon is closed in a
``finally``; every join and wait has a timeout."""
import dataclasses
import errno
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.core.merge as merge_mod
from repro.configs.registry import get_arch
from repro.core.indexer import DistributedIndexer
from repro.data.corpus import TINY as JTINY, SyntheticCorpus as JCorpus
from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.convert import segment_from_repro
from repro_torch.core.indexer import Indexer
from repro_torch.core.merge import (ConcurrentMergeScheduler, MergeDriver,
                                    MergeRateLimiter, MergeRetriesExhausted,
                                    merge_segments)
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.storage import (DeviceThrottle, FSDirectory, MEDIA_PROFILES,
                                 RetryPolicy, ThrottledDirectory)
from test_merge import ARRAY_FIELDS, make_segment

SLOW = 0.4  # artificial merge duration (s); flushes must not feel it


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def slow_merge(segs):
    time.sleep(SLOW)
    return merge_segments(segs)


@pytest.fixture
def slow_merges(monkeypatch):
    monkeypatch.setattr(merge_mod, "merge_segments", slow_merge)


def _flush_n(drv, n, rng, n_docs=4, spacing=1000):
    segs = [segment_from_repro(make_segment(rng, i * spacing, n_docs=n_docs))
            for i in range(n)]
    for s in segs:
        drv.add_flush(s)
    return segs


def _all_docs(segs):
    return np.sort(np.concatenate([s.doc_ids for s in segs]))


def test_flush_does_not_block_on_merge(slow_merges):
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=2)
    try:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        _flush_n(drv, 2, rng)  # the second flush fills tier 0
        elapsed = time.perf_counter() - t0
        assert elapsed < SLOW / 2, \
            f"flush stalled {elapsed:.3f}s behind a {SLOW}s merge"
        sched.drain()
        assert drv.n_merges == 1 and drv.merge_wall_s >= SLOW
    finally:
        sched.close()


def test_live_segments_complete_mid_merge(slow_merges):
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=1)
    try:
        segs = _flush_n(drv, 2, np.random.default_rng(1), n_docs=5)
        deadline = time.time() + 5
        while not drv._in_flight and time.time() < deadline:
            time.sleep(0.01)
        assert drv._in_flight, "merge was never claimed"
        assert (_all_docs(drv.live_segments()) == _all_docs(segs)).all()
        sched.drain()
        live = drv.live_segments()
        assert len(live) == 1 and live[0].generation == 1
        assert (np.sort(live[0].doc_ids) == _all_docs(segs)).all()
    finally:
        sched.close()


def test_failed_merge_restores_inputs(monkeypatch):
    def boom(segs):
        raise RuntimeError("merge exploded")

    monkeypatch.setattr(merge_mod, "merge_segments", boom)
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=1)
    try:
        segs = _flush_n(drv, 2, np.random.default_rng(2))
        with pytest.raises(RuntimeError, match="merge exploded"):
            sched.drain()
        assert {s.seg_id for s in drv.live_segments()} == \
            {s.seg_id for s in segs}
        assert not drv._in_flight and drv.n_merges == 0
    finally:
        sched.pool.shutdown(wait=True)


def test_transient_merge_failure_heals_on_retry(monkeypatch):
    calls = []

    def flaky(segs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return merge_segments(segs)

    monkeypatch.setattr(merge_mod, "merge_segments", flaky)
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=1)
    try:
        segs = _flush_n(drv, 2, np.random.default_rng(5))
        try:
            sched.drain()
        except RuntimeError:
            assert drv.n_merges == 0
            sched.drain()
        assert drv.n_merges == 1 and len(calls) == 2
        merged = drv.live_segments()
        assert len(merged) == 1
        assert (merged[0].doc_ids == _all_docs(segs)).all()
        sched.drain()  # healthy: no stale error re-raised
    finally:
        sched.close()


def test_finalize_drains_inflight_merges(slow_merges):
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=2)
    try:
        segs = _flush_n(drv, 4, np.random.default_rng(3))
        final = drv.finalize()
        assert (final.doc_ids == _all_docs(segs)).all()
        assert drv.live_segments() == [final] and not drv._in_flight
    finally:
        sched.close()


def test_failing_batch_restores_inputs_while_others_complete(monkeypatch):
    real = merge_segments

    def selective(segs):
        if min(s.doc_ids[0] for s in segs) == 0:   # batch [s0, s1] only
            raise RuntimeError("batch A exploded")
        return real(segs)

    monkeypatch.setattr(merge_mod, "merge_segments", selective)
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(drv, max_threads=2)
    try:
        segs = _flush_n(drv, 4, np.random.default_rng(6))
        with pytest.raises(RuntimeError, match="batch A exploded"):
            sched.drain()
        live = drv.live_segments()
        assert (_all_docs(live) == _all_docs(segs)).all()
        assert {s.seg_id for s in segs[:2]} <= {s.seg_id for s in live}
        assert drv.n_merges == 1 and not drv._in_flight
    finally:
        sched.pool.shutdown(wait=True)


def test_merge_retry_policy_reenqueues_and_converges(monkeypatch):
    calls = []

    def flaky(segs):
        calls.append(1)
        if len(calls) <= 2:
            raise OSError(errno.EIO, "merge IO hiccup")
        return merge_segments(segs)

    monkeypatch.setattr(merge_mod, "merge_segments", flaky)
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(
        drv, max_threads=1, retry_policy=RetryPolicy(
            max_retries=3, base_delay_s=1e-4, max_delay_s=1e-3))
    try:
        segs = _flush_n(drv, 2, np.random.default_rng(7))
        sched.drain()
        assert drv.n_merges == 1 and len(calls) == 3
        assert sched.merge_retries == 2
        merged = drv.live_segments()
        assert len(merged) == 1
        assert (merged[0].doc_ids == _all_docs(segs)).all()
        sched.drain()
    finally:
        sched.close()


def test_merge_retries_exhausted_is_typed_and_restores_inputs(monkeypatch):
    def boom(segs):
        raise OSError(errno.EIO, "dead controller")

    monkeypatch.setattr(merge_mod, "merge_segments", boom)
    drv = MergeDriver(fanout=2)
    sched = ConcurrentMergeScheduler(
        drv, max_threads=1, retry_policy=RetryPolicy(
            max_retries=2, base_delay_s=1e-4, max_delay_s=1e-3))
    try:
        segs = _flush_n(drv, 2, np.random.default_rng(8))
        with pytest.raises(MergeRetriesExhausted) as e:
            sched.drain()
        assert e.value.attempts in (3, 4)
        assert isinstance(e.value.__cause__, OSError)
        assert sched.merge_retries == 2
        assert {s.seg_id for s in drv.live_segments()} == \
            {s.seg_id for s in segs}
        assert not drv._in_flight and drv.n_merges == 0
    finally:
        sched.pool.shutdown(wait=True)


def test_indexer_merge_retries_reach_the_scheduler(monkeypatch):
    """``Indexer(merge_retries=...)`` gives its scheduler the retry
    policy: a merge that faults twice heals, and the report counts it."""
    calls = []

    def flaky(segs, reorder=False):
        calls.append(1)
        if len(calls) <= 2:
            raise OSError(errno.EIO, "merge IO hiccup")
        return merge_segments(segs, reorder=reorder)

    monkeypatch.setattr(merge_mod, "merge_segments", flaky)
    ix = Indexer(cfg=SMOKE, device="cpu", merge_threads=1, merge_retries=3)
    try:
        corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
        for i in range(SMOKE.merge_fanout):
            ix.index_batch(corpus.batch(i, 32))
        ix.merge_scheduler.drain()
        rep = ix.envelope_report()
        assert rep["n_merges"] == 1 and rep["merge_retries"] == 2
        assert rep["merge_concurrency"] == 1
    finally:
        ix.close()
    assert ix.merge_scheduler is None


def _jax_sync_end_state(n_batches):
    cfg = get_arch("lucene-envelope").smoke
    corpus = JCorpus(JTINY, doc_buffer_len=cfg.doc_len)
    ix = DistributedIndexer(cfg=cfg, merge_threads=0)
    for i in range(n_batches):
        ix.index_batch(corpus.batch(i, 32))
    ix.delete([3, 40, 77])
    final = ix.finalize()
    ix.close()
    return final, ix.merger.flushed_bytes


@pytest.mark.parametrize("kw", [{"merge_threads": 2},
                                {"refresh_every": 0.01},
                                {"merge_threads": 2, "refresh_every": 0.01,
                                 "merge_io_mbps": 50.0}])
def test_end_state_matches_jax_sync_run(kw):
    """Interleaved ingest, refresh + search mid-cascade and deletes, with
    background merges and/or the daemon: after ``finalize()`` the segment
    equals the JAX package's synchronous run bit for bit."""
    n_batches = 12
    want, want_flushed = _jax_sync_end_state(n_batches)
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    ix = Indexer(cfg=SMOKE, device="cpu", **kw)
    try:
        for i in range(n_batches):
            b = corpus.batch(i, 32)
            ix.index_batch(b)
            if i % 3 == 0:
                s = ix.refresh()
                assert s.n_docs == 32 * (i + 1)
                s.search(np.unique(b[b > 0])[:3].astype(np.int32), 10)
        ix.delete([3, 40, 77])
        got = ix.finalize()
        for f in ARRAY_FIELDS + ("deletes",):
            x, y = getattr(want, f), getattr(got, f)
            if x is None or y is None:
                assert x is None and y is None, f
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert (x == y).all(), f
        assert ix.merger.flushed_bytes == want_flushed
        rep = ix.envelope_report()
        assert rep["merge_concurrency"] == kw.get("merge_threads", 0)
        if "merge_threads" in kw:
            assert ix.merger.merge_wall_s > 0
    finally:
        ix.close()


def test_merge_rate_limiter_paces_and_caps_pauses():
    lim = MergeRateLimiter(mb_per_s=1.0, max_pause_s=0.05)
    t0 = time.perf_counter()
    slept = lim.charge(30_000)           # 30ms of debt at 1 MB/s
    assert 0.02 <= slept <= 0.05
    assert time.perf_counter() - t0 >= slept
    assert lim.charge(10_000_000) == pytest.approx(0.05)  # capped
    assert lim.paused_s == pytest.approx(slept + 0.05, rel=0.3)
    assert lim.bytes_charged == 10_030_000
    assert lim.charge(10) == 0.0         # sub-threshold: no sleep


def test_merge_io_throttle_accounts_merge_bytes(tmp_path):
    """``merge_io_mbps``: background merges on a throttled ``disk``
    target pay their IO through the limiter (its bytes and pauses are
    the merge's, and the report carries the pauses); ingest keeps going
    meanwhile and the end state is the full corpus."""
    cfg = dataclasses.replace(SMOKE, codec="raw")
    corpus = SyntheticCorpus(TINY, doc_buffer_len=cfg.doc_len)
    tgt = ThrottledDirectory(FSDirectory(tmp_path / "idx"),
                             DeviceThrottle(MEDIA_PROFILES["disk"]))
    ix = Indexer(cfg=cfg, device="cpu", target="xfs", target_dir=tgt,
                 merge_threads=2, merge_io_mbps=0.05)
    try:
        for i in range(10):
            ix.index_batch(corpus.batch(i, 32))
        ix.merge_scheduler.drain()
        assert ix.merger.n_merges >= 1
        lim = ix.merger.io_limiter
        assert lim is not None and lim.bytes_charged > 0
        assert lim.paused_s > 0, "merge IO was never paced"
        rep = ix.envelope_report()
        assert rep["merge_io_paused_s"] == pytest.approx(lim.paused_s)
        assert ix.finalize().n_docs == 320
    finally:
        ix.close()


def test_refresh_with_flush_races_ingest_safely():
    cfg = dataclasses.replace(SMOKE, flush_budget_mb=1)
    corpus = SyntheticCorpus(TINY, doc_buffer_len=cfg.doc_len)
    ix = Indexer(cfg=cfg, device="cpu", merge_threads=2)
    stop = threading.Event()
    errors = []

    def refresher():
        try:
            while not stop.is_set():
                ix.refresh(flush=True)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=refresher)
    t.start()
    try:
        for i in range(16):
            ix.index_batch(corpus.batch(i, 32))
    finally:
        stop.set()
        t.join(timeout=60)
    try:
        assert not t.is_alive() and not errors, errors
        final = ix.finalize()
        assert final.n_docs == 16 * 32
        assert (np.diff(final.doc_ids) > 0).all()
    finally:
        ix.close()


def test_stress_search_thread_during_concurrent_ingest():
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    ix = Indexer(cfg=SMOKE, device="cpu", merge_threads=2)
    stop = threading.Event()
    errors, seen_docs = [], []

    def reader():
        rng = np.random.default_rng(4)
        try:
            while not stop.is_set():
                s = ix.refresh(flush=False)
                seen_docs.append(s.n_docs)
                if s.n_docs:
                    s.search(rng.integers(1, 1 << 12, size=3).astype(
                        np.int32), 5)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(10):
            ix.index_batch(corpus.batch(i, 32))
    finally:
        stop.set()
        t.join(timeout=30)
    try:
        assert not t.is_alive() and not errors, errors
        assert seen_docs == sorted(seen_docs), "doc count went backwards"
        assert ix.finalize().n_docs == 320
    finally:
        ix.close()


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


def test_refresh_daemon_ticks_folds_deletes_and_stops():
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    ix = Indexer(cfg=SMOKE, device="cpu", refresh_every=0.02)
    swapped = []
    ix.on_refresh.append(swapped.append)
    thread = ix._refresh_thread
    try:
        assert thread is not None and thread.is_alive()
        assert thread.daemon and thread.name == "nrt-refresh"
        for i in range(3):
            ix.index_batch(corpus.batch(i, 32))   # flushes every batch
        assert _wait(lambda: ix.searcher is not None
                     and ix.searcher.n_docs == 96)
        assert ix.stats.refreshes >= 1 and swapped[-1] is ix.searcher
        ix.delete([5, 33, 70])
        r0 = ix.stats.refreshes
        assert _wait(lambda: ix.stats.refreshes >= r0 + 2)
        s = ix.searcher
        assert s.n_docs == 93
        q = np.unique(corpus.batch(0, 32)[5][:8])
        q = q[q > 0][:4].astype(np.int32)
        _, ids = s.search(q, 96)
        assert not {5, 33, 70} & set(ids.tolist())
    finally:
        ix.close()
    assert not thread.is_alive() and ix._refresh_thread is None
    n = ix.stats.refreshes
    time.sleep(0.1)
    assert ix.stats.refreshes == n, "the daemon ticked after close()"


def test_refresh_daemon_error_is_raised_by_close(monkeypatch):
    ix = Indexer(cfg=SMOKE, device="cpu", refresh_every=0.01,
                 merge_threads=1)
    pool = ix.merge_scheduler.pool

    def broken(*a, **kw):
        raise RuntimeError("reader build failed")

    monkeypatch.setattr(ix.reader_cache, "refresh", broken)
    thread = ix._refresh_thread
    thread.join(timeout=10)
    assert not thread.is_alive(), "the daemon outlived its error"
    with pytest.raises(RuntimeError, match="reader build failed"):
        ix.close()
    assert ix.merge_scheduler is None and pool._shutdown
    ix.close()   # the error was surfaced once; closing again is a no-op

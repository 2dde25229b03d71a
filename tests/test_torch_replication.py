"""Port parity of the replicated, sharded fleet (``repro_torch.replication``)
against the JAX package's ``repro.replication``, on the CPU.

Each scenario of ``tests/test_replication.py`` runs twice on the same
token batches and queries: once through the JAX package, once through
the port with ``device="cpu"``. The port's fleet must equal its own union
oracle (one exhaustive searcher over the union of the shards' committed
segments) and the JAX fleet, values bit for bit and ids exactly; plans,
ledgers, repairs and routing counters must be the JAX package's. The
mesh variant of the merge refuses what is not a mesh it can split over
(its collective path is ``test_torch_mesh_procs.py``), and entry points
given no device raise where CUDA is absent. A kernel failure inside a
replica's decode propagates: it is never mistaken for a corrupt segment.

The process-per-replica test is in ``test_torch_replication_procs.py``.
The WAL group-commit, scrub and throttle tests of the JAX file have
their counterparts in ``test_torch_storage.py`` and
``test_torch_steady.py``."""
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import replication as jrep
from repro import storage as jstorage
from repro.configs.registry import get_arch as jget_arch
from repro.core.indexer import DistributedIndexer
from repro.core.searcher import ReaderCache as JReaderCache
from repro_torch import replication as trep
from repro_torch import storage as tstorage
from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.core.searcher import ReaderCache
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.distributed import Mesh
from repro_torch.storage import codec as tcodec

CFG = get_arch("lucene-envelope").smoke
J_CFG = jget_arch("lucene-envelope").smoke
CORPUS = SyntheticCorpus(TINY, doc_buffer_len=CFG.doc_len)
RANGE = 1_000_000   # range-shard width: shard i owns [i*RANGE, (i+1)*RANGE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_oracle(dirs, prune=False):
    segs = []
    for d in dirs:
        segs.extend(jstorage.open_latest(d)[1])
    return JReaderCache(prune=prune).refresh(segs)


def _port_oracle(dirs, prune=False):
    segs = []
    for d in dirs:
        segs.extend(tstorage.open_latest(d, device="cpu")[1])
    return ReaderCache(prune=prune, device="cpu").refresh(segs)


# one namespace per package: the scenarios below run on either
JAX = types.SimpleNamespace(
    name="jax", rep=jrep, RAM=jstorage.RAMDirectory,
    writer=lambda d, pub, base: DistributedIndexer(
        cfg=J_CFG, target_dir=d, publisher=pub, doc_base=base),
    syncer=lambda d, src, rid, pub: jrep.ReplicaSyncer(
        d, src, replica_id=rid, publisher=pub),
    fleet=lambda shards, **kw: jrep.FleetSearcher(shards, **kw),
    oracle=_jax_oracle)
PORT = types.SimpleNamespace(
    name="port", rep=trep, RAM=tstorage.RAMDirectory,
    writer=lambda d, pub, base: Indexer(
        cfg=CFG, target_dir=d, publisher=pub, doc_base=base, device="cpu"),
    syncer=lambda d, src, rid, pub: trep.ReplicaSyncer(
        d, src, replica_id=rid, publisher=pub, device="cpu"),
    fleet=lambda shards, **kw: trep.FleetSearcher(shards, device="cpu",
                                                  **kw),
    oracle=_port_oracle)


def _build_shard(P, si, n_batches=2, per=16, delete=False):
    """One shard writer over its own directory, publisher attached."""
    d = P.RAM()
    pub = P.rep.CommitPublisher(d)
    ix = P.writer(d, pub, si * RANGE)
    for i in range(n_batches):
        ix.index_batch(CORPUS.batch(8 * si + i, per))
    if delete:
        ix.delete(np.arange(si * RANGE + 1, si * RANGE + 5))
    ix.commit()
    return ix, pub


def _replicas(P, ix, pub, n=1, tag="s0"):
    """n synced replicas of one shard, peers cross-wired."""
    group = [P.syncer(P.RAM(), ix.target_dir, f"{tag}r{ri}", pub)
             for ri in range(n)]
    for r in group:
        assert r.sync_once() is not None
        r.peers = [p.directory for p in group if p is not r]
    return group


def _queries(batches, B, Q=3, seed=0):
    v = np.unique(np.concatenate([CORPUS.batch(b, 16).ravel()
                                  for b in batches]))
    v = v[v > 0]
    rng = np.random.default_rng(seed)
    return rng.choice(v, size=(B, Q), replace=True).astype(np.int32)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _same(got, want):
    """Values bit for bit, ids exactly (the packages' id dtypes differ)."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(_bits(gv), _bits(wv))
    np.testing.assert_array_equal(np.asarray(gi, np.int64),
                                  np.asarray(wi, np.int64))


def _rot(d, name, at=None, mask=0xFF):
    data = bytearray(d.read_file(name))
    data[len(data) // 2 if at is None else at] ^= mask
    d.write_file(name, bytes(data))


def _both(scenario, *args):
    """``scenario`` run on each package: (port's result, JAX's result)."""
    return scenario(PORT, *args), scenario(JAX, *args)


# ---------------------------------------------------------------------------
# manifest shipping
# ---------------------------------------------------------------------------

def test_plan_delta_ships_only_missing_owned_files():
    def scenario(P):
        ix, _ = _build_shard(P, 0)
        gen, meta, manifest = P.rep.latest_commit_meta(ix.target_dir)
        assert gen >= 1 and manifest
        files = P.rep.manifest_files(meta)
        assert files and all(not f.startswith("segments_") for f in files)
        cold = P.rep.plan_delta(gen, meta, set())
        assert set(cold.to_fetch) == set(files) and not cold.up_to_date
        assert P.rep.plan_delta(gen, meta, set(files)).up_to_date
        have = set(files) | {"notes.txt", "sdeadbeef.doc", "segments_0"}
        warm = P.rep.plan_delta(gen, meta, have)
        assert not warm.to_fetch
        assert "notes.txt" not in warm.to_delete
        assert "sdeadbeef.doc" in warm.to_delete
        assert "segments_0" in warm.to_delete
        assert warm.manifest not in warm.to_delete
        return [(p.gen, p.manifest, p.to_fetch, p.to_delete)
                for p in (cold, warm)], files
    port, jax_ = _both(scenario)
    assert port == jax_


def _ledger(rep):
    """A publisher report without its wall-clock lags."""
    out = {k: v for k, v in rep.items() if k != "max_replication_lag_s"}
    out["per_replica"] = {
        rid: {k: v for k, v in r.items()
              if k not in ("replication_lag_s", "max_lag_s")}
        for rid, r in rep["per_replica"].items()}
    return out


def test_publisher_ledger_tracks_lag_and_backlog():
    def scenario(P):
        ix, pub = _build_shard(P, 0)
        group = _replicas(P, ix, pub, n=2)
        rep = pub.report()
        assert rep["replicas"] == 2 and rep["replicas_current"] == 2
        assert rep["bytes_shipped_total"] > 0
        assert rep["max_replication_lag_s"] >= 0.0
        for r in rep["per_replica"].values():
            assert r["gen"] == rep["last_gen"] and not r["behind"]
        ledgers = [_ledger(rep)]
        ix.index_batch(CORPUS.batch(6, 16))
        ix.commit()
        assert all(r["behind"]
                   for r in pub.report()["per_replica"].values())
        first_bytes = group[0].bytes_fetched
        out = group[0].sync_once()
        assert out is not None and out["gen"] == pub.report()["last_gen"]
        assert out["lag_s"] >= 0.0
        delta_bytes = group[0].bytes_fetched - first_bytes
        assert 0 < delta_bytes < first_bytes    # delta, not a full re-ship
        assert group[0].sync_once() is None     # idempotent once current
        assert pub.report()["per_replica"]["s0r0"]["behind"] == 0
        ledgers.append(_ledger(pub.report()))
        return ledgers, delta_bytes, first_bytes
    port, jax_ = _both(scenario)
    assert port == jax_


def test_indexer_publisher_hook_on_commit_and_finalize():
    """``Indexer(publisher=...)`` announces every durable commit, from
    ``commit()`` and ``finalize()``, and reports the ``fleet`` section,
    as the JAX ``DistributedIndexer`` does."""
    class Recorder:
        def __init__(self, inner):
            self.inner, self.gens = inner, []

        def on_commit(self, gen, ts=None):
            self.gens.append(gen)
            self.inner.on_commit(gen, ts)

        def report(self):
            return self.inner.report()

    def scenario(P):
        d = P.RAM()
        pub = Recorder(P.rep.CommitPublisher(d))
        ix = P.writer(d, pub, 0)
        ix.index_batch(CORPUS.batch(0, 16))
        g1 = ix.commit()
        ix.index_batch(CORPUS.batch(1, 16))
        ix.finalize()
        assert pub.gens[0] == g1 and len(pub.gens) == 2
        assert pub.gens[1] == P.rep.latest_commit_meta(d)[0]
        fleet = ix.envelope_report()["fleet"]
        assert fleet == pub.report()
        ix.close()
        return pub.gens, _ledger(fleet)
    port, jax_ = _both(scenario)
    assert port == jax_


# ---------------------------------------------------------------------------
# scatter-gather exactness (the tentpole property)
# ---------------------------------------------------------------------------

def test_searcher_with_stats_and_query_max_ub_match_jax():
    """``IndexSearcher.with_stats`` and the searcher-level
    ``query_max_ub`` on the same segments: bounds bit for bit, results
    values bit for bit and ids exactly; the wrapped snapshot's generation
    is 0."""
    def scenario(P):
        shards = [_build_shard(P, si, delete=si == 1)[0] for si in range(2)]
        oracle = P.oracle([ix.target_dir for ix in shards], prune=True)
        local = P.oracle([shards[0].target_dir], prune=True)
        stats = P.rep.CollectionStats.from_searcher(oracle)
        view = local.with_stats(stats)
        assert view.generation == 0 and local.generation != 0
        assert view.n_docs == oracle.n_docs and view.avgdl == oracle.avgdl
        q = _queries([0, 1, 8, 9], B=4, seed=2)
        ub = np.asarray(view.query_max_ub(q))
        assert ub.dtype == np.float64 and ub.shape == (4,)
        v, i = view.search_batched(q, 10)
        return ub, (np.asarray(v), np.asarray(i)), stats
    (ub_p, res_p, st_p), (ub_j, res_j, st_j) = _both(scenario)
    np.testing.assert_array_equal(ub_p.view(np.int64), ub_j.view(np.int64))
    _same(res_p, res_j)
    assert (st_p.n_docs, st_p.sum_dl) == (st_j.n_docs, st_j.sum_dl)
    np.testing.assert_array_equal(st_p.df_terms, st_j.df_terms)
    np.testing.assert_array_equal(st_p.df_table, st_j.df_table)


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 3), st.booleans(), st.sampled_from([3, 10]),
       st.integers(1, 3))
def test_fleet_topk_matches_union_oracle(n_shards, delete, k, B):
    """The port's fleet (cross-shard theta sharing, union stats) equals
    its exhaustive union oracle and the JAX fleet, with and without
    tombstones."""
    def scenario(P):
        writers = [_build_shard(P, si, delete=delete)
                   for si in range(n_shards)]
        shards = [_replicas(P, ix, pub, n=1, tag=f"s{si}")
                  for si, (ix, pub) in enumerate(writers)]
        fleet = P.fleet(shards)
        oracle = P.oracle([ix.target_dir for ix, _ in writers])
        q = _queries([8 * si + i for si in range(n_shards)
                      for i in range(2)], B, seed=n_shards * 31 + k)
        got = fleet.search_batched(q, k)
        rep = fleet.report()
        assert rep["shards_visited"] + rep["shards_skipped"] == n_shards
        return got, oracle.search_batched(q, k), \
            (rep["shards_visited"], rep["shards_skipped"])
    (port, port_oracle, port_rep), (jax_, _, jax_rep) = _both(scenario)
    np.testing.assert_array_equal(_bits(port[0]), _bits(port_oracle[0]))
    _same(port, jax_)
    assert port_rep == jax_rep


def test_fleet_exact_under_mid_sync_replica_then_converges():
    """A replica one commit behind serves an exact fleet over the union
    of what the chosen replicas HOLD; after it catches up, over the
    writers' latest commits."""
    def scenario(P):
        ix0, pub0 = _build_shard(P, 0, n_batches=1)
        (r0,) = _replicas(P, ix0, pub0)
        ix0.index_batch(CORPUS.batch(1, 16))    # r0 is now one commit behind
        ix0.commit()
        ix1, pub1 = _build_shard(P, 1)
        (r1,) = _replicas(P, ix1, pub1)
        fleet = P.fleet([[r0], [r1]])
        q = _queries([0, 1, 8, 9], B=3, seed=5)
        mid = fleet.search_batched(q, 10)
        mid_oracle = P.oracle([r0.directory, r1.directory]).search_batched(
            q, 10)
        assert r0.sync_once()["gen"] == 2
        done = fleet.search_batched(q, 10)
        done_oracle = P.oracle([ix0.target_dir,
                                ix1.target_dir]).search_batched(q, 10)
        return mid, mid_oracle, done, done_oracle
    port, jax_ = _both(scenario)
    np.testing.assert_array_equal(_bits(port[0][0]), _bits(port[1][0]))
    np.testing.assert_array_equal(_bits(port[2][0]), _bits(port[3][0]))
    _same(port[0], jax_[0])
    _same(port[2], jax_[2])


def test_fleet_matches_force_merged_union_after_finalize():
    def scenario(P):
        writers = [_build_shard(P, si, delete=True) for si in range(2)]
        shards = [_replicas(P, ix, pub, tag=f"s{si}")
                  for si, (ix, pub) in enumerate(writers)]
        for ix, _ in writers:
            assert not ix.finalize().has_deletes
        for group in shards:
            assert group[0].sync_once() is not None
        fleet = P.fleet(shards)
        oracle = P.oracle([ix.target_dir for ix, _ in writers])
        assert len(oracle.readers) == 2          # one segment per shard
        q = _queries([0, 1, 8, 9], B=4, seed=11)
        return fleet.search_batched(q, 10), oracle.search_batched(q, 10)
    port, jax_ = _both(scenario)
    np.testing.assert_array_equal(_bits(port[0][0]), _bits(port[1][0]))
    _same(port[0], jax_[0])


def test_shard_spec_assignment():
    ids = np.array([0, RANGE - 1, RANGE, 2 * RANGE, 5 * RANGE])
    for policy, n, size, x in (("range", 3, RANGE, ids),
                               ("hash", 4, 0, np.arange(1000))):
        spec = trep.ShardSpec(n_shards=n, policy=policy, range_size=size)
        want = jrep.ShardSpec(n_shards=n, policy=policy,
                              range_size=size).shard_of(x)
        np.testing.assert_array_equal(spec.shard_of(x), want)
    rs = trep.ShardSpec(n_shards=3, policy="range", range_size=RANGE)
    np.testing.assert_array_equal(rs.shard_of(ids), [0, 0, 1, 2, 2])
    s = trep.ShardSpec(n_shards=4, policy="hash").shard_of(np.arange(1000))
    assert s.min() >= 0 and s.max() < 4
    assert all((s == i).sum() > 0 for i in range(4))    # no empty shard


@pytest.mark.parametrize("ties", [False, True])
def test_merge_topk_sharded_host_path(ties):
    """The host merge against the JAX package's on the same partials:
    values bit for bit and ids exactly, ties included (shard-major, the
    lower index first); a short pool pads with (0, -1)."""
    rng = np.random.default_rng(3)
    S, B, k = 4, 3, 8
    vals = (rng.integers(0, 4, (S, B, k)) if ties
            else rng.permutation(S * B * k).reshape(S, B, k)
            ).astype(np.float32)
    ids = np.arange(S * B * k, dtype=np.int32).reshape(S, B, k)
    mv, mi = trep.merge_topk_sharded(vals, ids, k)
    assert mv.dtype == torch.float32 and mi.dtype == torch.int64
    _same((mv, mi), jrep.merge_topk_sharded(vals, ids, k))
    for b in range(B):
        top = np.sort(vals[:, b, :].ravel())[::-1][:k]
        np.testing.assert_array_equal(mv[b].numpy(), top)
    pv, pi = trep.merge_topk_sharded(vals[:1, :, :2], ids[:1, :, :2], k)
    assert tuple(pv.shape) == (B, k) and bool((pi[:, 2:] == -1).all())
    assert bool((pv[:, 2:] == 0).all())
    _same((pv, pi), jrep.merge_topk_sharded(vals[:1, :, :2],
                                            ids[:1, :, :2], k))


def test_mesh_variants_raise_naming_the_multi_device_item():
    """The mesh merge is ported (its collective path over 4 processes is
    ``tests/test_torch_mesh_procs.py``); what is not a
    ``repro_torch.distributed.Mesh``, an axis it lacks, or shards that do
    not split over the axis raise a clear error."""
    vals = np.zeros((2, 1, 3), np.float32)
    ids = np.zeros((2, 1, 3), np.int32)
    with pytest.raises(TypeError, match="distributed.Mesh, got object"):
        trep.merge_topk_sharded(vals, ids, 3, mesh=object())
    with pytest.raises(ValueError, match="no axis 'shard'"):
        trep.merge_topk_sharded(vals, ids, 3, mesh=Mesh({"model": 2}, 0))
    with pytest.raises(ValueError, match="2 shards do not split"):
        trep.merge_topk_sharded(vals, ids, 3, mesh=Mesh({"shard": 4}, 0))
    ix, pub = _build_shard(PORT, 0, n_batches=1)
    group = _replicas(PORT, ix, pub)
    with pytest.raises(TypeError, match="distributed.Mesh, got object"):
        trep.FleetSearcher([group], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no axis 'shard'"):
        trep.FleetSearcher([group], mesh=Mesh({"data": 1}, 0), device="cpu")
    fleet = trep.FleetSearcher([group], mesh=Mesh({"shard": 1}, 0),
                               mesh_axis="shard", device="cpu")
    assert fleet.mesh_axis == "shard"


def test_entry_points_need_cuda_or_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    d = tstorage.RAMDirectory()
    for make in (lambda: trep.ReplicaSyncer(tstorage.RAMDirectory(), d),
                 lambda: trep.RemoteReplica("r", tmp_path / "r", tmp_path),
                 lambda: trep.FleetSearcher([[object()]])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    cpu = trep.ReplicaSyncer(tstorage.RAMDirectory(), d, device="cpu")
    assert cpu.device == torch.device("cpu") and cpu.sync_once() is None
    assert trep.FleetSearcher([[cpu]], device="cpu").device == cpu.device
    # a replica on another device than its fleet's
    elsewhere = types.SimpleNamespace(replica_id="x", device="meta")
    with pytest.raises(ValueError, match="replica x serves on meta"):
        trep.FleetSearcher([[elsewhere]], device="cpu")


# ---------------------------------------------------------------------------
# quarantine-driven failover
# ---------------------------------------------------------------------------

def test_quarantine_sheds_traffic_with_zero_failed_queries():
    def scenario(P):
        ix0, pub0 = _build_shard(P, 0)
        ix1, pub1 = _build_shard(P, 1)
        g0 = _replicas(P, ix0, pub0, n=2)
        fleet = P.fleet([g0, _replicas(P, ix1, pub1, tag="s1")])
        oracle = P.oracle([ix0.target_dir, ix1.target_dir])
        bad = g0[0]
        seg_file = next(n for n in bad.directory.list_files()
                        if n.endswith(".pst"))
        bad.quarantine(seg_file)
        assert not bad.healthy and bad.missing_docs > 0
        assert not fleet.degraded      # the healthy peer covers the shard
        served, failed = [], 0
        for trial in range(8):
            q = _queries([0, 1, 8, 9], B=2, seed=100 + trial)
            got = fleet.search_batched(q, 10)
            want = oracle.search_batched(q, 10)
            failed += not np.array_equal(_bits(got[0]), _bits(want[0]))
            served.append(got)
        rep = fleet.report()
        assert failed == 0
        assert rep["failovers"] >= 1 and rep["degraded_served"] == 0
        assert rep["served"].get("s0r0", 0) == 0   # shed all to s0r1
        return served, (bad.missing_docs, rep["failovers"], rep["served"])
    (port, port_rep), (jax_, jax_rep) = _both(scenario)
    for got, want in zip(port, jax_):
        _same(got, want)
    assert port_rep == jax_rep


def test_repair_refetches_corrupt_segment_from_peer():
    def scenario(P):
        ix, pub = _build_shard(P, 0)
        bad, peer = g = _replicas(P, ix, pub, n=2)
        seg_file = next(n for n in bad.directory.list_files()
                        if n.endswith(".doc"))
        _rot(bad.directory, seg_file)            # bit rot on bad's media
        base = bad.quarantine(seg_file)
        assert not bad.healthy
        out = bad.repair(base)
        assert out["files"] >= 1 and out["bytes"] > 0
        assert bad.healthy and bad.missing_docs == 0
        assert bad.refetches >= 1
        q = _queries([0, 1], B=2, seed=7)
        got = P.fleet([g]).search_batched(q, 10)
        want = P.oracle([ix.target_dir]).search_batched(q, 10)
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        return out, got
    (out_p, got_p), (out_j, got_j) = _both(scenario)
    assert out_p == out_j
    _same(got_p, got_j)


def test_anti_entropy_detects_and_heals_bit_rot():
    def scenario(P):
        ix, pub = _build_shard(P, 0)
        bad = _replicas(P, ix, pub, n=2)[0]
        victim = next(n for n in bad.directory.list_files()
                      if n.endswith(".dict"))
        _rot(bad.directory, victim, at=-3, mask=0x40)
        gone = next(n for n in bad.directory.list_files()
                    if n.endswith(".pos"))
        bad.directory.delete_file(gone)        # a vanished file, too
        out = bad.anti_entropy()
        assert victim in out["corrupt"] and gone in out["corrupt"]
        assert out["repaired"] and bad.healthy
        assert bad.directory.file_exists(gone)
        rep = bad.report()
        assert rep["repairs"] >= 1 and rep["refetch_bytes"] > 0
        return out, {k: rep[k] for k in ("repairs", "refetches",
                                         "refetch_bytes", "gc_deleted")}
    port, jax_ = _both(scenario)
    assert port == jax_


def test_syncer_decode_oserror_propagates(monkeypatch):
    """``ctypes`` raises ``OSError`` when a kernel library fails to load.
    A replica's decode unpacks outside its ``try``, so that error leaves
    ``sync_once`` (and ends the background poller, whose ``close()``
    raises it) instead of quarantining the segment; a torn local copy
    still quarantines."""
    ix, pub = _build_shard(PORT, 0)
    good = PORT.syncer(PORT.RAM(), ix.target_dir, "s0r1", pub)
    assert good.sync_once() is not None

    def broken(*a, **k):
        raise OSError("libpostings_pack.so: cannot open shared object file")

    with monkeypatch.context() as m:
        m.setattr(tcodec.pack_ops, "unpack", broken)
        r = PORT.syncer(PORT.RAM(), ix.target_dir, "s0r0", pub)
        with pytest.raises(OSError, match="shared object"):
            r.sync_once()
        assert r.quarantined == {} and r.gen == 0
        follower = PORT.syncer(PORT.RAM(), ix.target_dir, "s0r2", pub)
        follower.start(0.01)
        deadline = time.monotonic() + 60
        while follower._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(OSError, match="shared object"):
            follower.close()
        assert follower.quarantined == {}
    # a torn local copy, by contrast, is corruption: quarantined
    victim = next(n for n in good.directory.list_files()
                  if n.endswith(".pst"))
    _rot(good.directory, victim)
    good._cores.clear()
    good._live.clear()
    good._install(good.gen, good.meta)
    assert list(good.quarantined) == [victim.split(".")[0]]
    assert not good.healthy


# ---------------------------------------------------------------------------
# latency-aware replica routing
# ---------------------------------------------------------------------------

class _SlowReplica:
    """Duck-typed replica wrapper: same snapshot, slower serves."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def search_batched(self, q, k, theta0=None):
        time.sleep(self._delay_s)
        return self._inner.search_batched(q, k, theta0=theta0)


def test_slow_replica_sheds_traffic_with_zero_failed_queries():
    """EWMA routing: a replica that is merely SLOW sheds most traffic to
    its faster peer after the round-robin warmup, every answer equal to
    the union oracle and to the JAX package's on the same queries. A
    batch takes the port ~20 ms on the CPU (the JAX package's jitted
    search ~1 ms), so the slow replica's added delay is 0.2 s: far above
    what a loaded host adds to the fast one's serves."""
    ix, pub = _build_shard(PORT, 0)
    g = _replicas(PORT, ix, pub, n=2)
    slow = _SlowReplica(g[0], 0.2)
    fleet = trep.FleetSearcher([[slow, g[1]]], probe_every=8, device="cpu")
    oracle = PORT.oracle([ix.target_dir])
    jix, _ = _build_shard(JAX, 0)
    q = _queries([0, 1], B=2, seed=3)
    want = JAX.oracle([jix.target_dir]).search_batched(q, 10)
    trials = 24
    for _ in range(trials):
        got = fleet.search_batched(q, 10)
        np.testing.assert_array_equal(
            _bits(got[0]), _bits(oracle.search_batched(q, 10)[0]))
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    rep = fleet.report()
    assert rep["lat_routed"] > 0
    served = rep["served"]
    assert served["s0r0"] + served["s0r1"] == trials
    assert served["s0r0"] <= 4          # rr warmup + probes only
    assert served["s0r1"] >= trials - 4
    assert rep["latency_ms"]["s0r0"] > rep["latency_ms"]["s0r1"]
    assert rep["failovers"] == 0 and rep["degraded_served"] == 0


def test_latency_aware_off_restores_round_robin():
    def scenario(P):
        ix, pub = _build_shard(P, 0)
        g = _replicas(P, ix, pub, n=2)
        fleet = P.fleet([[_SlowReplica(g[0], 0.005), g[1]]],
                        latency_aware=False)
        q = _queries([0, 1], B=2, seed=4)
        got = [fleet.search_batched(q, 10) for _ in range(8)]
        rep = fleet.report()
        assert rep["lat_routed"] == 0
        assert rep["served"]["s0r0"] == rep["served"]["s0r1"] == 4
        return got, rep["served"]
    (port, port_served), (jax_, jax_served) = _both(scenario)
    for got, want in zip(port, jax_):
        _same(got, want)
    assert port_served == jax_served

"""The port's process-per-replica fleet on the CPU: a writer in this
process, two ``RemoteReplica`` searcher processes (``device="cpu"``)
pulling its commits over real ``FSDirectory`` paths. The fleet over them
equals the port's union oracle and the JAX package's exhaustive searcher
over the same committed files, values bit for bit and ids exactly;
bit rot on one replica's disk is found by anti-entropy and healed from
the peer process. Every call to a child waits a bounded time, and a dead
child fails the call instead of hanging it.

The counterpart of ``tests/test_replication.py::
test_remote_replica_processes_converge_and_heal``, in a file of its own
so that one test worker owns the child processes."""
import time

import numpy as np
import pytest
import torch

from repro import storage as jstorage
from repro.core.searcher import ReaderCache as JReaderCache
from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.core.searcher import ReaderCache
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.replication import (CommitPublisher, FleetSearcher,
                                     RemoteReplica, RemoteReplicaError)
from repro_torch.storage import FSDirectory, open_latest

CFG = get_arch("lucene-envelope").smoke
CORPUS = SyntheticCorpus(TINY, doc_buffer_len=CFG.doc_len)
TIMEOUT_S = 120.0   # each call to a child; a child that misses it is killed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _queries(batches, B, Q=3, seed=0):
    v = np.unique(np.concatenate([CORPUS.batch(b, 16).ravel()
                                  for b in batches]))
    v = v[v > 0]
    rng = np.random.default_rng(seed)
    return rng.choice(v, size=(B, Q), replace=True).astype(np.int32)


def _oracles(path, q, k=10):
    """The port's and the JAX package's exhaustive search over the
    writer's newest commit."""
    port = ReaderCache(prune=False, device="cpu").refresh(
        open_latest(FSDirectory(str(path)), device="cpu")[1])
    jax_ = JReaderCache(prune=False).refresh(
        jstorage.open_latest(jstorage.FSDirectory(str(path)))[1])
    return port.search_batched(q, k), jax_.search_batched(q, k)


def _same(got, want):
    np.testing.assert_array_equal(
        np.asarray(got[0], np.float32).view(np.int32),
        np.asarray(want[0], np.float32).view(np.int32))
    np.testing.assert_array_equal(np.asarray(got[1], np.int64),
                                  np.asarray(want[1], np.int64))


def test_remote_replica_processes_converge_and_heal(tmp_path):
    src = FSDirectory(str(tmp_path / "writer"))
    pub = CommitPublisher(src)
    ix = Indexer(cfg=CFG, target_dir=src, publisher=pub, device="cpu")
    for i in range(2):
        ix.index_batch(CORPUS.batch(i, 16))
    ix.commit()
    paths = [tmp_path / "r0", tmp_path / "r1"]
    reps = [RemoteReplica(f"r{i}", paths[i], tmp_path / "writer",
                          peer_paths=[paths[1 - i]], device="cpu",
                          timeout_s=TIMEOUT_S).start()
            for i in range(2)]
    try:
        for r in reps:
            out = r.sync_once()
            assert out["gen"] == 1 and r.gen == 1 and r.healthy
        # convergence tracks EVERY commit
        ix.index_batch(CORPUS.batch(2, 16))
        ix.commit()
        for r in reps:
            assert r.sync_once()["gen"] == 2
        fleet = FleetSearcher([reps], device="cpu")
        q = _queries([0, 1, 2], B=2, seed=3)
        got = fleet.search_batched(q, 10)
        port_oracle, jax_oracle = _oracles(tmp_path / "writer", q)
        _same(got, port_oracle)
        _same(got, jax_oracle)
        # bit rot on r0's disk: scrub detects, the PEER process heals it
        d0 = FSDirectory(str(paths[0]))
        victim = next(n for n in d0.list_files() if n.endswith(".doc"))
        data = bytearray(d0.read_file(victim))
        data[len(data) // 2] ^= 0xFF
        d0.write_file(victim, bytes(data))
        out = reps[0].anti_entropy()
        assert victim in out["corrupt"] and reps[0].healthy
        _same(fleet.search_batched(q, 10), jax_oracle)
        rep = reps[0].report()
        assert rep["repairs"] >= 1
        # on the CPU no kernel launches, in any process
        assert set(rep["launches"]) >= {"pack", "unpack", "bm25_blocks"}
        assert not any(rep["launches"].values())
        # a command that raises in the child raises in the parent
        with pytest.raises(RemoteReplicaError, match="unknown command"):
            reps[1]._call("no-such-command")
        assert reps[1].refresh_state()["gen"] == 2
    finally:
        for r in reps:
            r.close()
        ix.close()
    assert all(r._proc is None for r in reps)


def test_dead_replica_process_fails_the_call(tmp_path):
    """A child that dies fails the next call at once (no hang); the proxy
    is then closed, and closing it again is a no-op."""
    src = FSDirectory(str(tmp_path / "writer"))
    ix = Indexer(cfg=CFG, target_dir=src, device="cpu")
    ix.index_batch(CORPUS.batch(0, 16))
    ix.commit()
    r = RemoteReplica("r0", tmp_path / "r0", tmp_path / "writer",
                      device="cpu", timeout_s=TIMEOUT_S).start()
    try:
        assert r.sync_once()["gen"] == 1
        proc = r._proc
        proc.kill()
        proc.join(timeout=30)
        assert not proc.is_alive()
        t0 = time.monotonic()
        with pytest.raises(RemoteReplicaError, match="gone"):
            r.refresh_state()
        assert time.monotonic() - t0 < TIMEOUT_S
        with pytest.raises(RemoteReplicaError, match="not running"):
            r.sync_once()
    finally:
        r.close()
        ix.close()

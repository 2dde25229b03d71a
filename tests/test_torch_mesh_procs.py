"""The port's collective path on the CPU: a world of 4 processes over
gloo (``distributed.spawn_world``, ``file://`` rendezvous in a temporary
directory, one thread each, every collective bounded by the process
group's 60 s timeout and the world by ``TIMEOUT_S``) runs

  * ``make_index_step`` on a (2, 2) ``("data", "model")`` mesh, raw and
    packed2: every rank's outputs equal ``index_step_loopback`` (every
    rank in one process, the all-to-all done by hand) bit for bit;
  * ``route_entries`` on that mesh's ``model`` axis at a capacity that
    drops entries: equal to its send and receive stages run by hand;
  * ``merge_topk_sharded`` on a (4,) ``shard`` mesh over the inputs of
    ``tests/test_replication.py::test_merge_topk_sharded_mesh_matches_host``:
    every rank equals the port's host path and the JAX package's mesh
    merge (a JAX subprocess with 4 virtual host devices, run while the
    world runs);
  * ``FleetSearcher(mesh=, mesh_axis="model")`` over two SMOKE range
    shards: every rank equals the same fleet's host merge.

One world per module, in a file of its own so that one test worker owns
the child processes."""
import dataclasses
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.lucene_envelope import SMOKE
from repro_torch.core import shuffle as tshuffle
from repro_torch.core.indexer import (Indexer, index_step_loopback,
                                      make_index_step)
from repro_torch.core.invert import InvertedRun
from repro_torch.core.shuffle import route_entries
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.distributed import make_debug_mesh, make_mesh, spawn_world
from repro_torch.distributed.mesh import PG_TIMEOUT_S
from repro_torch.replication import (CommitPublisher, FleetSearcher,
                                     ReplicaSyncer, merge_topk_sharded)
from repro_torch.storage import RAMDirectory

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300.0
PAYLOADS = ("raw", "packed2")
RANGE = 1_000_000      # range-shard width: shard i owns [i*RANGE, ...)
FIELDS = ("packed_docs", "bw_docs", "packed_pos", "bw_pos")
ROUTE_CAP = 40         # entries a destination: the skewed input overflows

JAX_MERGE = """
import jax, numpy as np, sys
from repro.replication.fleet import merge_topk_sharded
rng = np.random.default_rng(0)
S, B, k = 4, 3, 8
vals = rng.permutation(S*B*k).reshape(S, B, k).astype(np.float32)
ids = np.arange(S*B*k, dtype=np.int32).reshape(S, B, k)
mesh = jax.make_mesh((4,), ("shard",))
mv, mi = merge_topk_sharded(vals, ids, k, mesh=mesh)
np.savez(sys.argv[1], vals=np.asarray(mv), ids=np.asarray(mi))
print("JAX-MESH-MERGE-OK")
"""


def _step_blocks():
    """One SMOKE block of tokens a rank, ragged docs, from a seed."""
    rng = np.random.default_rng(5)
    D, L = SMOKE.docs_per_shard, SMOKE.doc_len
    toks = rng.integers(1, 1 << SMOKE.vocab_bits,
                        size=(WORLD * D, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=WORLD * D)
    toks[np.arange(L)[None, :] >= lens[:, None]] = 0
    return [toks[r * D:(r + 1) * D] for r in range(WORLD)]


def _route_inputs(rank: int):
    """Sorted (term, doc, pos) entries of one rank's 8 x 16 block, two
    thirds of them on even terms: destination 0 overflows ROUTE_CAP."""
    rng = np.random.default_rng(100 + rank)
    toks = rng.integers(1, 50, size=(8, 16)).astype(np.int32)
    toks[rng.random(toks.shape) < 0.66] = 2 * rng.integers(1, 6)
    term = torch.from_numpy(toks).reshape(-1)
    doc = (torch.arange(8, dtype=torch.int32)[:, None] + rank * 8).expand(
        8, 16).reshape(-1)
    pos = torch.arange(16, dtype=torch.int32).expand(8, 16).reshape(-1)
    order = torch.sort(term, stable=True).indices
    return term[order], doc[order], pos[order]


def _merge_inputs():
    """``tests/test_replication.py``'s mesh-merge inputs."""
    rng = np.random.default_rng(0)
    S, B, k = 4, 3, 8
    vals = rng.permutation(S * B * k).reshape(S, B, k).astype(np.float32)
    ids = np.arange(S * B * k, dtype=np.int32).reshape(S, B, k)
    return vals, ids, k


def _fleet_queries():
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    v = np.unique(np.concatenate([corpus.batch(b, 16).ravel()
                                  for b in (0, 1, 8, 9)]))
    v = v[v > 0]
    rng = np.random.default_rng(1)
    return [rng.choice(v, size=(4, 3)).astype(np.int32) for _ in range(3)]


def _as_numpy(out: dict) -> dict:
    got = {f"run.{f}": getattr(out["run"], f).numpy()
           for f in InvertedRun._fields}
    got.update({f"stats.{f}": t.numpy()
                for f, t in out["stats"]._asdict().items()})
    got.update({f: out[f].numpy() for f in FIELDS})
    got["packed_bytes"] = out["packed_bytes"]
    return got


def _rank_main(rank: int, world: int) -> dict:
    """One rank of the world: the step on (2, 2), the merge on (4,), the
    fleet's merge over the (2, 2) mesh's ``model`` axis."""
    torch.set_num_threads(1)
    mesh22 = make_debug_mesh(2, 2)
    mesh4 = make_mesh({"shard": WORLD})
    res = {"coords": mesh22.coords}
    block = _step_blocks()[rank]
    for payload in PAYLOADS:
        cfg = dataclasses.replace(SMOKE, shuffle_payload=payload)
        step = make_index_step(cfg, mesh22, SMOKE.doc_len, device="cpu")
        res[payload] = _as_numpy(step(block))
    res["route"] = {}
    for payload in PAYLOADS:
        (rt, rd, rp), st = route_entries(
            *_route_inputs(rank), mesh=mesh22, axis_name="model",
            capacity=ROUTE_CAP, payload=payload, doc_base=rank * 8,
            docs_per_dev=8)
        res["route"][payload] = [t.numpy() for t in (rt, rd, rp, *st)]
    vals, ids, k = _merge_inputs()
    v, i = merge_topk_sharded(vals, ids, k, mesh=mesh4)
    res["merge"] = (v.numpy(), i.numpy())
    # two SMOKE range shards, built alike on every rank
    corpus = SyntheticCorpus(TINY, doc_buffer_len=SMOKE.doc_len)
    groups, writers = [], []
    for si in range(2):
        d = RAMDirectory()
        pub = CommitPublisher(d)
        ix = Indexer(cfg=SMOKE, target_dir=d, publisher=pub,
                     doc_base=si * RANGE, device="cpu")
        for b in range(2):
            ix.index_batch(corpus.batch(8 * si + b, 16))
        ix.commit()
        r = ReplicaSyncer(RAMDirectory(), d, replica_id=f"s{si}r0",
                          publisher=pub, device="cpu")
        assert r.sync_once() is not None
        groups.append([r])
        writers.append(ix)
    on_mesh = FleetSearcher(groups, mesh=mesh22, mesh_axis="model",
                            device="cpu")
    host = FleetSearcher(groups, device="cpu")
    res["fleet"] = []
    for q in _fleet_queries():
        mv, mi = on_mesh.search_batched(q, 10)
        hv, hi = host.search_batched(q, 10)
        res["fleet"].append((mv.numpy(), mi.numpy(), hv.numpy(), hi.numpy()))
    for ix in writers:
        ix.close()
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, and the JAX mesh merge run beside them."""
    tmp = tmp_path_factory.mktemp("mesh_world")
    env_code = ("import os\nos.environ['XLA_FLAGS'] = "
                "'--xla_force_host_platform_device_count=4'\n")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", env_code + textwrap.dedent(JAX_MERGE),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu"})
    try:
        ranks = spawn_world(_rank_main, WORLD, tmp / "world",
                            backend="gloo", timeout_s=TIMEOUT_S)
        out, err = jax_proc.communicate(timeout=TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err[-3000:]
    assert "JAX-MESH-MERGE-OK" in out
    with np.load(tmp / "jax.npz") as z:
        return ranks, dict(z)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_index_step_over_gloo_equals_the_loopback(world, payload):
    ranks, _ = world
    cfg = dataclasses.replace(SMOKE, shuffle_payload=payload)
    want = index_step_loopback(cfg, {"data": 2, "model": 2},
                               _step_blocks(), SMOKE.doc_len)
    for rank, (res, ref) in enumerate(zip(ranks, want)):
        ref = _as_numpy(ref)
        got = res[payload]
        assert set(got) == set(ref)
        for key, a in ref.items():
            np.testing.assert_array_equal(got[key], a,
                                          err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("payload", PAYLOADS)
def test_route_entries_over_gloo_drops_as_the_loopback(world, payload):
    """``route_entries`` at a capacity that drops entries, on the (2, 2)
    mesh's ``model`` axis: every rank receives, keeps and counts what the
    send and receive stages give with the rows moved by hand."""
    ranks, _ = world
    sends = [tshuffle.route_send(*_route_inputs(r), n_dest=2,
                                 capacity=ROUTE_CAP, payload=payload,
                                 doc_base=r * 8) for r in range(WORLD)]
    dropped = 0
    for r, res in enumerate(ranks):
        m, line = r % 2, [r - r % 2, r - r % 2 + 1]
        bufs, sent, drop = sends[r]
        received = tuple(torch.stack([sends[src][0][i][m] for src in line])
                         for i in range(len(bufs)))
        out, recv = tshuffle.route_receive(
            received, payload=payload, axis_index=m, doc_base=r * 8,
            docs_per_dev=8)
        want = [t.numpy() for t in (*out, sent, drop, recv)]
        for got, w in zip(res["route"][payload], want):
            np.testing.assert_array_equal(got, w, err_msg=f"rank {r}")
        dropped += int(drop)
    assert dropped > 0


def test_index_step_over_gloo_conserves_and_owns(world):
    """Across the world: sent == recv + dropped, none dropped, every
    valid token sent; each rank's terms are its model index mod 2; and
    packed2 equals raw on every rank."""
    ranks, _ = world
    blocks = _step_blocks()
    for payload in PAYLOADS:
        st = {f: sum(int(r[payload][f"stats.{f}"]) for r in ranks)
              for f in ("sent", "recv", "dropped")}
        assert st["sent"] == st["recv"] + st["dropped"]
        assert st["dropped"] == 0
        assert st["sent"] == sum(int((b > 0).sum()) for b in blocks)
    for res in ranks:
        m = res["coords"]["model"]
        p2 = res["packed2"]
        terms = p2["run.terms_unique"][:int(p2["run.n_terms"])]
        assert len(terms) and (terms % 2 == m).all()
        for key, a in res["raw"].items():
            np.testing.assert_array_equal(p2[key], a, err_msg=key)


def test_merge_topk_over_gloo_equals_host_and_jax_mesh(world):
    ranks, jax_ = world
    vals, ids, k = _merge_inputs()
    hv, hi = merge_topk_sharded(vals, ids, k)
    np.testing.assert_array_equal(hv.numpy(), jax_["vals"])
    np.testing.assert_array_equal(hi.numpy(), jax_["ids"])
    for res in ranks:
        mv, mi = res["merge"]
        np.testing.assert_array_equal(mv.view(np.int32),
                                      jax_["vals"].view(np.int32))
        np.testing.assert_array_equal(mi, jax_["ids"])


def test_fleet_searcher_on_a_mesh_equals_its_host_merge(world):
    ranks, _ = world
    first = ranks[0]["fleet"]
    assert len(first) == 3
    for res in ranks:
        for (mv, mi, hv, hi), (v0, i0, _, _) in zip(res["fleet"], first):
            np.testing.assert_array_equal(mv.view(np.int32),
                                          hv.view(np.int32))
            np.testing.assert_array_equal(mi, hi)
            np.testing.assert_array_equal(mv.view(np.int32),
                                          v0.view(np.int32))
            np.testing.assert_array_equal(mi, i0)
            assert (mi >= 0).any()


def test_a_failing_rank_fails_the_world(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a barrier: the world
    fails with rank 1's traceback as soon as rank 1 is gone, and rank 0
    is killed, not waited on for the process group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 exited 1.*rank 1 "
                                           "fails"):
        spawn_world(_fail_on_rank_one, 2, tmp_path, timeout_s=TIMEOUT_S)
    assert time.monotonic() - t0 < PG_TIMEOUT_S


def _fail_on_rank_one(rank: int, world: int):
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
    return rank

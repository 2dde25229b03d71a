"""Serve a replicated, sharded fleet as real OS processes.

One writer process per shard (this process) keeps indexing and
committing; N searcher REPLICA processes per shard each pull every
commit into their own directory over the manifest-shipping protocol and
serve it; a ``FleetSearcher`` in the front-end scatter-gathers global
top-k across the shards. The only channel between writer and searchers
is the filesystem the manifests ship over — queries and control ride a
command pipe, index data never does (the writer/searcher media
isolation the paper's envelope argues for, made literal).

The demo then breaks a replica on purpose: bit rot lands on one
searcher's disk, anti-entropy detects it, the peer replica heals it,
and the fleet never serves a wrong result — every answer is asserted
bit-identical on scores to a single exhaustive searcher over the union
of all shards.

On the PyTorch/CUDA port: each replica process serves on the card
(its own CUDA context; decodes through the unpack kernel, reader builds
through pack, scoring through bm25_blocks / midgrid), or on the CPU with
``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_fleet.py               # CUDA
    PYTHONPATH=src python examples/torch_serve_fleet.py --device cpu
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.core.searcher import ReaderCache
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.replication import (CommitPublisher, FleetSearcher,
                                     RemoteReplica)
from repro_torch.storage import FSDirectory, open_latest

N_SHARDS, N_REPLICAS, RANGE = 2, 2, 1_000_000
cfg = get_arch("lucene-envelope").smoke
corpus = SyntheticCorpus(TINY, doc_buffer_len=cfg.doc_len)


def union_oracle(writer_dirs, device):
    segs = []
    for d in writer_dirs:
        segs.extend(open_latest(d, device=device)[1])
    return ReaderCache(prune=False, device=device).refresh(segs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="serve_fleet_") as root:
        root = Path(root)

        # ---- writers: one index shard each, publisher tracks the fleet ----
        writers, pubs = [], []
        for si in range(N_SHARDS):
            d = FSDirectory(root / f"shard{si}" / "writer")
            pub = CommitPublisher(d)
            ix = Indexer(cfg=cfg, target_dir=d, publisher=pub,
                         doc_base=si * RANGE, device=args.device)
            for i in range(2):
                ix.index_batch(corpus.batch(8 * si + i, 32))
            ix.commit()
            writers.append(ix)
            pubs.append(pub)
        dev = writers[0].device

        # ---- searcher replicas: separate processes, own directories ----
        # the replicas live in child processes, so the front-end relays
        # their sync acks back into the writers' publisher ledgers
        def sync_and_ack(si, r):
            out = r.sync_once()
            if out is not None:
                pubs[si].ack(r.replica_id, out["gen"], out["lag_s"],
                             out["bytes"], files_shipped=out["files"])
            return out

        shards = []
        for si in range(N_SHARDS):
            paths = [root / f"shard{si}" / f"replica{ri}"
                     for ri in range(N_REPLICAS)]
            group = [RemoteReplica(f"s{si}r{ri}", paths[ri],
                                   root / f"shard{si}" / "writer",
                                   peer_paths=[p for j, p in enumerate(paths)
                                               if j != ri],
                                   device=dev).start()
                     for ri in range(N_REPLICAS)]
            for r in group:
                pubs[si].register(r.replica_id)
            shards.append(group)
        for si, group in enumerate(shards):
            for r in group:
                out = sync_and_ack(si, r)
                print(f"  {r.replica_id}: synced gen={out['gen']} "
                      f"files={out['files']} bytes={out['bytes']} "
                      f"lag={out['lag_s']*1000:.0f}ms")
        print(f"fleet up: {N_SHARDS} shards x {N_REPLICAS} replica processes")

        fleet = FleetSearcher(shards, device=dev)
        oracle = union_oracle([ix.target_dir for ix in writers], dev)
        vocab = np.unique(np.concatenate(
            [corpus.batch(8 * si + i, 32).ravel()
             for si in range(N_SHARDS) for i in range(2)]))
        vocab = vocab[vocab > 0]
        rng = np.random.default_rng(0)

        def serve_and_check(n=6, k=10):
            t0, exact = time.time(), 0
            for _ in range(n):
                q = rng.choice(vocab, size=(4, 3)).astype(np.int32)
                fv, _ = fleet.search_batched(q, k)
                ov, _ = oracle.search_batched(q, k)
                exact += int(torch.equal(fv, ov))
            dt = time.time() - t0
            assert exact == n, f"only {exact}/{n} batches exact"
            return n * 4 / dt

        qps = serve_and_check()
        print(f"scatter-gather: {qps:.0f} qps, every batch bit-identical "
              f"to the union oracle")

        # ---- NRT convergence: every new commit reaches every replica ----
        for step in range(2):
            for si, ix in enumerate(writers):
                ix.index_batch(corpus.batch(8 * si + 4 + step, 32))
                if step == 0:
                    ix.delete(np.arange(si * RANGE + 5, si * RANGE + 9))
                ix.commit()
            lags = []
            for si, group in enumerate(shards):
                for r in group:
                    lags.append((r.replica_id,
                                 sync_and_ack(si, r)["lag_s"]))
            oracle = union_oracle([ix.target_dir for ix in writers], dev)
            qps = serve_and_check()
            print(f"commit {step + 2}: replicas converged "
                  f"(lag {', '.join(f'{rid}={s*1000:.0f}ms' for rid, s in lags)}), "
                  f"{qps:.0f} qps, still exact")
        for pub in pubs:
            rep = pub.report()
            assert rep["replicas_current"] == N_REPLICAS
        print(f"publisher ledger: all replicas current, "
              f"{sum(p.report()['bytes_shipped_total'] for p in pubs)} bytes "
              f"shipped total")

        # ---- failover: bit rot on one replica's disk, peer heals it ----
        bad = shards[0][0]
        d0 = FSDirectory(root / "shard0" / "replica0")
        victim = next(n for n in d0.list_files() if n.endswith(".pst"))
        blob = bytearray(d0.read_file(victim))
        blob[len(blob) // 2] ^= 0xFF
        d0.write_file(victim, bytes(blob))
        t0 = time.time()
        out = bad.anti_entropy()
        heal_ms = (time.time() - t0) * 1000
        assert victim in out["corrupt"] and bad.healthy
        qps = serve_and_check()
        print(f"failover: {victim} rotted on {bad.replica_id}, scrub caught "
              f"it, peer healed it in {heal_ms:.0f}ms "
              f"(repairs={bad.report()['repairs']}), {qps:.0f} qps, "
              f"zero wrong answers")

        for group in shards:
            for r in group:
                r.close()
        for ix in writers:
            ix.close()
    print("fleet serving demo OK")


if __name__ == "__main__":
    main()

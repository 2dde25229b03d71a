"""Retrieval serving driver of the port: index, refresh, serve BM25 top-k
through the fixed-slot ``QueryScheduler``, keep indexing, refresh and
serve again, then delete and update served docs, refresh and serve once
more — asserting that no tombstoned doc surfaces.

  python -m repro_torch.launch.serve                       # smoke, on CUDA
  python -m repro_torch.launch.serve --device cpu          # plain PyTorch
  python -m repro_torch.launch.serve --config full --docs 1048576 \\
      --batch-docs 16384 --requests 1024

``--config smoke`` is the SMOKE pipeline over the TINY corpus (the JAX
package's ``launch/serve.py --mode retrieval``); ``--config full`` is the
full ``lucene_envelope`` CONFIG over a corpus with ClueWeb09b's law
(``CW09B_SMALL``) scaled to ``--docs``. The pruned phases without
tombstones serve through the midgrid kernel; the phase after the deletes
takes the plain BM25 kernel (the midgrid gate needs a tombstone-free
segment).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import lucene_envelope
from repro_torch.core.indexer import Indexer
from repro_torch.data.corpus import CW09B_SMALL, TINY, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.serving.query_scheduler import QueryRequest, QueryScheduler


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(sched, reqs, device):
    """Serve ``reqs`` one scheduler batch at a time; returns the finished
    requests and each batch's wall time (submit to results on the host)."""
    done, lat = [], []
    for s in range(0, len(reqs), sched.slots):
        chunk = reqs[s:s + sched.slots]
        t0 = time.perf_counter()
        for r in chunk:
            r.done = False
            sched.submit(r, now=t0)
        done += sched.run_to_completion()
        _sync(device)
        lat.append(time.perf_counter() - t0)
    return done, lat


def generate_batches(corpus, n_batches: int, batch_docs: int,
                     workers: int = 8) -> list:
    """Every corpus batch, made up front on a few threads (numpy releases
    the GIL in its bulk draws). This is set-up: it is timed apart from
    indexing."""
    with ThreadPoolExecutor(max(1, min(workers, n_batches))) as pool:
        return list(pool.map(lambda i: corpus.batch(i, batch_docs),
                             range(n_batches)))


def serve_retrieval(args):
    """BM25 serving over live segments via the fixed-slot QueryScheduler.
    Returns ``(phases, report)``: per serving phase ("first", "refreshed",
    "lifecycle") the searcher it served from and its finished requests,
    and a dict of the run's measurements."""
    device = resolve_device(args.device)
    if args.config == "smoke":
        cfg, spec = lucene_envelope.SMOKE, TINY
    else:
        cfg = lucene_envelope.CONFIG
        spec = dataclasses.replace(CW09B_SMALL, n_docs=args.docs)
    corpus = SyntheticCorpus(spec, doc_buffer_len=cfg.doc_len)
    n_batches = max(args.docs // args.batch_docs, 2)
    half = n_batches // 2
    ix = Indexer(cfg=cfg, device=device)
    report = {"device": str(device), "docs": n_batches * args.batch_docs}
    t0 = time.perf_counter()
    batches = generate_batches(corpus, n_batches, args.batch_docs)
    report["generate_s"] = time.perf_counter() - t0

    # index_s: corpus batches through index_batch (flushes included);
    # refresh*_s: the refreshes that make them searchable (the final
    # flush + reader builds, synchronized on the device)
    t0 = time.perf_counter()
    for i in range(half):
        ix.index_batch(batches[i])
    report["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    searcher = ix.refresh()
    report["refresh1_s"] = time.perf_counter() - t0
    sched = QueryScheduler(searcher=searcher, slots=args.slots,
                           max_terms=args.query_terms, k=args.topk,
                           device=device)

    rng = np.random.default_rng(0)
    vocab = np.unique(batches[0][:32])[1:]

    def make_reqs(n, rid0=0):
        return [QueryRequest(rid=rid0 + i, terms=rng.choice(
                    vocab, size=args.query_terms, replace=False),
                    k=args.topk)
                for i in range(n)]

    # warm up on throwaway queries so the timed section is steady-state
    warm = make_reqs(args.slots, rid0=-args.slots)
    for r in warm:
        sched.submit(r)
    sched.step()
    reqs = make_reqs(args.requests)
    t0 = time.perf_counter()
    done1, lat1 = _serve(sched, reqs, device)
    dt = max(time.perf_counter() - t0, 1e-9)
    report.update(serve1_queries=len(done1), serve1_s=dt,
                  qps=len(done1) / dt,
                  batch_p50_ms=float(np.percentile(lat1, 50)) * 1e3,
                  batch_p99_ms=float(np.percentile(lat1, 99)) * 1e3,
                  segments1=searcher.n_segments)
    print(f"retrieval: {searcher.n_segments} live segments, "
          f"{searcher.n_docs} docs; served {len(done1)} queries "
          f"in {dt*1000:.0f}ms ({len(done1)/dt:.0f} qps)")
    ps = sched.prune_stats
    print(f"pruning: {ps.blocks_candidate} candidate blocks -> "
          f"{ps.blocks_survived} survived -> {ps.blocks_scored} scored "
          f"(skip rate {ps.skip_rate:.2f}, "
          f"{ps.segments_skipped} segments skipped)")
    print(f"midgrid: {ps.blocks_skipped_midgrid} survivor blocks skipped "
          f"inside the kernel grid")

    # keep indexing, refresh, serve again — search-while-indexing
    t0 = time.perf_counter()
    for i in range(half, n_batches):
        ix.index_batch(batches[i])
    t1 = time.perf_counter()
    sched.swap_searcher(ix.refresh())
    report["index_s"] += t1 - t0
    report["refresh2_s"] = time.perf_counter() - t1
    report["docs_per_s"] = report["docs"] / (
        report["index_s"] + report["refresh1_s"] + report["refresh2_s"])
    print(f"refresh: {ix.stats.last_refresh_s*1000:.1f}ms, "
          f"reader builds {ix.reader_cache.builds} "
          f"(cache hits {ix.reader_cache.hits})")
    done2, _ = _serve(sched, reqs[:args.slots], device)
    top = f"top score {float(done2[0].scores[0]):.3f}" if done2 \
        else "no queries"
    print(f"post-refresh: {sched.searcher.n_docs} docs searchable; {top}")
    phases = {"first": (searcher, done1),
              "refreshed": (sched.searcher, done2)}

    # --- document lifecycle: delete + update live docs, serve again ------
    if args.deletes or args.updates:
        served = np.unique(np.concatenate(
            [r.doc_ids for r in done2 if r.doc_ids is not None]))
        served = served[served >= 0]
        del_ids = served[:args.deletes]
        upd_ids = served[args.deletes:args.deletes + args.updates]
        ix.delete(del_ids)
        for d in upd_ids:
            d = int(d)
            ix.update(d, batches[d % n_batches][d % args.batch_docs])
        t0 = time.perf_counter()
        sched.swap_searcher(ix.refresh())
        report["refresh3_s"] = time.perf_counter() - t0
        done3, _ = _serve(sched, reqs[:args.slots], device)
        got = np.concatenate([r.doc_ids for r in done3]) if done3 \
            else np.zeros(0, np.int64)
        gone = set(del_ids.tolist()) | set(upd_ids.tolist())
        assert not (set(got[got >= 0].tolist()) & gone), \
            "a tombstoned doc surfaced after its delete was acknowledged"
        snap = ix.merger.snapshot()
        print(f"lifecycle: deleted {len(del_ids)} + updated {len(upd_ids)} "
              f"docs; {sched.searcher.n_docs} live "
              f"({snap['deleted_docs']} tombstoned awaiting merge); "
              f"no deleted doc served")
        phases["lifecycle"] = (sched.searcher, done3)
        report.update(deleted=len(del_ids), updated=len(upd_ids))
    snap = ix.merger.snapshot()
    report.update(flush_wall_s=ix.stats.wall_s,
                  merge_wall_s=snap["merge_wall_s"],
                  n_merges=snap["n_merges"],
                  segments=sched.searcher.n_segments,
                  prune_stats=dataclasses.asdict(sched.prune_stats))
    ix.close()
    return phases, report


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    ap.add_argument("--config", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--docs", type=int, default=256,
                    help="docs to index (two halves, refresh between)")
    ap.add_argument("--batch-docs", type=int, default=32)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--query-terms", type=int, default=4)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--deletes", type=int, default=8,
                    help="tombstone this many served docs and prove the "
                         "next snapshot never returns them")
    ap.add_argument("--updates", type=int, default=4,
                    help="replace this many served docs (delete + re-add)")
    return ap


def main(argv=None):
    return serve_retrieval(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

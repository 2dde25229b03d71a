"""Serve the lexical half of ``examples/serve_retrieval.py`` on the
PyTorch/CUDA port: the paper's inverted index + block-max BM25, served
segment-natively over *live* segments with batched requests, a refresh
mid-serving and deletes + an update. The dense two-tower half waits for
the recsys models' slice of the port (ROADMAP.md, Queue 1, "Off the main
path, last").

    PYTHONPATH=src python examples/torch_serve_retrieval.py               # CUDA
    PYTHONPATH=src python examples/torch_serve_retrieval.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.data.corpus import TINY, SyntheticCorpus
from repro_torch.serving.query_scheduler import QueryRequest, QueryScheduler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    # ---- lexical path: the paper's pipeline, searched while it is built
    env_cfg = get_arch("lucene-envelope").smoke
    corpus = SyntheticCorpus(TINY, doc_buffer_len=env_cfg.doc_len)
    indexer = Indexer(cfg=env_cfg, device=args.device)
    for i in range(3):
        indexer.index_batch(corpus.batch(i, 32))
    # NRT refresh: searchable snapshot of the live segments, no
    # force-merge
    searcher = indexer.refresh()

    rng = np.random.default_rng(0)
    vocab = np.unique(corpus.batch(0, 32))[1:]
    sched = QueryScheduler(searcher=searcher, slots=16, max_terms=3, k=10,
                           device=indexer.device)
    for i in range(16):
        sched.submit(QueryRequest(rid=i, terms=rng.choice(vocab, size=3,
                                                          replace=False)))
    sched.step()  # warm-up
    for i in range(16, 32):
        sched.submit(QueryRequest(rid=i, terms=rng.choice(vocab, size=3,
                                                          replace=False)))
    t0 = time.time()
    done = sched.run_to_completion()
    lex_dt = time.time() - t0
    print(f"lexical: {len(done)} queries over {searcher.n_segments} live "
          f"segments ({searcher.n_docs} docs) in {lex_dt*1000:.0f}ms "
          f"({len(done)/lex_dt:.0f} qps batched)")

    # keep indexing; swap in a fresher snapshot mid-serving
    for i in range(3, 6):
        indexer.index_batch(corpus.batch(i, 32))
    sched.swap_searcher(indexer.refresh())
    sched.submit(QueryRequest(rid=99, terms=done[0].terms))
    req = sched.run_to_completion()[0]
    print(f"after refresh ({indexer.stats.last_refresh_s*1000:.1f}ms, "
          f"{indexer.reader_cache.builds} reader builds / "
          f"{indexer.reader_cache.hits} cache hits): "
          f"{sched.searcher.n_docs} docs searchable, "
          f"top score {float(req.scores[0]):.3f}")

    # document lifecycle mid-serving: tombstone two served docs, replace
    # one
    served = np.unique(np.concatenate([np.asarray(r.doc_ids)
                                       for r in done]))
    victims = served[served >= 0][:2].astype(np.int64)
    indexer.delete(victims)
    indexer.update(int(served[served >= 0][2]), corpus.batch(7, 32)[0])
    sched.swap_searcher(indexer.refresh())
    sched.submit(QueryRequest(rid=100, terms=done[0].terms))
    req = sched.run_to_completion()[0]
    assert not np.isin(np.asarray(req.doc_ids), victims).any()
    print(f"lifecycle: deleted {victims.tolist()} + updated 1 doc; "
          f"{sched.searcher.n_docs} live docs, reader reopens "
          f"{indexer.reader_cache.reopens} (no index rebuilds), "
          f"tombstoned docs never served")
    indexer.close()
    return done


if __name__ == "__main__":
    main()

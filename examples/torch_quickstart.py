"""Quickstart on the PyTorch/CUDA port: index a synthetic web crawl, query
it, read the envelope (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py               # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.core.query import bm25_topk
from repro_torch.core.searcher import build_block_index
from repro_torch.data.corpus import TINY, SyntheticCorpus


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    # 1. a ClueWeb-shaped synthetic corpus (deterministic)
    cfg = get_arch("lucene-envelope").smoke
    corpus = SyntheticCorpus(TINY, doc_buffer_len=cfg.doc_len)

    # 2. index it: sort inversion on the device -> flush -> tiered
    #    merges, charging bytes to the media pair from the paper
    #    (Ceph -> SSD)
    indexer = Indexer(cfg=cfg, device=args.device, source="ceph",
                      target="ssd")
    for i in range(8):
        indexer.index_batch(corpus.batch(i, 32))
    segment = indexer.finalize()
    report = indexer.envelope_report()
    print(f"indexed {indexer.stats.docs} docs, {segment.n_postings} "
          f"postings, {segment.n_terms} terms")
    print(f"measured merge amplification alpha = "
          f"{report['alpha_measured']:.2f} ({report['n_merges']} merges)")
    print(f"envelope: bound={report['bound']} "
          f"modeled {report['gb_per_min_modeled']:.2f} GB/min")

    # 3. serve BM25 queries with block-max pruning
    index = build_block_index(segment, device=indexer.device)
    query = torch.from_numpy(np.unique(corpus.batch(0, 4))[1:4].astype(
        np.int32))
    scores, doc_ids, stats = bm25_topk(index, query, k=5)
    print(f"query {query.tolist()} -> top docs {doc_ids.cpu().tolist()} "
          f"scores {[round(float(s), 3) for s in scores.cpu()]}")
    print(f"block-max pruning: {int(stats['blocks_total'])} candidate "
          f"blocks, {int(stats['blocks_survived'])} survived the MaxScore "
          f"test, {int(stats['blocks_scored'])} scored (probe + bucket "
          f"padding)")
    indexer.close()


if __name__ == "__main__":
    main()

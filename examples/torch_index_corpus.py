"""Reproduce the paper's experiment on the PyTorch/CUDA port: index the
same corpus across every source->target media pair and compare the
envelope, then check the paper's qualitative findings hold
(``examples/index_corpus.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_index_corpus.py               # CUDA
    PYTHONPATH=src python examples/torch_index_corpus.py --device cpu
"""
import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.data.corpus import CW09B_SMALL, SyntheticCorpus

PAIRS = [("ceph", "zfs"), ("zfs", "zfs"), ("ceph", "xfs"), ("xfs", "xfs"),
         ("ceph", "ssd"), ("zfs", "ssd"), ("xfs", "ssd"), ("ssd", "ssd")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = get_arch("lucene-envelope").smoke
    corpus = SyntheticCorpus(CW09B_SMALL, doc_buffer_len=cfg.doc_len)
    batches = [corpus.batch(i, 64) for i in range(12)]

    rows = {}
    for src, tgt in PAIRS:
        ix = Indexer(cfg=cfg, device=args.device, source=src, target=tgt)
        for b in batches:
            ix.index_batch(b)
        ix.finalize()
        rows[(src, tgt)] = ix.envelope_report()
        ix.close()

    print(f"{'pair':>12} | {'GB/min':>7} | {'bound':>9} | alpha")
    for (src, tgt), r in rows.items():
        print(f"{src:>5}->{tgt:<5} | {r['gb_per_min_modeled']:7.2f} | "
              f"{r['bound']:>9} | {r['alpha_measured']:.2f}")

    best = max(rows.values(), key=lambda r: r["gb_per_min_modeled"])
    worst = min(rows.values(), key=lambda r: r["gb_per_min_modeled"])
    print(f"\nspread: "
          f"{best['gb_per_min_modeled']/worst['gb_per_min_modeled']:.2f}x "
          f"(paper: ~2.6x)")
    assert rows[("ssd", "ssd")]["gb_per_min_modeled"] < \
        rows[("ceph", "ssd")]["gb_per_min_modeled"], "isolation should win"
    assert rows[("ceph", "xfs")]["gb_per_min_modeled"] > \
        rows[("ceph", "zfs")]["gb_per_min_modeled"], \
        "xfs target should beat zfs"
    print("paper's qualitative findings reproduced on our pipeline ✓")
    return rows


if __name__ == "__main__":
    main()

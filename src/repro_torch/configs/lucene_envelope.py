"""lucene_envelope — the paper's own pipeline as a selectable config
(copied from the JAX package's ``repro/configs/lucene_envelope.py``).

``CONFIG`` is the full-width pipeline: 1024-token doc buffers, a 256 MB
flush budget, tiered merges at fanout 10 and 128-lane postings blocks.
``SMOKE`` is the reduced config the CPU tests and examples run.
"""
from repro_torch.configs.base import EnvelopeConfig

CONFIG = EnvelopeConfig(name="lucene_envelope", shuffle_payload="packed2",
                        codec="pfor", source_media="nas", target_media="ssd")

SMOKE = EnvelopeConfig(
    name="lucene-envelope-smoke",
    docs_per_shard=32,
    doc_len=64,
    vocab_bits=12,
    postings_block=128,
    flush_budget_mb=0,  # flush every batch: small segments, real merges
    merge_fanout=4,
)

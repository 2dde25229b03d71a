"""Synthetic web-crawl generator: ClueWeb-shaped document buffers.

Term ids follow a Zipf-Mandelbrot law over a hashed vocabulary (matching
what the FNV tokenizer emits for real text); doc lengths are lognormal
around the ClueWeb09b/12b means. Deterministic per (seed, batch index),
so restarted indexing jobs re-read identical data (fault-tolerance tests
rely on this).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusSpec:
    name: str
    n_docs: int
    mean_doc_len: int
    doc_len_sigma: float
    vocab_bits: int
    zipf_s: float = 1.2
    zipf_q: float = 2.7
    seed: int = 0
    # > 0: topic-mixture (clustered) corpus — each doc draws one of
    # ``n_topics`` topics; its terms come from a topic-rotated copy of
    # the Zipf law and its length is scaled by a per-topic factor. Real
    # crawls are clustered like this; it is what merge-time doc-id
    # reassignment (BP) exploits, so the reordering benchmarks use it.
    # 0 keeps the iid stream (every doc statistically identical — BP has
    # nothing to recover, kept as the null case).
    n_topics: int = 0


CW09B_SMALL = CorpusSpec("cw09b-small", n_docs=16384, mean_doc_len=384,
                         doc_len_sigma=0.7, vocab_bits=18)
CW12B_SMALL = CorpusSpec("cw12b-small", n_docs=16384, mean_doc_len=576,
                         doc_len_sigma=0.7, vocab_bits=18)
TINY = CorpusSpec("tiny", n_docs=256, mean_doc_len=48, doc_len_sigma=0.5,
                  vocab_bits=12)


def _zipf_mandelbrot_probs(vocab: int, s: float, q: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks + q, s)
    return w / w.sum()


class SyntheticCorpus:
    """Batched, seeded, stateless: batch(i) is a pure function of (spec, i)."""

    def __init__(self, spec: CorpusSpec, doc_buffer_len: int = 1024):
        self.spec = spec
        self.doc_buffer_len = doc_buffer_len
        vocab = 1 << spec.vocab_bits
        self._probs = _zipf_mandelbrot_probs(vocab - 1, spec.zipf_s, spec.zipf_q)
        # random rank->term-id permutation (hashed ids aren't rank-ordered)
        rng = np.random.default_rng(spec.seed ^ 0x5EED)
        self._rank_to_term = rng.permutation(vocab - 1).astype(np.int32) + 1
        # topic t reads the rank axis through its own rotation, so topics
        # share the global Zipf shape but head terms differ per topic —
        # docs of one topic co-occur on one topic's head vocabulary. Only
        # half of each doc's tokens are rotated: the unrotated half keeps
        # a topic-SPANNING global vocabulary (realistic stopword/head
        # sharing, and the query terms the reordering benches serve),
        # while the rotated half carries the co-occurrence signal BP
        # clusters on.
        if spec.n_topics > 0:
            self._topic_shift = rng.integers(0, vocab - 1, spec.n_topics)
            # per-topic length scaling (terse -> verbose topics): after
            # BP clusters a topic, its blocks share a homogeneous length
            # floor, which is what skews the block-max bounds
            self._topic_len = np.exp(np.linspace(-0.8, 0.8, spec.n_topics))

    def batch(self, index: int, n_docs: int) -> np.ndarray:
        rng = np.random.default_rng((self.spec.seed, index))
        L = self.doc_buffer_len
        lens = rng.lognormal(np.log(self.spec.mean_doc_len),
                             self.spec.doc_len_sigma, size=n_docs)
        nt = self.spec.n_topics
        topic = rng.integers(0, nt, n_docs) if nt else None
        if nt:
            lens = lens * self._topic_len[topic]
        lens = np.clip(lens.astype(np.int64), 8, L)
        out = np.zeros((n_docs, L), np.int32)
        total = int(lens.sum())
        ranks = rng.choice(len(self._probs), size=total, p=self._probs)
        if nt:
            # rotate half of each doc's ranks by its topic's shift: same
            # marginal law, topic-local head terms (the clustering signal
            # BP recovers); the other half stays on the shared global
            # vocabulary, so head terms span every topic
            shift = np.repeat(self._topic_shift[topic], lens)
            rot = rng.random(total) < 0.5
            ranks = np.where(rot, (ranks + shift) % len(self._probs), ranks)
        terms = self._rank_to_term[ranks]
        off = 0
        for i, ln in enumerate(lens):
            out[i, :ln] = terms[off:off + ln]
            off += ln
        return out

    def raw_bytes(self, n_docs: int) -> float:
        """Approximate 'raw compressed collection' bytes for throughput
        accounting (ClueWeb is ~4.6KB/doc compressed for 09b)."""
        return n_docs * self.spec.mean_doc_len * 12.0


# ---------------------------------------------------------------------------
# spooling the source collection through a storage Directory
# ---------------------------------------------------------------------------
# The paper reads the collection off a *source* medium while the index hits
# a *target* medium. Spooling writes the batched doc buffers as checksummed
# files into a source Directory once; ``iter_spooled`` then streams them
# back through that directory during indexing, so source reads are measured
# (and throttled) on their own device, physically separate from the target.

_SPOOL_RE_PREFIX = "batch_"


def spool_corpus(corpus: SyntheticCorpus, directory, n_batches: int,
                 docs_per_batch: int) -> int:
    """Write ``n_batches`` corpus batches into ``directory`` as
    ``batch_<i>`` files (framed + checksummed); returns total bytes."""
    from repro_torch.storage.codec import KIND_SPOOL, frame
    import struct
    total = 0
    for i in range(n_batches):
        toks = np.ascontiguousarray(corpus.batch(i, docs_per_batch),
                                    np.int32)
        payload = struct.pack("<QQ", *toks.shape) + toks.astype("<i4").tobytes()
        total += directory.write_file(f"{_SPOOL_RE_PREFIX}{i:06d}",
                                      frame(KIND_SPOOL, payload))
    return total


def iter_spooled(directory):
    """Stream spooled batches back in batch order: yields
    ``(batch_index, tokens (D, L) int32)``. Every read goes through the
    directory (measured, throttled); checksums are verified per file."""
    from repro_torch.storage.codec import KIND_SPOOL, unframe
    import struct
    for name in directory.list_files():
        if not name.startswith(_SPOOL_RE_PREFIX):
            continue
        payload = unframe(directory.read_file(name), KIND_SPOOL)
        d, l = struct.unpack_from("<QQ", payload, 0)
        toks = np.frombuffer(payload, "<i4", offset=16).reshape(d, l)
        yield int(name[len(_SPOOL_RE_PREFIX):]), toks.copy()

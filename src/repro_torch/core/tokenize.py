"""Hashing tokenizer: raw documents -> fixed-width term-id buffers (the
port's copy of the JAX package's ``core/tokenize.py``).

The device pipeline consumes (docs, doc_len) int32 buffers with 0 = padding
and term ids in [1, 2^vocab_bits). Real text is tokenized host-side (split
on non-alphanumerics, lowercase, FNV-1a hash); the synthetic corpus
generator (``repro_torch/data/corpus.py``) emits buffers directly.
"""
from __future__ import annotations

import re

import numpy as np

_SPLIT = re.compile(r"[^0-9a-z]+")
FNV_OFFSET = np.uint64(14695981039346656037)
FNV_PRIME = np.uint64(1099511628211)


def fnv1a(token: str) -> int:
    h = FNV_OFFSET
    for b in token.encode("utf-8"):
        h = np.uint64(h ^ np.uint64(b)) * FNV_PRIME
    return int(h)


def hash_term(token: str, vocab_bits: int) -> int:
    """Term id in [1, 2^vocab_bits): 0 is reserved for padding."""
    space = (1 << vocab_bits) - 1
    return (fnv1a(token) % space) + 1


def tokenize_text(text: str, vocab_bits: int) -> list[int]:
    return [hash_term(t, vocab_bits) for t in _SPLIT.split(text.lower()) if t]


def docs_to_buffer(docs: list[str], doc_len: int, vocab_bits: int) -> np.ndarray:
    """Tokenize + truncate/pad documents into a (D, doc_len) int32 buffer."""
    out = np.zeros((len(docs), doc_len), np.int32)
    for i, d in enumerate(docs):
        ids = tokenize_text(d, vocab_bits)[:doc_len]
        out[i, :len(ids)] = ids
    return out

"""Flush policy: the paper's 'in-memory inversion with periodic flushes'.

Lucene flushes a thread's in-memory segment when its RAM buffer fills
(indexWriter.ramBufferSizeMB); here the accumulating in-memory runs are
flushed when their estimated buffer bytes exceed ``flush_budget_mb``.
Smaller budgets mean more, smaller segments and therefore more merge
pressure (higher measured alpha) — exactly the §4 trade-off the paper
describes; benchmarks can sweep it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FlushPolicy:
    budget_mb: int = 256
    _pending: list = field(default_factory=list)
    _bytes: int = 0
    flushes: int = 0

    def add(self, tokens: np.ndarray) -> bool:
        """Account one doc batch; True when a flush is due."""
        # in-memory inversion buffers: sorted (term, doc, pos) triples
        self._pending.append(tokens)
        self._bytes += int((tokens > 0).sum()) * 12
        return self._bytes >= self.budget_mb * 2 ** 20

    def take(self) -> np.ndarray:
        """Return the accumulated buffer for flushing and reset."""
        batch = np.concatenate(self._pending, axis=0)
        self._pending.clear()
        self._bytes = 0
        self.flushes += 1
        return batch

    @property
    def pending_docs(self) -> int:
        return sum(t.shape[0] for t in self._pending)

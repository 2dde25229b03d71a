"""LM token pipeline: seeded, stateless, prefetching (the JAX package's
``repro/data/lm.py``; the same numpy generator, so its batches equal the
JAX package's bit for bit).

``batch_at(step)`` is a pure function of (seed, step): restarts resume
bitwise identically. A background thread prefetches the next host batch
while the device step runs. Unlike the JAX package's, a prefetcher whose
batch function raised hands that error to ``get()`` instead of leaving it
blocked forever.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class LMBatches:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, zipf_s: float = 1.1):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.zipf_s = zipf_s

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        raw = rng.zipf(self.zipf_s, size=(self.batch, self.seq_len + 1))
        toks = (raw % (self.vocab_size - 2) + 1).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].copy(),
            "mask": np.ones((self.batch, self.seq_len), np.float32),
        }


class Prefetcher:
    """One-batch-ahead host prefetch thread. If ``batch_fn`` raises, the
    worker stops and ``get()`` raises what it died of."""

    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        self.batch_fn = batch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                item = (step, self.batch_fn(step))
            except BaseException as e:  # handed to get(), which raises it
                self._error = e
                self._put(None)
                return
            self._put(item)
            step += 1

    def get(self):
        if self._error is not None and self.q.empty():
            raise self._error
        item = self.q.get()
        if item is None:
            raise self._error
        return item

    def close(self):
        self._stop.set()

"""Chunked double-buffered source reader — the 'source' end of the paper's
pipe, with modeled media timing (the port's copy of the JAX package's
``io/reader.py``).

Reads corpus batches on a background thread (overlapping the read stage
with inversion, the paper's isolation insight operationalized) and
accounts modeled source-media time so the indexing driver can report the
read stage of the envelope independently of host wall-clock.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from repro_torch.core.envelope import MEDIA, GB


@dataclass
class ReadStats:
    bytes: int = 0
    batches: int = 0
    modeled_s: float = 0.0


class DoubleBufferedReader:
    def __init__(self, batch_fn, n_batches: int, media: str = "ceph",
                 depth: int = 2):
        self.batch_fn = batch_fn
        self.n_batches = n_batches
        self.media = MEDIA[media]
        self.stats = ReadStats()
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        for i in range(self.n_batches):
            b = self.batch_fn(i)
            self.stats.bytes += b.nbytes
            self.stats.batches += 1
            self.stats.modeled_s += b.nbytes / (self.media.read_bw * GB)
            self.q.put((i, b))
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item

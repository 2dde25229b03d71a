"""Capped exponential-backoff retries around Directory ops.

A NAS mount that throws one EIO per ten thousand ops would kill every
long indexing run if the first fault aborted it; a full device retried
forever would hang it. ``RetryPolicy`` draws the line the way durable
stores do: **transient** faults (generic ``OSError``/EIO — a dropped
NFS reply, a controller hiccup) are retried with capped exponential
backoff plus jitter; **persistent** faults (``ENOSPC``,
``FileNotFoundError``) propagate immediately, and a transient fault
that survives every retry surfaces as the typed ``RetriesExhausted``
(an ``OSError`` subclass, so existing recovery paths that fall back
past unreadable commits keep working).

``RetryingDirectory`` applies the policy to every primitive op of an
inner Directory — the one wrapper that hardens ``SegmentStore``,
``write_commit``, and ``.liv`` writes at once:

    directory = RetryingDirectory(FSDirectory(path), RetryPolicy())

Stacked under ``FaultInjectingDirectory`` in tests, the injector's
``transient_repeat`` guarantee (a drawn fault heals after N consecutive
failures) makes recovery provable for any cap >= N per fault gate.
Note ``sync`` is a compound op: the ``Directory.sync`` contract checks
existence first, so one retried sync crosses TWO gates (``list`` +
``sync``) and independent drawn faults can stack — size caps at
``gates * transient_repeat`` when both matter.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass, field

from repro_torch.storage.directory import Directory


class RetriesExhausted(OSError):
    """A transient fault outlived the retry budget — typed so callers can
    distinguish "media kept failing" from a first-strike error."""

    def __init__(self, op: str, name: str, attempts: int,
                 last: BaseException):
        super().__init__(errno.EIO,
                         f"{op} {name!r} failed after {attempts} attempts: "
                         f"{last}")
        self.op = op
        self.name = name
        self.attempts = attempts


def is_transient_error(exc: BaseException) -> bool:
    """Default retryability: generic IO errors are worth a retry; a
    missing file or a full device is not going to improve."""
    if isinstance(exc, (FileNotFoundError, RetriesExhausted)):
        return False
    if isinstance(exc, OSError):
        return exc.errno != errno.ENOSPC
    return False


@dataclass
class RetryPolicy:
    """Capped exponential backoff with jitter.

    Attempt ``k`` (1-based) sleeps ``min(max_delay_s, base_delay_s *
    2**(k-1))`` scaled down by up to ``jitter`` (seeded, so runs are
    reproducible). ``max_retries`` bounds *re*-attempts: an op is tried
    at most ``max_retries + 1`` times total.
    """

    max_retries: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.1
    jitter: float = 0.5
    seed: int = 0
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)
    _lock: threading.Lock = field(init=False, repr=False, compare=False,
                                  default=None)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        with self._lock:
            return d * (1.0 - self.jitter * self._rng.random())

    def call(self, fn, *, op: str = "op", name: str = "",
             retryable=is_transient_error, on_retry=None):
        """Run ``fn()`` under the policy. Non-retryable errors propagate
        untouched; a retryable error past the cap raises
        ``RetriesExhausted`` chained to the last failure."""
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as exc:
                if not retryable(exc):
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    raise RetriesExhausted(op, name, attempt, exc) from exc
                if on_retry is not None:
                    on_retry(op, name, attempt, exc)
                time.sleep(self.delay(attempt))


class RetryingDirectory(Directory):
    """A Directory whose every primitive op runs under a RetryPolicy.

    ``retries`` counts re-attempts that were issued, ``giveups`` counts
    ops that exhausted the cap (and raised ``RetriesExhausted``) — both
    sit beside the byte/wall accounting every Directory keeps.
    """

    def __init__(self, inner: Directory, policy: RetryPolicy | None = None):
        super().__init__()
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        self.retries = 0
        self.giveups = 0

    def _call(self, op, name, fn):
        def on_retry(op_, name_, attempt, exc):
            with self._acct_lock:
                self.retries += 1
        try:
            return self.policy.call(fn, op=op, name=name, on_retry=on_retry)
        except RetriesExhausted:
            with self._acct_lock:
                self.giveups += 1
            raise

    def _write(self, name, data):
        self._call("write", name, lambda: self.inner.write_file(name, data))

    def _read(self, name):
        return self._call("read", name, lambda: self.inner.read_file(name))

    def _list(self):
        return self._call("list", "", self.inner._list)

    def _delete(self, name):
        self._call("delete", name, lambda: self.inner.delete_file(name))

    def _rename(self, src, dst):
        self._call("rename", dst, lambda: self.inner.rename(src, dst))

    def _sync(self, names):
        names = list(names)
        self._call("sync", ";".join(names), lambda: self.inner.sync(names))

    def _size(self, name):
        return self._call("size", name, lambda: self.inner.file_size(name))

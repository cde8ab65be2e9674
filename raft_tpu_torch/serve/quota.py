"""Per-client quotas for the evaluation service (a copy of
``raft_tpu/serve/quota.py``).

Backpressure has two layers with distinct HTTP semantics:

* **quota** (this module): a per-client token bucket — sustained rate
  ``RAFT_TPU_SERVE_QPS`` with burst capacity ``RAFT_TPU_SERVE_BURST``.
  A client over its bucket gets **429** (its problem: slow down); other
  clients are unaffected.
* **admission queue** (:mod:`raft_tpu_torch.serve.batcher`): one bounded
  pending queue for the whole service.  A full queue gets **503** (the
  server's problem: every client should back off) — the queue bound is
  what keeps a load spike from growing an unbounded backlog of
  accepted-but-unserved work.

Pure stdlib, no torch.  The clock is injectable for tests.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill, ``burst``
    capacity, one token per request.  ``rate <= 0`` disables the
    bucket (every acquire succeeds)."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_lock", "_clock")

    def __init__(self, rate, burst, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._lock = threading.Lock()
        self._tokens = self.burst  # raft-lint: guarded-by=self._lock
        self._clock = clock
        self._t = clock()  # raft-lint: guarded-by=self._lock

    def acquire(self, n=1):
        """Take ``n`` tokens; False when the bucket is dry."""
        if self.rate <= 0:
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def refund(self, n=1):
        """Return ``n`` tokens (clamped to the burst capacity): a
        request rejected AFTER its quota debit — admission queue full,
        service draining — must not also eat the client's budget."""
        if self.rate <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)

    def retry_after_s(self):
        """Suggested client back-off (the ``Retry-After`` header):
        time until one token refills."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            missing = max(0.0, 1.0 - self._tokens)
        return missing / self.rate


class ClientQuotas:
    """Lazily-created per-client token buckets keyed by client id (the
    ``X-Client`` header when present, else the peer address).  Client
    maps are bounded: the least-recently-seen bucket is dropped past
    ``max_clients`` — a full bucket is the steady state for an absent
    client anyway, so re-creating it later is semantically free."""

    def __init__(self, rate, burst, max_clients=4096, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._max = int(max_clients)
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}  # raft-lint: guarded-by=self._lock

    def bucket(self, client):
        client = str(client or "anonymous")
        with self._lock:
            b = self._buckets.get(client)
            if b is None:
                if len(self._buckets) >= self._max:
                    self._buckets.pop(next(iter(self._buckets)))
                b = self._buckets[client] = TokenBucket(
                    self.rate, self.burst, clock=self._clock)
            else:
                # refresh recency (plain dicts iterate in insert order)
                self._buckets.pop(client)
                self._buckets[client] = b
            return b

    def acquire(self, client):
        return self.bucket(client).acquire()

"""Content-addressed result cache (counterpart of
``raft_tpu/serve/cache.py``).

One evaluation is keyed by its content: the design fingerprint, the
exact case values and the computed out_keys, so a hit is bit-identical
to the evaluation that stored it.  An LRU with a byte budget (numpy
``nbytes``), thread-safe.  :class:`raft_tpu_torch.omdao.DesignEvaluation`
uses it for an optimizer's repeated iterates.

The keys are those of the reference, digest for digest.  Hit, miss and
eviction totals count on the instance (:meth:`ResultCache.stats`) and
feed the metrics registry (:mod:`raft_tpu_torch.obs.metrics`) under
the reference's names: ``<prefix>_hits`` / ``_misses`` / ``_evictions``
counters and a ``<prefix>_bytes`` gauge.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from raft_tpu_torch.obs import metrics


def _value_token(v):
    """Exact content token of one case value: a scalar float by its IEEE
    bits, an array by a hash of its bytes, dtype and shape, an object
    value by its ``repr``."""
    a = np.asarray(v)
    if a.dtype == object:
        return repr(v)
    if a.size == 1 and np.issubdtype(a.dtype, np.floating):
        return float(a.reshape(-1)[0]).hex()
    return hashlib.sha256(
        a.tobytes() + str(a.dtype).encode() + repr(a.shape).encode()
    ).hexdigest()


def result_cache_key(design_fingerprint, case, out_keys, extra=()):
    """Stable sha256 hex key of one evaluation: the design fingerprint
    (:func:`raft_tpu_torch.aot.bank.content_fingerprint`), the case
    mapping (each value by :func:`_value_token`, keys sorted), the
    computed out_keys and anything ``extra`` that shapes the numbers."""
    case_items = tuple(sorted((str(k), _value_token(v))
                              for k, v in dict(case).items()))
    blob = repr((str(design_fingerprint), case_items,
                 tuple(out_keys), tuple(extra)))
    return hashlib.sha256(blob.encode()).hexdigest()


def _entry_bytes(row):
    return sum(np.asarray(v).nbytes for v in row.values())


class ResultCache:
    """Byte-budgeted LRU of evaluation rows ``{out_key: numpy array}``.

    Eviction is by access order; an entry larger than the whole budget
    is not cached.  ``hits``, ``misses`` and ``evictions`` count on the
    instance (:meth:`stats` reports them with the entries and bytes)
    and in the metrics registry under ``<metrics_prefix>_hits`` /
    ``_misses`` / ``_evictions``, with the held bytes as the
    ``<metrics_prefix>_bytes`` gauge."""

    def __init__(self, max_bytes, metrics_prefix="serve_cache"):
        self.max_bytes = int(max_bytes)
        self.metrics_prefix = metrics_prefix
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, tuple[dict, int]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        """The cached row for ``key`` (a shallow copy) or ``None``."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                metrics.counter(self.metrics_prefix + "_misses").inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            metrics.counter(self.metrics_prefix + "_hits").inc()
            return dict(ent[0])

    def put(self, key, row):
        """Insert one row (values copied to host numpy); a re-insert
        under the same key refreshes its recency and swaps the payload.
        Returns False when the row alone exceeds the budget."""
        row = {k: np.array(v) for k, v in row.items()}
        nbytes = _entry_bytes(row)
        if nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (row, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._entries:
                _, (_, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1
                metrics.counter(self.metrics_prefix + "_evictions").inc()
            metrics.gauge(self.metrics_prefix + "_bytes").set(self._bytes)
        return True

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self):
        with self._lock:
            return self._bytes

    def stats(self):
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else None,
            }

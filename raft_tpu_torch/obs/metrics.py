"""Process-wide, thread-safe metrics registry.

Counters, gauges and fixed-bucket histograms fed by the runtime's
existing event sites (shards done/retried/quarantined/escalated, XLA
backend compiles via the recompilation sentinel, drag-linearisation
iteration counts, solver-health flags, span wall times).  Unlike the
JSONL event stream — which answers "what happened, in order" — the
registry answers "how much, in total" without re-reading anything:
``snapshot()`` is dumped into the sweep manifest and
``<out_dir>/metrics.json`` at ``sweep_done``, the bench folds it into
its breakdown, and :func:`to_prometheus` renders the standard
text-exposition format for scraping long runs
(``RAFT_TPU_METRICS=<path>``).

Pure stdlib, no torch import.  Metric updates are a lock + int/float op:
cheap enough to stay on unconditionally (they fire per shard / per
retry / per case, never per frequency bin), so telemetry totals exist
even when the ``RAFT_TPU_LOG`` event stream is off.

Histogram buckets are fixed and log-spaced (4 per decade over
1e-6..1e7, covering microsecond spans to ~100-day walls and iteration
counts alike) so snapshots from different processes are mergeable and
the p50/p95 estimates are stable.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

from raft_tpu_torch.utils import config

_T0 = time.perf_counter()

# fixed log-spaced bucket upper bounds: 10^(-6) .. 10^7, 4 per decade
BUCKET_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-24, 29))


def _exemplar_limits():
    """(K, min_value) admission policy for histogram/window exemplars,
    re-read per observation so tests and operators can retune live."""
    try:
        k = int(config.get("EXEMPLAR_K"))
    except ValueError:
        k = 2
    try:
        vmin = float(config.get("EXEMPLAR_MIN_S"))
    except ValueError:
        vmin = 0.0
    return k, vmin


def _emit_exemplar_event(metric, v, labels):
    """One ``exemplar_recorded`` event per *admitted* exemplar — the
    join key ``obs report --tail`` uses to find "the actual p99
    request" in a capture.  Called outside the metric lock (log_event
    takes the sink lock; never hold both).  Lazy import: metrics must
    stay importable standalone."""
    from raft_tpu_torch.utils import structlog

    structlog.log_event("exemplar_recorded", metric=metric,
                        value=round(float(v), 6), **labels)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0  # raft-lint: guarded-by=self._lock

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-value gauge with a high watermark (heartbeat memory peaks
    survive in ``max`` even after the gauge drops back)."""

    __slots__ = ("name", "_lock", "_value", "_max")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = None  # raft-lint: guarded-by=self._lock
        self._max = None  # raft-lint: guarded-by=self._lock

    def set(self, v):
        v = float(v)
        with self._lock:
            self._value = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def value(self):
        return self._value

    @property
    def max(self):
        return self._max

    def snapshot(self):
        return {"value": self._value, "max": self._max}


class Histogram:
    """Fixed log-spaced-bucket histogram with count/sum/min/max and
    bucket-interpolated percentile estimates."""

    __slots__ = ("name", "_lock", "count", "sum", "min", "max", "_buckets",
                 "_exemplars")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0  # raft-lint: guarded-by=self._lock
        self.sum = 0.0  # raft-lint: guarded-by=self._lock
        self.min = None  # raft-lint: guarded-by=self._lock
        self.max = None  # raft-lint: guarded-by=self._lock
        # len(BUCKET_BOUNDS) + 1: trailing overflow bucket (+inf)
        self._buckets = [0] * (len(BUCKET_BOUNDS) + 1)  # raft-lint: guarded-by=self._lock
        # bucket index -> up to K (value, unix_t, labels) kept largest-
        # first, so "the actual p99 request" is nameable from /metrics
        self._exemplars: dict = {}  # raft-lint: guarded-by=self._lock

    def observe(self, v, exemplar=None):
        """Record ``v``; ``exemplar`` (a small dict of label strings —
        trace/span ids plus caller attrs) competes for one of the
        top-K-by-value exemplar slots of ``v``'s log-bucket."""
        v = float(v)
        i = bisect.bisect_left(BUCKET_BOUNDS, v)
        admitted = False
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self._buckets[i] += 1
            if exemplar is not None:
                # top-K-by-value admission for bucket i
                k, vmin = _exemplar_limits()
                if k > 0 and v >= vmin:
                    slot = self._exemplars.setdefault(i, [])
                    entry = (v, time.time(), dict(exemplar))
                    if len(slot) < k:
                        slot.append(entry)
                        admitted = True
                    else:
                        jmin = min(range(len(slot)),
                                   key=lambda j: slot[j][0])
                        if v > slot[jmin][0]:
                            slot[jmin] = entry
                            admitted = True
        if admitted:
            # outside the lock: log_event takes the sink lock, and the
            # two must never nest
            _emit_exemplar_event(self.name, v, exemplar)

    def exemplars(self):
        """``{bucket_index: (value, unix_t, labels)}`` — the single
        best (largest) exemplar per occupied bucket, for the
        OpenMetrics exporter."""
        with self._lock:
            return {i: max(slot, key=lambda e: e[0])
                    for i, slot in self._exemplars.items() if slot}

    def percentile(self, p):
        """Estimated p-quantile (0..1) from the bucket counts: the
        upper bound of the bucket where the cumulative count crosses
        ``p * count``, clamped to the observed min/max."""
        with self._lock:
            if not self.count:
                return None
            target = p * self.count
            acc = 0
            for i, n in enumerate(self._buckets):
                acc += n
                if acc >= target and n:
                    hi = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                          else self.max)
                    if self.min is None or self.max is None or hi is None:
                        return None if hi is None else float(hi)
                    return float(min(max(hi, self.min), self.max))
            return None if self.max is None else float(self.max)

    def snapshot(self):
        with self._lock:
            if not self.count:
                return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6),
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "p50": round(self.percentile(0.50), 6),
            "p95": round(self.percentile(0.95), 6),
        }

    def buckets(self):
        """(upper_bound, cumulative_count) pairs for the Prometheus
        exporter (only buckets up to the last non-empty one, plus
        +Inf)."""
        with self._lock:
            counts = list(self._buckets)
        out, acc = [], 0
        for bound, n in zip(BUCKET_BOUNDS, counts):
            acc += n
            out.append((bound, acc))
        return out

    def state(self):
        """JSON-portable raw state (sparse bucket counts) for
        cross-process pooling: fabric workers publish their
        ``shard_wall_s`` state in the ledger's worker status files, and
        a stealer merges every worker's state (:func:`merge_states`) to
        get the fleet-wide p95 the straggler threshold needs — bucket
        counts add exactly, unlike p95s."""
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "buckets": {str(i): n for i, n in enumerate(self._buckets)
                            if n},
            }

    def merge_state(self, state):
        """Fold one :meth:`state` dict (from another process) into this
        histogram.  Unknown/garbled states are ignored rather than
        poisoning the pool — a steal decision must never crash on a
        half-written status file."""
        try:
            count = int(state["count"])
            if count <= 0:
                return
            buckets = {int(i): int(n)
                       for i, n in (state.get("buckets") or {}).items()}
            smin = (None if state.get("min") is None
                    else float(state["min"]))
            smax = (None if state.get("max") is None
                    else float(state["max"]))
            ssum = float(state.get("sum", 0.0))
            if smin is None or smax is None:
                # count>0 with no extrema (schema drift / stringified
                # payload): fall back to the occupied buckets' bounds
                # so percentile() always has a clamp range
                occupied = [i for i, n in buckets.items()
                            if n and 0 <= i <= len(BUCKET_BOUNDS)]
                if not occupied:
                    return
                smin = BUCKET_BOUNDS[max(min(occupied) - 1, 0)]
                smax = BUCKET_BOUNDS[min(max(occupied),
                                         len(BUCKET_BOUNDS) - 1)]
        except (KeyError, TypeError, ValueError):
            return
        with self._lock:
            self.count += count
            self.sum += ssum
            if self.min is None or smin < self.min:
                self.min = smin
            if self.max is None or smax > self.max:
                self.max = smax
            for i, n in buckets.items():
                if 0 <= i < len(self._buckets):
                    self._buckets[i] += n


class Window:
    """Sliding-time-window series: a bounded ring buffer of
    ``(t, value)`` samples answering "p50/p95/rate over the last N
    seconds" — the SLO view a process-lifetime histogram cannot give
    (an always-on server's lifetime p95 hides the last minute's
    regression).  Percentiles are EXACT over the in-window samples
    (nearest-rank), not bucket estimates; the ring bound
    (``maxlen``) caps memory, so under sustained load the window may
    effectively shrink below ``window_s`` — honest for an SLO view,
    which cares about the most recent samples anyway."""

    DEFAULT_WINDOW_S = 60.0

    __slots__ = ("name", "_lock", "_buf", "total", "_ex")

    def __init__(self, name, maxlen=4096):
        self.name = name
        self._lock = threading.Lock()
        self._buf = deque(maxlen=int(maxlen))  # raft-lint: guarded-by=self._lock
        self.total = 0  # lifetime count  # raft-lint: guarded-by=self._lock
        # exemplar'd samples (t, value, labels): bounded ring; pruned
        # to the window on read, ranked on demand by tail_exemplars()
        self._ex = deque(maxlen=256)  # raft-lint: guarded-by=self._lock

    def observe(self, v, t=None, exemplar=None):
        t = time.perf_counter() if t is None else float(t)
        with self._lock:
            self._buf.append((t, float(v)))
            self.total += 1
            if exemplar is not None:
                k, vmin = _exemplar_limits()
                if k > 0 and float(v) >= vmin:
                    self._ex.append((t, float(v), dict(exemplar)))

    def tail_exemplars(self, k=None, window_s=None, now=None):
        """The K largest exemplar'd in-window samples, worst first, as
        ``(value, labels)`` — "the actual p99 request of the last
        minute", live (the :class:`Histogram` exemplars answer the same
        question over the process lifetime).  Does NOT emit
        ``exemplar_recorded`` (the paired histogram observation already
        did; double events would double-join in ``report --tail``)."""
        window_s = self.DEFAULT_WINDOW_S if window_s is None else window_s
        now = time.perf_counter() if now is None else float(now)
        if k is None:
            k = _exemplar_limits()[0]
        with self._lock:
            live = [(v, labels) for t, v, labels in self._ex
                    if now - t <= window_s]
        return sorted(live, key=lambda e: -e[0])[:max(k, 0)]

    def values(self, window_s=None, now=None):
        """In-window sample values, oldest first."""
        window_s = self.DEFAULT_WINDOW_S if window_s is None else window_s
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            return [v for t, v in self._buf if now - t <= window_s]

    @staticmethod
    def _nearest_rank(sorted_vals, p):
        i = min(len(sorted_vals) - 1,
                max(0, round(p * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def percentile(self, p, window_s=None, now=None):
        """Exact nearest-rank p-quantile (0..1) over the window, or
        None when the window holds no samples."""
        vals = sorted(self.values(window_s, now))
        return self._nearest_rank(vals, p) if vals else None

    def snapshot(self, window_s=None, now=None):
        window_s = self.DEFAULT_WINDOW_S if window_s is None else window_s
        vals = sorted(self.values(window_s, now))
        if not vals:
            return {"count": 0, "window_s": window_s, "total": self.total}
        return {
            "count": len(vals),
            "window_s": window_s,
            "total": self.total,
            "rate_per_s": round(len(vals) / window_s, 4),
            "p50": round(self._nearest_rank(vals, 0.50), 6),
            "p95": round(self._nearest_rank(vals, 0.95), 6),
            "max": round(vals[-1], 6),
        }


_REGISTRY_LOCK = threading.Lock()
_REGISTRY: dict[str, object] = {}  # raft-lint: guarded-by=_REGISTRY_LOCK


def _get(name, cls):
    with _REGISTRY_LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m


def counter(name) -> Counter:
    return _get(name, Counter)


def gauge(name) -> Gauge:
    return _get(name, Gauge)


def histogram(name) -> Histogram:
    return _get(name, Histogram)


def window(name) -> Window:
    return _get(name, Window)


def sample_windows(window_s=None):
    """``{name: snapshot}`` of every registered window — the heartbeat
    embeds this in each ``heartbeat`` event's ``windows`` payload so a
    capture shows the sliding p50/p95/rate view over time."""
    with _REGISTRY_LOCK:
        items = [(n, m) for n, m in sorted(_REGISTRY.items())
                 if isinstance(m, Window)]
    return {n: m.snapshot(window_s) for n, m in items}


def merge_states(states, name="merged"):
    """Pool several :meth:`Histogram.state` dicts into one fresh
    (unregistered) histogram — the fabric's fleet-wide ``shard_wall_s``
    view.  Returns the pooled :class:`Histogram` (query ``.count`` /
    ``.percentile``)."""
    h = Histogram(name)
    for s in states:
        if s:
            h.merge_state(s)
    return h


def reset():
    """Drop every registered metric (tests; also lets one process run
    independent sweeps with per-sweep snapshots)."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()


def snapshot():
    """JSON-ready snapshot of the whole registry, grouped by metric
    kind.  This is what lands in ``metrics.json``, the sweep manifest
    and the bench breakdown."""
    with _REGISTRY_LOCK:
        items = sorted(_REGISTRY.items())
    out = {"uptime_s": round(time.perf_counter() - _T0, 3),
           "counters": {}, "gauges": {}, "histograms": {}, "windows": {}}
    for name, m in items:
        kind = {Counter: "counters", Gauge: "gauges",
                Histogram: "histograms", Window: "windows"}[type(m)]
        out[kind][name] = m.snapshot()
    if not out["windows"]:
        del out["windows"]  # snapshot schema unchanged for non-serving
    return out


def _prom_name(name):
    return "raft_tpu_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in name)


def _escape_label(v):
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _exemplar_suffix(exemplar):
    """OpenMetrics exemplar clause for one bucket line:
    ``# {trace_id="..",span_id=".."} <value> <unix_ts>``."""
    v, unix_t, labels = exemplar
    body = ",".join(f'{k}="{_escape_label(val)}"'
                    for k, val in sorted(labels.items()))
    return f"# {{{body}}} {v:.6g} {unix_t:.3f}"


def to_prometheus():
    """Render the registry in the Prometheus text exposition format
    (counters/gauges as single samples, histograms as the standard
    ``_bucket``/``_sum``/``_count`` family, with OpenMetrics exemplar
    clauses on the buckets that hold one)."""
    with _REGISTRY_LOCK:
        items = sorted(_REGISTRY.items())
    lines = []
    for name, m in items:
        pn = _prom_name(name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {m.value}")
        elif isinstance(m, Gauge):
            if m.value is None:
                continue
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {m.value}")
            lines.append(f"{pn}_max {m.max}")
        elif isinstance(m, Window):
            snap = m.snapshot()
            if not snap["count"]:
                continue
            lines.append(f"# TYPE {pn} gauge")
            for k in ("p50", "p95", "max", "count", "rate_per_s"):
                lines.append(f"{pn}_{k} {snap[k]}")
        else:
            lines.append(f"# TYPE {pn} histogram")
            last_nonzero = 0
            pairs = m.buckets()
            ex = m.exemplars()
            for i, (_, acc) in enumerate(pairs):
                if acc != (pairs[i - 1][1] if i else 0):
                    last_nonzero = i
            for i, (bound, acc) in enumerate(pairs[: last_nonzero + 1]):
                line = f'{pn}_bucket{{le="{bound:.6g}"}} {acc}'
                if i in ex:
                    line += f" {_exemplar_suffix(ex[i])}"
                lines.append(line)
            line = f'{pn}_bucket{{le="+Inf"}} {m.count}'
            if len(BUCKET_BOUNDS) in ex:  # overflow-bucket exemplar
                line += f" {_exemplar_suffix(ex[len(BUCKET_BOUNDS)])}"
            lines.append(line)
            lines.append(f"{pn}_sum {m.sum}")
            lines.append(f"{pn}_count {m.count}")
    return "\n".join(lines) + "\n"


def export(path):
    """Write :func:`to_prometheus` to ``path`` (best-effort: exporting
    metrics must never take down the run that produced them).

    Atomic tmp + ``os.replace``: the export path is re-written at every
    sweep_done / serve drain while scrapers and ``obs runs`` readers
    may be mid-read — a plain truncate-and-write would hand them half
    an exposition (the ``atomic-write`` concurrency-lint class)."""
    import os
    import tempfile

    try:
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(to_prometheus())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except OSError:
        return False

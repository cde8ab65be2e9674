"""Hierarchical telemetry spans over the structured-log stream (the
port's copy of ``raft_tpu/obs/spans.py``).

A span is a timed region of host-side work — a driver run, one statics
solve, one sweep shard, one retry attempt, one escalation rung.  Spans
emit paired ``span_begin``/``span_end`` JSONL events carrying
``trace_id`` (shared by a whole nested tree), ``span_id`` and the
parent's id, propagated through a :mod:`contextvars` variable so
nesting works across function boundaries (and stays correctly scoped
per thread/async task).  Every other ``log_event`` fired inside a span
automatically carries the enclosing trace/span ids, which is what lets
a report over the stream (the reference's ``python -m raft_tpu.obs
report``) attribute a ``shard_retry`` to the
shard (and sweep) it happened in.

Overhead discipline: with ``RAFT_TPU_LOG`` unset, a span is a sink
check, a clock read and one histogram observe (a few microseconds) —
no ids are generated, no contextvar is touched, nothing is emitted;
the ``span_<name>_s`` wall-time histograms stay on either way, so a
Prometheus scrape (``RAFT_TPU_METRICS``) carries per-stage timings
even when the event stream is off.  All instrumentation is host-side
only: a span launches nothing on the device.

Device-trace alignment: when ``RAFT_TPU_PROFILE`` is set, each span
also enters a ``torch.profiler.record_function`` of the same name, so
the host span shows up on the profiler timeline next to the kernels it
launched.
"""

from __future__ import annotations

import re
import time
import uuid

from raft_tpu_torch.obs import flight, metrics
from raft_tpu_torch.utils import config, structlog


def _new_id():
    return uuid.uuid4().hex[:16]


def current_ids():
    """(trace_id, span_id) of the innermost active span, or None."""
    return structlog.SPAN_CTX.get()


# ------------------------------------------------- cross-process propagation

#: W3C trace-context `traceparent`: version "00", 32-hex trace id,
#: 16-hex parent span id, 2-hex flags.  Lenient on trace-id length
#: (internal ids are 16 hex; foreign tracers send 32).
_TRACEPARENT_RE = re.compile(
    r"^\s*([0-9a-f]{2})-([0-9a-f]{16,32})-([0-9a-f]{16})-([0-9a-f]{2})\s*$")


def parse_traceparent(header):
    """``(trace_id, parent_span_id)`` from one ``traceparent`` header
    (or the ``RAFT_TPU_TRACEPARENT`` env value), else None.  The trace
    id keeps whatever meaningful hex the sender used (leading zero
    padding from :func:`format_traceparent` is stripped back off so a
    round trip is identity for internal 16-hex ids)."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.lower())
    if not m:
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None  # all-zero ids are "no trace" per the W3C spec
    stripped = trace_id.lstrip("0")
    if len(trace_id) == 32 and len(stripped) <= 16:
        trace_id = stripped.rjust(16, "0")
    return trace_id, span_id


def format_traceparent(trace_id=None, span_id=None):
    """The ``traceparent`` header/env value for (trace_id, span_id) —
    default: the innermost active span of this task/thread.  None when
    there is no active span (nothing to propagate)."""
    if trace_id is None or span_id is None:
        ctx = structlog.SPAN_CTX.get()
        if ctx is None:
            return None
        trace_id, span_id = ctx
    return f"00-{str(trace_id).rjust(32, '0')}-{str(span_id).rjust(16, '0')}-01"


def remote_context():
    """The trace context inherited from a parent process
    (``RAFT_TPU_TRACEPARENT``), parsed, or None.  A process's first
    root span joins this trace instead of minting a fresh trace_id —
    which is what stitches fabric workers (and anything else spawned
    with :func:`propagation_env`) into the coordinator's timeline."""
    return parse_traceparent(config.raw("TRACEPARENT"))


def ambient_ids():
    """(trace_id, span_id-or-parent) for stamping cross-process
    records (fabric lease/done files): the active span's ids when
    inside one, else the inherited remote context, else None."""
    ctx = structlog.SPAN_CTX.get()
    if ctx is not None:
        return ctx
    return remote_context()


def propagation_env():
    """Env vars that stitch a child process into this one's telemetry:
    always the run id (a worker minting its own uuid is exactly the
    split-timeline bug this exists to prevent), plus the traceparent
    when called inside an active span."""
    env = {config.env_name("RUN_ID"): structlog.run_id()}
    tp = format_traceparent()
    if tp is None:
        # no active span (e.g. logging off in the parent): still
        # forward any context *we* inherited, so a grandchild chains
        tp = config.raw("TRACEPARENT") or None
    if tp:
        env[config.env_name("TRACEPARENT")] = tp
    return env


class span:
    """Context manager for one telemetry span::

        with obs.span("shard", shard=3, rows=256):
            ...

    Emits ``span_begin``/``span_end`` (the latter with ``wall_s``,
    ``ok`` and a truncated ``error`` on failure) and observes the wall
    time into the ``span_<name>_s`` histogram of the metrics registry.
    Exceptions always propagate."""

    __slots__ = ("name", "attrs", "trace_id", "span_id",
                 "_token", "_t0", "_ann", "_remote")

    def __init__(self, name, remote=None, **attrs):
        """``remote=(trace_id, parent_span_id)`` adopts an explicit
        cross-process parent (e.g. a parsed HTTP ``traceparent``) for a
        ROOT span; a nested span always keeps its in-process parent.
        With no explicit remote, a root span consults
        ``RAFT_TPU_TRACEPARENT`` (:func:`remote_context`)."""
        self.name = name
        self.attrs = attrs
        self.trace_id = None
        self.span_id = None
        self._token = None
        self._t0 = None
        self._ann = None
        self._remote = remote

    def __enter__(self):
        if config.raw("PROFILE"):
            # mirror the span onto the torch profiler timeline; must
            # not be able to break the instrumented computation
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        if not structlog.enabled():
            # fast path: no ids, no contextvar, no event — the flight
            # ring still records the begin (ids are synthesized at
            # dump time from the per-thread nesting order)
            flight.capture_span_begin(self.name, self.attrs)
            return self
        parent = structlog.SPAN_CTX.get()
        kw = {}
        if parent is None:
            # root span: adopt a cross-process parent — an explicit one
            # (HTTP traceparent) first, else the env-inherited context a
            # coordinator pinned into this process (fabric workers) —
            # so the whole fleet shares ONE trace instead of N
            remote = self._remote or remote_context()
            if remote is not None:
                parent = remote
                kw["remote_parent"] = True
        self.trace_id = parent[0] if parent else _new_id()
        self.span_id = _new_id()
        self._token = structlog.SPAN_CTX.set((self.trace_id, self.span_id))
        structlog.log_event(
            "span_begin", name=self.name,
            parent_id=parent[1] if parent else None, **kw, **self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        # the wall-time histogram feeds unconditionally (metrics exist
        # without the event stream); events only when the sink is live.
        # With live ids the observation carries an exemplar, so a
        # /metrics scrape can name the actual slowest span instance.
        if self.span_id is not None:
            metrics.histogram(f"span_{self.name}_s").observe(
                wall, exemplar={"trace_id": self.trace_id,
                                "span_id": self.span_id})
        else:
            metrics.histogram(f"span_{self.name}_s").observe(wall)
            flight.capture_span_end(self.name, wall, exc_type is None)
        if self._token is not None:
            kw = {}
            if exc_type is not None:
                kw["error"] = repr(exc)[:200]
            structlog.log_event(
                "span_end", name=self.name, wall_s=round(wall, 6),
                ok=exc_type is None, **kw)
            structlog.SPAN_CTX.reset(self._token)
            self._token = None
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
            self._ann = None
        return False

"""Structured (JSONL) event logging for long-running analyses (the
port's copy of ``raft_tpu/utils/structlog.py``, record for record: one
stream format for both packages).

Every analysis stage can emit machine-readable events — stage name,
wall time, convergence diagnostics — as one JSON object per line.

Off by default (zero overhead beyond an env check).  Enable with

    RAFT_TPU_LOG=-            # JSONL to stderr
    RAFT_TPU_LOG=/path/f.jsonl  # JSONL appended to a file

Every record carries a monotonic ``t`` (seconds since process start),
an ``event`` name, the emitting ``pid`` and the process ``run_id``
(``RAFT_TPU_RUN_ID``, else a fresh uuid per process — pin it to keep a
resumed sweep's events linkable to the original run); records emitted
inside an :func:`raft_tpu_torch.obs.span` additionally carry ``trace_id``/
``span_id``, so free-form events nest under the span that produced
them.  Everything else is free-form numeric/str payload.

The sink is shared by the main thread and the telemetry threads
(heartbeat sampler, :mod:`raft_tpu_torch.obs.heartbeat`), so writes are
serialized by a lock — interleaved half-lines would corrupt the JSONL
stream for every downstream consumer (the reference's ``python -m
raft_tpu.obs report``/``trace`` read the port's streams unchanged).

Event *names* are the reference's (its registry,
``raft_tpu/obs/events.py``): a typo'd name silently splits an event
stream, which is worse than a crash.
"""

from __future__ import annotations

import atexit
import contextvars
import json
import os
import sys
import threading
import time
import uuid

from raft_tpu_torch.utils import config

_T0 = time.perf_counter()
_SINK = None  # raft-lint: guarded-by=_LOCK
_DEST = None  # raft-lint: guarded-by=_LOCK
# RLock: log_event re-resolves the sink while holding the lock (the
# handle must not be swapped/closed between resolution and write by a
# concurrent retarget), and _sink() itself locks the swap
_LOCK = threading.RLock()
_RUN_ID = None  # raft-lint: guarded-by=_LOCK

#: (trace_id, span_id) of the innermost active telemetry span in this
#: task/thread; managed by :class:`raft_tpu_torch.obs.spans.span`.
SPAN_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "raft_tpu_span_ctx", default=None)

#: Flight-recorder tap (:mod:`raft_tpu_torch.obs.flight` installs itself here
#: at import).  Called as ``tap(event, payload)`` for EVERY log_event —
#: before the sink check, so the black-box ring keeps recording when
#: logging is off.  structlog deliberately does not import flight (the
#: dependency points the other way); the slot keeps this module
#: importable standalone.
_FLIGHT_TAP = None


def set_flight_tap(fn):
    """Install (or clear, with None) the flight-recorder tap."""
    global _FLIGHT_TAP
    _FLIGHT_TAP = fn


def run_id():
    """The telemetry run id stamped on every record: ``RAFT_TPU_RUN_ID``
    when set (re-read per call so a resuming orchestrator can pin it),
    else one fresh uuid12 per process."""
    rid = config.raw("RUN_ID")
    if rid:
        return rid
    global _RUN_ID
    if _RUN_ID is None:
        # locked: the heartbeat thread's first beat can race the main
        # thread's first event — one process must get ONE run id
        with _LOCK:
            if _RUN_ID is None:
                _RUN_ID = uuid.uuid4().hex[:12]
    return _RUN_ID


def _sink_path(dest):
    """The actual file path for a non-stderr dest: a directory (an
    existing one, or any path spelled with a trailing separator) holds
    one ``trace-<pid>.jsonl`` shard PER PROCESS — the cross-process
    capture layout `python -m raft_tpu.obs trace --merge` assembles
    (fabric coordinator + workers + server each own their shard, no
    cross-process write interleaving)."""
    if dest.endswith(os.sep) or dest.endswith("/") or os.path.isdir(dest):
        os.makedirs(dest, exist_ok=True)
        return os.path.join(dest, f"trace-{os.getpid()}.jsonl")
    return dest


def _sink():
    """Resolve the sink from RAFT_TPU_LOG, re-reading the env var on
    every call so setting/changing/unsetting it mid-process takes
    effect (file handles are swapped and closed at interpreter exit).
    The unset fast path is one dict lookup."""
    global _SINK, _DEST
    dest = config.raw("LOG") or ""
    if dest != _DEST:
        with _LOCK:
            if dest != _DEST:
                if _SINK is not None and _SINK is not sys.stderr:
                    try:
                        _SINK.close()
                    except Exception:
                        pass
                if dest == "-":
                    _SINK = sys.stderr
                elif dest:
                    _SINK = open(_sink_path(dest), "a")
                    atexit.register(_SINK.close)
                else:
                    _SINK = None
                _DEST = dest
    return _SINK


def enabled():
    return _sink() is not None


#: dests this process has written its clock anchor to (the merge
#: tooling needs one ``proc_start`` per (process, sink) to map the
#: monotonic ``t`` column onto a shared wall clock)
_ANCHORED: set = set()  # raft-lint: guarded-by=_LOCK


def _anchor_record():
    """The clock-anchor record: ``unix_t`` is the wall-clock time at
    which this record's monotonic ``t`` was read, so a merge can
    normalize every process's ``t`` onto one timeline
    (``wall = unix_t + (t - t_anchor)``)."""
    now = time.perf_counter() - _T0
    rec = {"t": round(now, 6), "event": "proc_start",
           "pid": os.getpid(), "run_id": run_id(),
           "unix_t": round(time.time(), 6),
           "argv0": os.path.basename(sys.argv[0] or "python")}
    wid = config.raw("WORKER_ID")
    if wid:
        rec["worker"] = wid
    return rec


def log_event(event, **payload):
    """Emit one JSONL event (no-op unless RAFT_TPU_LOG is set; the
    flight-recorder ring captures it either way)."""
    tap = _FLIGHT_TAP
    if tap is not None:
        tap(event, payload)
    s = _sink()
    if s is None:
        return
    rec = {"t": round(time.perf_counter() - _T0, 6), "event": event,
           "pid": os.getpid(), "run_id": run_id()}
    # fabric worker stamp: one shared RAFT_TPU_LOG capture holds every
    # worker's stream; the per-record worker id keeps them separable
    # (per-worker tables in `python -m raft_tpu.obs report`)
    wid = config.raw("WORKER_ID")
    if wid:
        rec["worker"] = wid
    ctx = SPAN_CTX.get()
    if ctx is not None:
        rec["trace_id"], rec["span_id"] = ctx
    for k, v in payload.items():
        if hasattr(v, "item"):
            try:
                v = v.item()
            except Exception:
                v = str(v)
        rec[k] = v
    # default=str: a non-JSON-serializable payload value (Path, dtype,
    # exception, device object) must never take down the analysis that
    # was merely trying to log it
    line = json.dumps(rec, default=str) + "\n"
    # one lock around resolve+write+flush: the heartbeat thread shares
    # the sink, and a concurrent RAFT_TPU_LOG retarget closes the old
    # handle — re-resolving under the lock keeps the write off a handle
    # another thread just closed
    with _LOCK:
        s = _sink()
        if s is None:
            return
        if _DEST not in _ANCHORED:
            # first record to this sink: lead with the clock anchor so
            # the merge tooling can place this process on a shared
            # wall-clock timeline
            _ANCHORED.add(_DEST)
            s.write(json.dumps(_anchor_record(), default=str) + "\n")
        s.write(line)
        s.flush()


class stage:
    """Context manager timing one analysis stage:

    with stage("solve_dynamics", case=2): ...
    emits {"event": "solve_dynamics", "wall_s": ..., **kw} on exit;
    a failing stage carries ok=False plus a truncated error=repr(exc).

    Prefer :func:`raft_tpu_torch.obs.span` for new instrumentation — spans
    add trace/parent linkage and feed the metrics registry; ``stage``
    stays for flat one-shot timings and backward compatibility."""

    def __init__(self, name, **kw):
        self.name = name
        self.kw = kw

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if enabled():
            kw = dict(self.kw)
            if exc[0] is not None:
                kw["error"] = repr(exc[1])[:200]
            log_event(self.name, wall_s=round(time.perf_counter() - self.t0, 6),
                      ok=exc[0] is None, **kw)
        return False

"""Black-box flight recorder: always-on, fixed-memory postmortem ring
(the port's copy of ``raft_tpu/obs/flight.py``; its shards are the
reference's format).

The observability stack so far is *opt-in*: with ``RAFT_TPU_LOG`` unset
a crashed replica leaves no trace to merge, and a SIGKILL leaves
nothing at all.  This module keeps the last N span/event records of
every process in a bounded in-memory ring — a deque append per record,
cheap enough to stay on unconditionally — and persists them as
schema-versioned JSONL shards that ``python -m raft_tpu.obs trace
--merge`` assembles onto the same wall-clock timeline as live
``RAFT_TPU_LOG`` shards (the dump leads with its own ``proc_start``
clock anchor).

Capture sources (no JSON, no id minting, no contextvar mutation on the
hot path — the zero-overhead span contract in :mod:`raft_tpu_torch.obs.spans`
holds with the recorder on):

* every :func:`raft_tpu_torch.utils.structlog.log_event` call, *before* the
  sink check — events are captured even when logging is off;
* span begin/end on the logging-off fast path (:class:`raft_tpu_torch.obs.
  spans.span` calls :func:`capture_span_begin`/:func:`capture_span_end`
  directly) — trace/span/parent ids are synthesized **at dump time**
  from per-thread nesting stacks, deterministically (derived from the
  record's own clock reading), so repeated dumps of one ring agree and
  a merged dump contributes 0 orphan spans by construction;
* periodic metric-snapshot deltas (``RAFT_TPU_FLIGHT_SNAP_S``): the
  counter movement since the previous snapshot rides in the ring as
  ``flight_metrics`` records, so a postmortem shows *rates*, not just
  the final totals.

Dump triggers: ``alert_fire`` (the alert engine names the triggering
rule in the filename), SEVERE-status quarantine, a compile-budget
breach, an unhandled exception / SIGTERM at exit, on demand via the
loopback-gated ``GET /debug/flight`` and ``python -m raft_tpu.obs
flight dump`` — plus a periodic background flush to a stable
``flight-<pid>.jsonl`` (``RAFT_TPU_FLIGHT_FLUSH_S``) so even an
uncatchable SIGKILL leaves the last flush interval's worth of history.
All shard writes route through the :mod:`raft_tpu_torch.utils.fsops` seam
(tmp + atomic replace): a scraper or merge never reads a torn shard.

Merge discipline: merge at most ONE flight shard per process next to
the live shards.  Span records a dump shares with a live shard carry
the same ids, so ``collect_spans`` collapses them; two *differently
triggered* dumps of the same ring would duplicate instant events.

Pure stdlib, no torch import.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.utils import config, fsops, structlog

#: bumped when the dump-shard layout changes; readers refuse shards
#: from a NEWER writer (``flight show`` exits 1) instead of guessing
SCHEMA_VERSION = 1


class FlightError(ValueError):
    """A flight shard failed strict validation (truncated/damaged/
    newer schema)."""


# ring state: None = not yet configured, False = disabled
# (RAFT_TPU_FLIGHT_RING=0), else the deque.  deque.append is
# GIL-atomic, so the capture hot path takes no lock.
_RING = None  # raft-lint: guarded-by=_STATE_LOCK
_STATE_LOCK = threading.Lock()
_N_CAPTURED = [0]          # approximate (unlocked += is fine for a gauge)
_NEXT_SNAP = [float("inf")]  # raft-lint: guarded-by=_STATE_LOCK
_LAST_COUNTERS: dict = {}  # raft-lint: guarded-by=_STATE_LOCK
_FLUSHER = [None]  # raft-lint: guarded-by=_STATE_LOCK
_HOOKS_INSTALLED = [False]  # raft-lint: guarded-by=_STATE_LOCK


def _configure():
    """First-capture lazy init: size the ring from RAFT_TPU_FLIGHT_RING
    and arm the periodic machinery.  Cached — tests changing the flags
    mid-process call :func:`reset`."""
    global _RING
    with _STATE_LOCK:
        if _RING is not None:
            return _RING
        try:
            n = int(config.get("FLIGHT_RING"))
        except ValueError:
            n = 0
        if n <= 0:
            _RING = False
            return _RING
        _RING = deque(maxlen=n)
        _NEXT_SNAP[0] = time.perf_counter()
    maybe_start()
    return _RING


def reset():
    """Drop the ring and re-read the flags on next capture (tests)."""
    global _RING
    with _STATE_LOCK:
        _RING = None
        _N_CAPTURED[0] = 0
        _NEXT_SNAP[0] = float("inf")
        _LAST_COUNTERS.clear()


def ring_records():
    """Current ring contents (raw tuples, oldest first) — tests."""
    ring = _RING
    return list(ring) if ring else []


# ------------------------------------------------------------ capture

def capture_event(event, payload):
    """Ring-append one structured-log event (the :func:`structlog.
    log_event` tap — fires whether or not a sink is live)."""
    ring = _RING
    if ring is None:
        ring = _configure()
    if ring is False:
        return
    now = time.perf_counter()
    ring.append(("ev", now, event, structlog.SPAN_CTX.get(), payload))
    _N_CAPTURED[0] += 1
    if now >= _NEXT_SNAP[0]:
        _snap_metrics(now)


def capture_span_begin(name, attrs):
    """Ring-append a fast-path (logging-off) span begin.  No ids — the
    dump synthesizes them from the per-thread nesting order."""
    ring = _RING
    if ring is None:
        ring = _configure()
    if ring is False:
        return
    now = time.perf_counter()
    ring.append(("sb", now, name, threading.get_ident(),
                 attrs if attrs else None))
    _N_CAPTURED[0] += 1
    if now >= _NEXT_SNAP[0]:
        _snap_metrics(now)


def capture_span_end(name, wall_s, ok):
    """Ring-append a fast-path (logging-off) span end."""
    ring = _RING
    if ring is None:
        ring = _configure()
    if ring is False:
        return
    now = time.perf_counter()
    ring.append(("se", now, name, threading.get_ident(), wall_s, ok))
    _N_CAPTURED[0] += 1
    if now >= _NEXT_SNAP[0]:
        _snap_metrics(now)


def _snap_metrics(now):
    """Append the counter movement since the last snapshot as one
    ``flight_metrics`` ring record (rate context for a postmortem).
    Runs at most once per RAFT_TPU_FLIGHT_SNAP_S; the odd hot-path
    caller that lands on the boundary pays ~a registry snapshot."""
    with _STATE_LOCK:
        if now < _NEXT_SNAP[0]:
            return
        try:
            period = max(0.5, float(config.get("FLIGHT_SNAP_S")))
        except ValueError:
            period = 10.0
        _NEXT_SNAP[0] = now + period
        counters = metrics.snapshot().get("counters") or {}
        delta = {k: v - _LAST_COUNTERS.get(k, 0)
                 for k, v in counters.items()
                 if v != _LAST_COUNTERS.get(k, 0)}
        _LAST_COUNTERS.clear()
        _LAST_COUNTERS.update(counters)
        ring = _RING
    if ring and delta:
        ring.append(("mx", now, delta))


# ------------------------------------------------------------ serialize

def _synth_id(t, tid):
    """Deterministic synthesized span id for a fast-path record: the
    record's own nanosecond clock reading + thread tag.  Two dumps of
    one ring mint identical ids, so overlapping shards collapse in
    ``collect_spans`` instead of double-counting."""
    return f"fl{int(t * 1e9) & 0xFFFFFFFFFFFF:012x}{tid & 0xFF:02x}"


def _header_record(trigger, n_records):
    """The dump shard's first line: a ``proc_start`` clock anchor (so
    ``obs trace --merge`` places the shard on the shared wall-clock
    timeline) carrying the flight metadata block — the ``flight-dump``
    record family of the reference's ``raft_tpu/analysis/schemas.py``."""
    ring = _RING
    rec = {
        "t": round(time.perf_counter() - structlog._T0, 6),
        "event": "proc_start",
        "pid": os.getpid(),
        "run_id": structlog.run_id(),
        "unix_t": round(time.time(), 6),
        "argv0": os.path.basename(sys.argv[0] or "python"),
        "flight": {
            "version": SCHEMA_VERSION,
            "trigger": str(trigger),
            "ring": (ring.maxlen if ring else 0),
            "records": n_records,
            "captured": _N_CAPTURED[0],
        },
    }
    wid = config.raw("WORKER_ID")
    if wid:
        rec["worker"] = wid
    return rec


def serialize_records(trigger="manual"):
    """The ring as JSON-ready record dicts, header first, on the same
    monotonic ``t`` scale as the live ``RAFT_TPU_LOG`` shards."""
    raw = ring_records()
    t0 = structlog._T0
    base_pid = os.getpid()
    base_rid = structlog.run_id()
    wid = config.raw("WORKER_ID")
    out = [_header_record(trigger, len(raw))]
    stacks: dict = {}  # thread ident -> [(name, span_id, trace_id), ...]
    for item in raw:
        kind = item[0]
        rec = {"t": round(item[1] - t0, 6), "pid": base_pid,
               "run_id": base_rid}
        if wid:
            rec["worker"] = wid
        if kind == "ev":
            _, _t, event, ctx, payload = item
            rec["event"] = event
            if ctx is not None:
                rec["trace_id"], rec["span_id"] = ctx
            if payload:
                for k, v in payload.items():
                    rec[k] = v
        elif kind == "sb":
            _, t, name, tid, attrs = item
            stack = stacks.setdefault(tid, [])
            sid = _synth_id(t, tid)
            trace = stack[-1][2] if stack else sid
            parent = stack[-1][1] if stack else None
            stack.append((name, sid, trace))
            rec.update(event="span_begin", trace_id=trace, span_id=sid,
                       name=name, parent_id=parent)
            if attrs:
                for k, v in attrs.items():
                    rec.setdefault(k, v)
        elif kind == "se":
            _, t, name, tid, wall_s, ok = item
            stack = stacks.get(tid) or []
            sid = trace = None
            for j in range(len(stack) - 1, -1, -1):
                if stack[j][0] == name:
                    _n, sid, trace = stack[j]
                    del stack[j:]
                    break
            rec.update(event="span_end", name=name,
                       wall_s=round(float(wall_s), 6), ok=bool(ok))
            if sid is not None:
                rec["trace_id"], rec["span_id"] = trace, sid
        else:  # "mx"
            _, _t, delta = item
            rec.update({"event": "flight_metrics", "counters": delta})
        out.append(rec)
    return out


def serialize_text(trigger="manual"):
    """The ring as one JSONL string (the ``GET /debug/flight`` body)."""
    return "".join(json.dumps(r, default=str) + "\n"
                   for r in serialize_records(trigger))


# ------------------------------------------------------------ dumps

def _slug(name):
    s = "".join(c if c.isalnum() or c in "-_" else "-"
                for c in str(name).lower())
    return s.strip("-")[:48] or "dump"


def dump_path(trigger="manual", directory=None):
    """Where a dump for ``trigger`` lands: the stable per-process
    ``flight-<pid>.jsonl`` for the periodic flush (latest state wins —
    this is the shard a SIGKILL leaves behind), a trigger-named sibling
    for everything else (an alert dump never clobbers a crash dump)."""
    d = directory if directory is not None else config.raw("FLIGHT_DIR")
    if not d:
        return None
    if trigger == "flush":
        name = f"flight-{os.getpid()}.jsonl"
    else:
        name = f"flight-{os.getpid()}-{_slug(trigger)}.jsonl"
    return os.path.join(d, name)


def dump(trigger="manual", path=None, quiet=False):
    """Atomically persist the ring as one JSONL shard.

    ``path`` overrides the ``RAFT_TPU_FLIGHT_DIR`` layout (the CLI's
    ``-o``).  Returns the written path, or None when there is nowhere
    to write (no dir configured) or nothing recorded.  Best-effort by
    design: a failing dump must never take down the process it is
    trying to explain."""
    if _RING is None:
        _configure()
    if _RING is False:
        return None
    if path is None:
        path = dump_path(trigger)
        if path is None:
            return None
    text = serialize_text(trigger)
    try:
        d = os.path.dirname(path)
        if d:
            fsops.makedirs(d)
        fsops.write_atomic(path, text)
    except OSError:
        return None
    if not quiet:
        structlog.log_event("flight_dump", trigger=str(trigger), path=path,
                            records=max(text.count("\n") - 1, 0))
    return path


# ----------------------------------------------- background persistence

def maybe_start():
    """Arm the periodic flusher + crash hooks when RAFT_TPU_FLIGHT_DIR
    is set (idempotent; called lazily at first capture and explicitly
    by the serve/router/fabric entry points).  Without a dump dir the
    ring still records — ``GET /debug/flight`` and ``obs flight dump
    -o`` remain available."""
    if not config.raw("FLIGHT_DIR"):
        return False
    with _STATE_LOCK:
        if not _HOOKS_INSTALLED[0]:
            _HOOKS_INSTALLED[0] = True
            _install_crash_hooks()
        if _FLUSHER[0] is None or not _FLUSHER[0].is_alive():
            t = threading.Thread(target=_flush_loop, daemon=True,
                                 name="raft-flight-flush")
            _FLUSHER[0] = t
            t.start()
    return True


def _flush_loop():
    while True:
        try:
            period = max(0.2, float(config.get("FLIGHT_FLUSH_S")))
        except ValueError:
            period = 2.0
        time.sleep(period)
        try:
            if config.raw("FLIGHT_DIR"):
                dump(trigger="flush", quiet=True)
        except Exception:  # noqa: BLE001 — the flusher must survive
            pass


def _install_crash_hooks():
    """Unhandled-exception + SIGTERM + exit dumps.  SIGKILL is
    uncatchable by definition — that case is covered by the periodic
    flush shard, which is the whole reason it exists."""
    import atexit
    import signal

    prev_hook = sys.excepthook

    def _flight_excepthook(exc_type, exc, tb):
        try:
            dump(trigger=f"crash-{exc_type.__name__}", quiet=True)
        except Exception:  # noqa: BLE001
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _flight_excepthook
    atexit.register(lambda: dump(trigger="flush", quiet=True))
    try:
        if (threading.current_thread() is threading.main_thread()
                and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL):
            def _on_term(signum, frame):
                dump(trigger="sigterm", quiet=True)
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # non-main thread / exotic platform: exception+exit only


# ------------------------------------------------------------ readers

def read_shard(path):
    """Strictly parse one dump shard; returns ``(header, records)``.

    Unlike the reference's ``report.read_events`` (which tolerates
    damaged lines), a *flight shard* is written atomically — any
    unparseable line, missing stamp or absent/newer header means the
    artifact is not trustworthy, and trusting a damaged postmortem is
    worse than having none.  Raises :class:`FlightError`."""
    try:
        text = fsops.read_text(path)
    except OSError as e:
        raise FlightError(f"{path}: unreadable ({e})")
    records = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            raise FlightError(f"{path}: blank line {i + 1}")
        try:
            rec = json.loads(line)
        except ValueError:
            raise FlightError(f"{path}: line {i + 1} unparseable "
                              "(truncated dump?)")
        if not isinstance(rec, dict) or "event" not in rec \
                or "t" not in rec or "pid" not in rec:
            raise FlightError(f"{path}: line {i + 1} missing the "
                              "t/event/pid stamps")
        records.append(rec)
    if not records:
        raise FlightError(f"{path}: empty shard")
    hdr = records[0]
    meta = hdr.get("flight")
    if hdr["event"] != "proc_start" or not isinstance(meta, dict):
        raise FlightError(
            f"{path}: first record is not a flight proc_start anchor")
    if "unix_t" not in hdr:
        raise FlightError(f"{path}: anchor has no unix_t (unmergeable)")
    try:
        version = int(meta["version"])
        trigger = str(meta["trigger"])
        ring = int(meta["ring"])
    except (KeyError, TypeError, ValueError):
        raise FlightError(f"{path}: flight header missing "
                          "version/trigger/ring")
    if version > SCHEMA_VERSION:
        raise FlightError(
            f"{path}: schema v{version} is newer than this reader "
            f"(v{SCHEMA_VERSION})")
    del trigger, ring
    return hdr, records


def show(path, out=None):
    """Human summary of one dump shard (``obs flight show``); returns
    0, or 1 after printing the validation failure."""
    out = out if out is not None else sys.stdout
    try:
        hdr, records = read_shard(path)
    except FlightError as e:
        print(f"flight show FAILED: {e}", file=sys.stderr)
        return 1
    from raft_tpu_torch.obs import report

    meta = hdr["flight"]
    spans, unmatched = report.collect_spans(records)
    counts: dict = {}
    for r in records[1:]:
        counts[r["event"]] = counts.get(r["event"], 0) + 1
    ts = [r["t"] for r in records]
    print(f"{path}: flight shard v{meta['version']} "
          f"(trigger={meta['trigger']}, ring={meta['ring']})", file=out)
    print(f"  pid {hdr['pid']}, run_id {hdr.get('run_id')}, "
          f"{len(records) - 1} record(s) of {meta.get('captured', '?')} "
          f"captured, window {max(ts) - min(ts):.3f}s", file=out)
    print(f"  spans: {len(spans)} matched, {len(unmatched)} still open "
          "at dump", file=out)
    for name, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"  {name:38s} {n:6d}", file=out)
    return 0


# Self-install: importing the obs package is what turns the recorder
# on (structlog stays import-cycle-free by never importing flight).
structlog.set_flight_tap(capture_event)

"""The continuous-batching core of the evaluation service (the port's
counterpart of ``raft_tpu/serve/batcher.py``).

Socket-free and unit-testable: requests go in through :meth:`Batcher.
submit` (thread-safe, returns a ``concurrent.futures.Future``), pend in
one bounded admission queue, and each tick the dispatcher coalesces
the backlog — deduplicating identical in-flight cases, grouping the
rest by bucket signature so MIXED-TOPOLOGY tenants share one
evaluator call, padding each group to the batch ladder — into the
bucketed evaluators on the batcher's device, then fans the results back
out per request.  The batch dimension is "whichever tenants are
waiting right now", not a precomputed sweep.

The coalescing window is ADAPTIVE by default
(``RAFT_TPU_SERVE_TICK_MODE``): it anchors on the oldest pending
request and scales with the recent per-tick row load between
``RAFT_TPU_SERVE_TICK_MIN_MS`` (near-empty queue — the whole window is
pure tail latency) and the ``RAFT_TPU_SERVE_TICK_MS`` ceiling
(sustained load — bigger batches amortize the wait), and a bucket
group filling a full top ladder rung dispatches early.  The stage
decomposition (queue_wait/tick_wait/dispatch/solve/post) is computed
from the same submit/tick/dispatch marks, so the stages sum to the
measured total by construction whatever the window does.

Error semantics ride in-band: every row carries the int32 solver-health
``status`` word (:mod:`raft_tpu_torch.utils.health`); SEVERE bits
surface in the result payload (the HTTP layer maps them to 422 with
``describe()`` text), and a request may opt into a quarantine-style
``f64_cpu`` re-solve (:func:`raft_tpu_torch.serve.engine.escalate_row`)
— only a HEALTHY re-solve is adopted, as in the sweep quarantine.

Healthy rows land in the content-addressed result cache
(:mod:`raft_tpu_torch.serve.cache`); a submit-time hit resolves the
future without ever queueing.  Between miss and cache insert the case
is IN-FLIGHT: a duplicate submitted while its row is mid-solve joins
the solving tick's requester list (``serve_inflight_joins``) instead
of dispatching the same case again.  Backpressure: per-client token
buckets raise :class:`QuotaExceeded` (→ 429), a full admission queue
raises :class:`QueueFull` (→ 503), a draining service raises
:class:`Draining` (→ 503).

A dispatch that raises is fanned out to every requester of its group
(``serve_error``, HTTP 500); nothing retries it elsewhere.  With
``group_log`` set, the batcher keeps its last dispatched groups (the
entries, sea states, padded size, outputs and kernel launches of
each), so a caller can hold every served row against a direct
evaluator call on the same padded group.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading
import time
from collections import deque

import numpy as np

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import span
from raft_tpu_torch.serve import engine
from raft_tpu_torch.serve.cache import ResultCache, result_cache_key
from raft_tpu_torch.structure import bucketing
from raft_tpu_torch.serve.quota import ClientQuotas
from raft_tpu_torch.utils import config, health, structlog
from raft_tpu_torch.utils.structlog import log_event


class RejectError(RuntimeError):
    """A request refused at admission (never queued)."""

    reason = "rejected"
    http_status = 503


class QuotaExceeded(RejectError):
    """Per-client token bucket dry — this client should slow down."""

    reason = "quota"
    http_status = 429

    def __init__(self, retry_after_s=0.0):
        super().__init__("client quota exceeded")
        self.retry_after_s = retry_after_s


class QueueFull(RejectError):
    """Admission queue at its bound — every client should back off."""

    reason = "queue_full"


class Draining(RejectError):
    """The service is draining (SIGTERM): in-flight work finishes, new
    work is refused."""

    reason = "draining"


class _Request:
    __slots__ = ("entry", "Hs", "Tp", "beta", "out_keys", "escalate_f64",
                 "client", "future", "t_submit", "cache_key", "trace_ctx",
                 "t_marks")

    def __init__(self, entry, Hs, Tp, beta, out_keys, escalate_f64, client,
                 cache_key, trace_ctx=None):
        self.entry = entry
        self.Hs, self.Tp, self.beta = Hs, Tp, beta
        self.out_keys = out_keys
        self.escalate_f64 = bool(escalate_f64)
        self.client = client
        self.future = concurrent.futures.Future()
        self.t_submit = time.perf_counter()
        self.cache_key = cache_key
        # (trace_id, span_id) of the request's serve_request span: the
        # tick span links to it, so one trace covers client -> queue ->
        # tick -> dispatch -> response across the thread boundary
        self.trace_ctx = trace_ctx
        # (tick_t0, dispatch_t0, dispatch_t1, solve_s, rows) stamped by
        # the tick that dispatched this request — the tail-attribution
        # stage decomposition and the latency exemplar read these at
        # resolve time (rows = unique dispatched rows in the group)
        self.t_marks = None


class Batcher:
    """Continuous batcher over a design :class:`~raft_tpu_torch.serve.
    engine.Registry`.

    ``device`` is where every dispatch runs (default: the current CUDA
    device; raises without one — pass ``device="cpu"`` for the CPU).
    Construction resolves the device and the batch ladder but runs
    nothing; :func:`raft_tpu_torch.serve.engine.warm` or the first tick
    does.  ``start()`` spawns the dispatcher thread; tests drive
    :meth:`run_tick` directly instead.  ``group_log`` > 0 keeps that
    many of the last dispatched groups in :attr:`groups`.
    """

    def __init__(self, registry, out_keys=None, device=None, tick_ms=None,
                 max_batch=None, cache=None, quotas=None, queue_bound=None,
                 replica_id=None, group_log=0):
        from raft_tpu_torch.utils.dtypes import resolve_device

        self.registry = registry
        # stamped into latency exemplars so a /metrics scrape names
        # WHICH process served the p99 request
        self.replica_id = str(replica_id) if replica_id else (
            f"pid-{os.getpid()}")
        # status is non-optional: per-request error semantics read it
        self.out_keys = engine.normalize_out_keys(out_keys)
        self.device = resolve_device(device)
        self.sizes = engine.batch_ladder(max_batch)
        self.tick_s = (float(config.get("SERVE_TICK_MS"))
                       if tick_ms is None else float(tick_ms)) / 1e3
        # adaptive tick: the coalescing window scales between the floor
        # and self.tick_s with the recent per-tick row load, and a
        # bucket group filling a top ladder rung dispatches early —
        # see _wake_in
        self.tick_mode = str(config.get("SERVE_TICK_MODE"))
        self.tick_floor_s = min(
            float(config.get("SERVE_TICK_MIN_MS")) / 1e3, self.tick_s)
        self.cache = cache if cache is not None else ResultCache(
            int(float(config.get("SERVE_CACHE_MB")) * 1e6))
        self.quotas = quotas if quotas is not None else ClientQuotas(
            config.get("SERVE_QPS"), config.get("SERVE_BURST"))
        self.queue_bound = (int(config.get("SERVE_QUEUE"))
                            if queue_bound is None else int(queue_bound))
        #: the last dispatched groups, oldest first (``group_log`` > 0):
        #: dicts of ``entries``, ``Hs``, ``Tp``, ``beta``, ``padded``,
        #: ``out`` (the dispatched rows, padding dropped) and
        #: ``launches`` (the solve kernel's forward launches)
        self.groups = deque(maxlen=int(group_log)) if group_log else None
        self._cond = threading.Condition()
        self._pending: deque[_Request] = deque()  # raft-lint: guarded-by=self._cond
        self._draining = False  # raft-lint: guarded-by=self._cond
        self._stop = False  # raft-lint: guarded-by=self._cond
        self._in_tick = False  # raft-lint: guarded-by=self._cond
        # adaptive-tick state: per-signature pending UNIQUE cache keys
        # (the full-rung early-dispatch trigger — duplicates of one
        # case dedupe to a single dispatched row, so counting requests
        # would collapse the window for a 1-row batch under a same-
        # corner burst), the oldest pending request's submit instant
        # (the window anchors on it), and an EMA of dispatched UNIQUE
        # rows per tick (the load signal the window scales with)
        self._sig_pending: dict = {}  # raft-lint: guarded-by=self._cond
        self._first_pending_t = None  # raft-lint: guarded-by=self._cond
        self._load_ema = 0.0  # raft-lint: guarded-by=self._cond
        # cross-tick in-flight joining: cache_key -> the requester list
        # of a row some tick is CURRENTLY solving.  A duplicate case
        # submitted mid-solve attaches to that list instead of queueing
        # a redundant dispatch row — the dispatching tick pops the
        # (grown) list when its row lands and fans out to every joiner.
        self._inflight: dict = {}  # raft-lint: guarded-by=self._cond
        self._thread = None

    # ------------------------------------------------------------ submit

    def submit(self, design, Hs, Tp, beta, out_keys=None, escalate_f64=False,
               client=None, trace_ctx=None):
        """Admit one evaluation request; returns a Future resolving to
        the result payload dict (``outputs``/``status``/``status_text``/
        ``cache_hit``/``escalated``).  Raises :class:`KeyError` for an
        unknown design name, :class:`ValueError` for out_keys outside
        the served set, and a :class:`RejectError` subclass on
        backpressure."""
        entry = (design if isinstance(design, engine.DesignEntry)
                 else self.registry.get(design))
        if entry is None:
            raise KeyError(f"unknown design {design!r}")
        requested = tuple(out_keys) if out_keys else self.out_keys
        extra_keys = set(requested) - set(self.out_keys)
        if extra_keys:
            raise ValueError(
                f"out_keys {sorted(extra_keys)} not served (this server "
                f"dispatches {list(self.out_keys)})")
        if self._draining:
            raise Draining("service is draining")
        bucket = self.quotas.bucket(client)
        if not bucket.acquire():
            metrics.counter("serve_rejected_quota").inc()
            log_event("serve_reject", reason="quota", client=str(client))
            raise QuotaExceeded(retry_after_s=bucket.retry_after_s())
        Hs, Tp, beta = float(Hs), float(Tp), float(beta)
        metrics.counter("serve_requests").inc()
        key = result_cache_key(
            entry.fingerprint, {"Hs": Hs, "Tp": Tp, "beta": beta},
            self.out_keys, extra=engine.flags_extra())
        req = _Request(entry, Hs, Tp, beta, requested, escalate_f64, client,
                       key, trace_ctx=trace_ctx)
        row = self.cache.get(key)
        if row is not None:
            # only HEALTHY rows are cached, so an opt-in escalation
            # never applies to a hit
            self._resolve(req, row, cache_hit=True)
            return req.future
        with self._cond:
            if self._draining:
                bucket.refund()   # rejected work must not eat quota
                raise Draining("service is draining")
            joined = self._inflight.get(key)
            if joined is not None:
                # the same case is mid-solve in an earlier tick: ride
                # its row instead of dispatching it again (cache-miss
                # only because the result is not back yet)
                joined.append(req)
                metrics.counter("serve_coalesced").inc()
                metrics.counter("serve_inflight_joins").inc()
                return req.future
            if len(self._pending) >= self.queue_bound:
                bucket.refund()
                metrics.counter("serve_rejected_queue").inc()
                log_event("serve_reject", reason="queue_full",
                          client=str(client))
                raise QueueFull(
                    f"admission queue full ({self.queue_bound} pending)")
            self._pending.append(req)
            metrics.gauge("serve_pending").set(len(self._pending))
            keys = self._sig_pending.setdefault(entry.sig, set())
            keys.add(key)
            n_sig = len(keys)
            if self._first_pending_t is None:
                self._first_pending_t = req.t_submit
            # the tick sleep IS the coalescing window, so a fixed-mode
            # submit never notifies (waking per submit would dispatch
            # every lull-time request as a batch of one).  Adaptive
            # mode wakes the dispatcher only when the window itself
            # should move: the queue just went
            # empty->nonempty (the dispatcher may be parked on the
            # idle ceiling; _wake_in re-anchors on this request, so a
            # lone light-load request waits ~the floor, not the full
            # tick) or a bucket group just filled the top ladder rung
            # (a full batch gains nothing by waiting — dispatch NOW)
            if self.tick_mode == "adaptive" and (
                    len(self._pending) == 1 or n_sig >= self.sizes[-1]):
                self._cond.notify_all()
        return req.future

    # -------------------------------------------------------------- tick

    def run_tick(self):
        """Dispatch everything pending NOW (the dispatcher thread calls
        this once per tick; tests call it directly).  Returns the
        number of requests resolved."""
        with self._cond:
            batch = list(self._pending)
            self._pending.clear()
            self._sig_pending.clear()
            self._first_pending_t = None
            metrics.gauge("serve_pending").set(0)
            self._in_tick = True
        if not batch:
            with self._cond:
                # idle ticks decay the load signal so the first lone
                # request after a burst gets the floor window again
                self._load_ema *= 0.7
                self._in_tick = False
                self._cond.notify_all()
            return 0
        t0 = time.perf_counter()
        # dedupe identical in-flight cases: one dispatched row fans out
        # to every requester (sweeps and optimizer herds are full of
        # duplicate corners that miss the cache only because they are
        # simultaneous)
        unique: dict[str, list[_Request]] = {}
        for req in batch:
            unique.setdefault(req.cache_key, []).append(req)
        metrics.counter("serve_coalesced").inc(len(batch) - len(unique))
        with self._cond:
            # publish the requester lists for cross-tick joining: a
            # duplicate case submitted while its row is mid-solve
            # appends itself to the SAME list (under this lock) and is
            # fanned out when the dispatching chunk pops the key
            for key_, rl in unique.items():
                self._inflight[key_] = rl
            # load EMA over UNIQUE dispatched rows (0.3 smoothing):
            # a duplicate-heavy burst must not read as a full device
            self._load_ema += 0.3 * (len(unique) - self._load_ema)
        groups: dict = {}
        for reqs in unique.values():
            groups.setdefault(reqs[0].entry.sig, []).append(reqs)
        # the tick span LINKS to every coalesced request span (they live
        # in other tasks/threads, so they cannot be its tree children):
        # one trace then covers client -> admission queue -> tick ->
        # bucket dispatch -> response
        span_kw = {}
        if structlog.enabled():
            links = [{"trace_id": r.trace_ctx[0], "span_id": r.trace_ctx[1]}
                     for rl in unique.values() for r in rl if r.trace_ctx]
            if links:
                span_kw["links"] = links
        with span("serve_tick", rows=len(batch), unique=len(unique),
                  **span_kw):
            n_dispatch, deferred = self._dispatch_groups(groups, t0)
            # escalation re-solves run LAST (and still on this thread:
            # _rung_flags mutates process-wide env, so a parallel
            # escalation would leak f64 flags into a concurrent normal
            # dispatch) — every non-escalating requester already has its
            # result before anyone pays the solo CPU re-solve.  The
            # head-of-line cost that remains is the NEXT tick.
            for rl, row in deferred:
                self._finalize(rl, row)
            wall = time.perf_counter() - t0
            metrics.histogram("serve_tick_s").observe(wall)
            log_event("serve_tick", rows=len(batch), unique=len(unique),
                      n_groups=len(groups), dispatches=n_dispatch,
                      wall_s=round(wall, 6))
        with self._cond:
            self._in_tick = False
            self._cond.notify_all()
        return len(batch)

    def _dispatch_groups(self, groups, tick_t0):
        """Dispatch every signature group of one tick; returns
        ``(n_dispatch, deferred)`` where ``deferred`` is the
        (reqs, row) list awaiting an f64 escalation re-solve.
        ``tick_t0`` is the tick's start instant: every dispatched
        request gets (tick_t0, dispatch window, solve wall) marks so
        resolve time can decompose its latency into stages."""
        n_dispatch = 0
        deferred = []
        for sig, reqlists in groups.items():
            cap = self.sizes[-1]
            for lo in range(0, len(reqlists), cap):
                chunk = reqlists[lo:lo + cap]
                firsts = [rl[0] for rl in chunk]
                t_d0 = time.perf_counter()
                timings = {}
                try:
                    padded = engine.pick_padded(len(firsts), self.sizes)
                    out = engine.dispatch(
                        [r.entry for r in firsts],
                        [r.Hs for r in firsts], [r.Tp for r in firsts],
                        [r.beta for r in firsts],
                        out_keys=self.out_keys, device=self.device,
                        padded=padded, timings=timings)
                    n_dispatch += 1
                except Exception as e:  # noqa: BLE001 — fan the failure out
                    log_event("serve_error", error=repr(e)[:300],
                              rows=len(chunk))
                    metrics.counter("serve_errors").inc()
                    # retire the in-flight keys FIRST so late joiners
                    # re-queue for a fresh tick instead of attaching to
                    # a list nobody will resolve again
                    with self._cond:
                        for rl in chunk:
                            self._inflight.pop(rl[0].cache_key, None)
                    for rl in chunk:
                        for req in rl:
                            if not req.future.set_running_or_notify_cancel():
                                continue
                            req.future.set_exception(e)
                    continue
                t_d1 = time.perf_counter()
                if self.groups is not None:
                    self.groups.append(dict(
                        entries=[r.entry for r in firsts],
                        Hs=[r.Hs for r in firsts], Tp=[r.Tp for r in firsts],
                        beta=[r.beta for r in firsts], padded=padded,
                        out=out, launches=timings.get("launches")))
                solve_s = min(timings.get("solve_s") or 0.0, t_d1 - t_d0)
                marks = (tick_t0, t_d0, t_d1, solve_s, len(firsts))
                for i, rl in enumerate(chunk):
                    row = {k: out[k][i] for k in self.out_keys}
                    # retire the in-flight key before fan-out: joiners
                    # appended up to this instant ride this row; later
                    # submits hit the result cache (or the next tick)
                    with self._cond:
                        self._inflight.pop(rl[0].cache_key, None)
                    for req in rl:
                        req.t_marks = marks
                    if self._needs_escalation(rl, row):
                        deferred.append((rl, row))
                    else:
                        self._finalize(rl, row)
        return n_dispatch, deferred

    @staticmethod
    def _needs_escalation(reqs, row):
        return (bool(health.any_bit(int(np.asarray(row["status"]))))
                and any(r.escalate_f64 for r in reqs))

    def _finalize(self, reqs, row):
        """Fan one dispatched row out to its (deduplicated) requesters:
        status checks, optional f64 escalation, cache insert."""
        status = int(np.asarray(row["status"]))
        severe = bool(health.any_bit(status))
        esc_row, esc_info = None, None
        if severe and any(r.escalate_f64 for r in reqs):
            try:
                retried, st2 = engine.escalate_row(
                    reqs[0].entry, reqs[0].Hs, reqs[0].Tp, reqs[0].beta,
                    out_keys=self.out_keys)
            except Exception as e:  # noqa: BLE001 — keep the base row
                esc_info = {"status_before": status, "status_after": None,
                            "resolved": False, "error": repr(e)[:200]}
            else:
                resolved = not bool(health.any_bit(st2))
                esc_info = {"status_before": status, "status_after": st2,
                            "resolved": resolved}
                if resolved:
                    esc_row = retried
                log_event("serve_escalate", status_before=status,
                          status_after=st2, resolved=resolved)
        if not severe:
            self.cache.put(reqs[0].cache_key, row)
        for req in reqs:
            use_esc = esc_row is not None and req.escalate_f64
            self._resolve(req, esc_row if use_esc else row, cache_hit=False,
                          escalated=esc_info if req.escalate_f64 else None)

    def _resolve(self, req, row, cache_hit, escalated=None):
        status = int(np.asarray(row["status"]))
        result = {
            "outputs": {k: row[k] for k in req.out_keys},
            "status": status,
            "status_text": health.describe(status),
            "severe": bool(health.any_bit(status)),
            "cache_hit": bool(cache_hit),
            "escalated": escalated,
        }
        if not req.future.set_running_or_notify_cancel():
            return  # requester went away (client timeout/cancel)
        wall = time.perf_counter() - req.t_submit
        # the exemplar carried by this observation if it lands in a
        # histogram's top-K: enough identity to reconstruct WHAT the
        # p99 request actually was (which design, which
        # bucket, how many rows rode its dispatch, did the cache
        # answer, how did the solver judge it, on which replica) and
        # to join it back to its span tree via trace_id/span_id
        exemplar = {
            "design": req.entry.fingerprint,
            "sig": bucketing.signature_fingerprint(req.entry.sig),
            "cache_hit": int(bool(cache_hit)),
            "status": status,
            "replica": self.replica_id,
        }
        if req.trace_ctx is not None:
            exemplar["trace_id"], exemplar["span_id"] = req.trace_ctx
        if req.t_marks is not None:
            exemplar["rows"] = int(req.t_marks[4])
        metrics.histogram("serve_request_s").observe(wall, exemplar=exemplar)
        if req.t_marks is not None and not cache_hit \
                and req.t_submit <= req.t_marks[0]:
            # tail attribution: split this request's end-to-end latency
            # into named stages that sum to `wall` by construction —
            # queue_wait (pending until its tick began), tick_wait
            # (behind earlier groups inside the tick), dispatch
            # (pack/host-to-device overhead), solve (evaluator call,
            # device synchronize, fetch), post (status fold / cache
            # insert / escalation).
            # A cross-tick JOINER (submitted after its row's tick began)
            # is excluded: the tick-level stage windows started before
            # it existed, so they cannot decompose ITS wall
            tick_t0, d0, d1, solve_s = req.t_marks[:4]
            stages = {
                "queue_wait": max(tick_t0 - req.t_submit, 0.0),
                "tick_wait": max(d0 - tick_t0, 0.0),
                "dispatch": max((d1 - d0) - solve_s, 0.0),
                "solve": solve_s,
            }
            stages["post"] = max(wall - sum(stages.values()), 0.0)
            for name, v in stages.items():
                metrics.histogram(f"serve_stage_{name}_s").observe(v)
            if structlog.enabled():
                # stamp the REQUEST's ids explicitly (payload kwargs
                # override the ambient tick-span context), so `obs
                # report --tail` can join an exemplar's span_id
                # straight to this stage breakdown
                ids = req.trace_ctx or (None, None)
                log_event("serve_request_stages", wall_s=round(wall, 6),
                          escalated=escalated is not None,
                          trace_id=ids[0], span_id=ids[1],
                          **{f"{k}_s": round(v, 6)
                             for k, v in stages.items()})
        # the sliding-window twin of the lifetime histogram: /healthz
        # p50/p95-over-last-N-seconds and the SLO breach gate read this
        metrics.window("serve_request_window_s").observe(wall,
                                                         exemplar=exemplar)
        slo_ms = float(config.get("SERVE_SLO_MS") or 0)
        if slo_ms > 0 and wall * 1e3 > slo_ms:
            metrics.counter("serve_slo_breaches").inc()
            log_event("slo_breach", wall_s=round(wall, 6), slo_ms=slo_ms,
                      client=str(req.client), cache_hit=bool(cache_hit))
        req.future.set_result(result)

    # ------------------------------------------------------- tick thread

    def start(self):
        """Spawn the dispatcher thread (idempotent)."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="raft-serve-batcher")
        self._thread.start()
        return self

    def _loop(self):
        import torch

        # torch's current device is per thread: this thread's is the
        # batcher's (dispatch passes the device explicitly as well)
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            self._loop_ticks()

    def _loop_ticks(self):
        while True:
            t0 = time.perf_counter()
            self.run_tick()
            with self._cond:
                if self._stop and not self._pending:
                    return
                while not self._stop:
                    delay = self._wake_in(t0)
                    if delay <= 0:
                        break
                    # a submit may notify (adaptive wake conditions) —
                    # re-evaluate the window rather than trusting the
                    # original timeout
                    self._cond.wait(timeout=delay)

    def _wake_in(self, tick_t0):
        """Seconds until the next tick should run (call under _cond).

        Fixed mode: the constant ``SERVE_TICK_MS`` cadence.  Adaptive
        mode: a bucket group at a full top ladder
        rung dispatches NOW (a full batch gains nothing by waiting);
        an empty queue parks on the ceiling (a submit notifies and
        re-anchors); otherwise the coalescing window anchors on the
        OLDEST pending request and scales with the recent per-tick row
        load between the floor (near-empty queue: the whole window is
        pure tail latency) and the ceiling (sustained load: bigger
        batches amortize the wait) — capped by the fixed cadence so a
        busy server never ticks slower than before."""
        now = time.perf_counter()
        deadline = tick_t0 + self.tick_s
        if self.tick_mode != "adaptive":
            return deadline - now
        if self._sig_pending and max(
                len(ks) for ks in self._sig_pending.values()) \
                >= self.sizes[-1]:
            return 0.0
        if self._first_pending_t is None:
            return deadline - now
        frac = min(1.0, self._load_ema / max(self.sizes[-1], 1))
        window = self.tick_floor_s + frac * (self.tick_s - self.tick_floor_s)
        return min(deadline, self._first_pending_t + window) - now

    def set_sizes(self, sizes):
        """Swap the batch ladder (post-warmup cost refinement,
        :func:`raft_tpu_torch.serve.engine.refine_ladder`).  Every rung
        should already be warmed — the batcher only ever dispatches
        ladder sizes."""
        sizes = tuple(sorted(int(s) for s in sizes))
        if not sizes:
            raise ValueError("empty batch ladder")
        with self._cond:
            self.sizes = sizes
        return self.sizes

    @property
    def draining(self):
        return self._draining

    def drain(self, timeout=None):
        """Graceful drain: refuse new work, finish every pending tick,
        stop the dispatcher.  Every already-accepted Future resolves
        before this returns (bounded by ``timeout``)."""
        t0 = time.perf_counter()
        pend0 = len(self._pending)
        with self._cond:
            self._draining = True
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            alive = self._thread.is_alive()
        else:
            # never started (socket-free/unit use): flush inline
            while self._pending or self._in_tick:
                self.run_tick()
            alive = False
        wall = round(time.perf_counter() - t0, 3)
        log_event("serve_drain", pending=pend0, wall_s=wall,
                  completed=not alive)
        return {"pending": pend0, "wall_s": wall, "completed": not alive}

    # -------------------------------------------------------------- misc

    def stats(self):
        return {
            "pending": len(self._pending),
            "inflight_rows": len(self._inflight),
            "draining": self._draining,
            "tick_ms": self.tick_s * 1e3,
            "tick_mode": self.tick_mode,
            "tick_floor_ms": self.tick_floor_s * 1e3,
            "load_ema_rows": round(self._load_ema, 2),
            "batch_sizes": list(self.sizes),
            "out_keys": list(self.out_keys),
            "device": str(self.device),
            "designs": self.registry.names(),
            "cache": self.cache.stats(),
        }

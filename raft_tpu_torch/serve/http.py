"""Asyncio HTTP front end of the evaluation service (the port's
counterpart of ``raft_tpu/serve/http.py``; stdlib only).

A deliberately small HTTP/1.1 implementation over ``asyncio.
start_server`` — request line + headers + Content-Length body,
keep-alive connections, JSON in/out.  The event loop never blocks on an
evaluation: it bridges to the batcher's futures with
``asyncio.wrap_future``, and the batcher dispatches from its own
thread.

Routes
------
``POST /evaluate``  body::

        {"design": "spar",            # registered name, or
         "design_inline": {...},      # inline design dict
         "Hs": 6.0, "Tp": 11.0, "beta": 0.0,
         "out_keys": ["PSD", "X0", "status"],   # optional subset
         "escalate_f64": false}                 # quarantine-style re-solve

    → 200 with ``{"ok": true, "status": <int32 word>, "status_text",
    "cache_hit", "escalated", "outputs": {...}}``; a result carrying
    SEVERE health bits returns **422** with the same body plus the
    ``describe()`` error text (numbers included — suspect, not absent);
    backpressure returns **429** (per-client quota, with Retry-After)
    or **503** (admission queue full / draining); a dispatch that
    raised returns **500**.

``GET /healthz``    liveness, batcher + cache stats, latency windows and
                    the solve kernel's state: ``kernel.built_here``
                    (this process compiled the kernel library),
                    ``kernel.loaded`` and ``kernel.launches`` (its
                    launch counters per entry) — where the reference
                    reports its XLA compile counts; beside the kernel
                    ledger (``cost_ledger``) the program bank's
                    counters (``aot_programs_loaded`` /
                    ``aot_programs_compiled``) and state (``aot``: mode,
                    builds, nvcc runs, the library's file)
``GET /metrics``    the process metrics registry in Prometheus text
                    exposition format
``GET /designs``    registered design names
``GET /alerts``     the alert engine's state (``enabled: false`` unless
                    ``RAFT_TPU_ALERT_EVAL_S`` > 0) and the replica's
                    golden-canary summary (None unless
                    ``RAFT_TPU_CANARY_S`` > 0)
``GET /debug/flight``  the flight ring as a JSONL shard (loopback only)
``POST /drain``     begin a graceful drain (202) — loopback peers only
                    (the fleet router drains a replica it is evicting;
                    a tenant must never be able to drain the service)

Shutdown: SIGTERM/SIGINT (or ``POST /drain``) triggers a graceful
drain — release the fleet membership lease FIRST (``on_drain_start``,
so the router stops routing new work here while accepted work
finishes), stop accepting, finish in-flight ticks (every accepted
request gets its response), flush metrics (``RAFT_TPU_METRICS`` path
when set), then exit.

Fault injection (:mod:`raft_tpu_torch.utils.faults`): the three
``replica_*`` kinds consult the ``serve_evaluate`` site here —
``replica_kill`` SIGKILLs the process on the next /evaluate,
``replica_hang`` parks it past every timeout, ``replica_5xx`` returns
a 500 — driving the router's kill-a-replica / breaker drills
deterministically.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import time

import numpy as np

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import (current_ids, format_traceparent,
                                parse_traceparent, span)
from raft_tpu_torch.serve import batcher as batcher_mod
from raft_tpu_torch.serve import wire
from raft_tpu_torch.utils import config, faults
from raft_tpu_torch.utils.structlog import log_event

_T0 = time.perf_counter()

#: kept as module aliases — the wire module is the single definition
#: shared with the fleet router
MAX_BODY_BYTES = wire.MAX_BODY_BYTES


def _json_value(v):
    """JSON-encode one output leaf: numpy arrays to nested lists,
    complex values split into real/imag."""
    a = np.asarray(v)
    if np.iscomplexobj(a):
        return {"real": a.real.tolist(), "imag": a.imag.tolist()}
    return a.tolist()


def encode_result(result):
    """The JSON body of one evaluation result payload."""
    return {
        "ok": not result["severe"],
        "status": result["status"],
        "status_text": result["status_text"],
        "cache_hit": result["cache_hit"],
        "escalated": result["escalated"],
        "outputs": {k: _json_value(v)
                    for k, v in result["outputs"].items()},
    }


class Server:
    """One service instance: batcher + asyncio HTTP endpoint."""

    def __init__(self, batcher, host="127.0.0.1", port=8787,
                 on_drain_start=None, provenance=None):
        self.batcher = batcher
        self.host = host
        self.port = int(port)
        self.timeout_s = float(config.get("SERVE_TIMEOUT_S"))
        #: per-design provenance stamps ({design: prov dict} plus the
        #: "*" base for inline designs — engine.build_provenance);
        #: precomputed ONCE into header strings so the per-request cost
        #: is a dict lookup (the zero-overhead contract)
        from raft_tpu_torch.obs.alerts import format_provenance

        self._prov_headers = {k: format_provenance(v)
                              for k, v in (provenance or {}).items()}
        #: called (in an executor — it does file IO) at the very START
        #: of the graceful drain, before any in-flight work finishes:
        #: the fleet replica releases its membership lease here, so the
        #: router stops routing new requests to a draining replica
        #: while it completes the accepted ones
        self.on_drain_start = on_drain_start
        self._server = None
        self._stop = None
        self._handlers = set()

    # ------------------------------------------------------------ routes

    async def _evaluate(self, body, client, traceparent=None):
        """One /evaluate request under its ``serve_request`` span: the
        span adopts the client's ``traceparent`` (when sent) so the
        request joins the caller's trace, and its ids ride into the
        batcher so the tick span can link back — one trace from HTTP
        accept through coalescing to the bucket dispatch.
        Returns ``(status, payload, extra_headers)``."""
        req_span = span("serve_request", endpoint="/evaluate",
                        remote=parse_traceparent(traceparent),
                        client=str(client))
        with req_span:
            status, payload, design = await self._evaluate_inner(body,
                                                                 client)
        hdrs = {}
        tp = format_traceparent(req_span.trace_id, req_span.span_id) \
            if req_span.span_id else None
        if tp:
            hdrs["traceparent"] = tp
        # provenance stamp: WHAT produced these numbers — bank key +
        # sidecar sha, code hash, flags key, replica id (precomputed at
        # startup; the canary cross-checks it across replicas)
        prov = (self._prov_headers.get(design)
                or self._prov_headers.get("*"))
        if prov:
            hdrs["x-raft-provenance"] = prov
        return status, payload, hdrs

    async def _evaluate_inner(self, body, client):
        """Returns ``(status, payload, design_key)`` — the design key
        picks the provenance stamp (``"*"`` = base stamp: inline or
        unresolved designs)."""
        try:
            payload = json.loads(body or b"{}")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"ok": False, "error": f"bad JSON body: {e}"}, "*"
        if not isinstance(payload, dict):
            return (400, {"ok": False, "error": "body must be a JSON object"},
                    "*")
        client = payload.get("client") or client
        loop = asyncio.get_running_loop()
        entry = None
        if payload.get("design_inline") is not None:
            # building an inline design is host work (YAML schema +
            # model build) — keep it off the event loop
            try:
                entry = await loop.run_in_executor(
                    None, self.batcher.registry.resolve_inline,
                    payload["design_inline"])
            except Exception as e:  # noqa: BLE001 — tenant input
                return (400, {"ok": False,
                              "error": f"inline design rejected: {e!r}"},
                        "*")
        else:
            name = payload.get("design")
            if not name:
                return (400, {"ok": False,
                              "error": "missing 'design' "
                                       "(or 'design_inline')"}, "*")
            entry = self.batcher.registry.get(name)
            if entry is None:
                return (404, {"ok": False,
                              "error": f"unknown design {name!r}"}, "*")
        design = entry.name
        # the case scalars are REQUIRED: silently defaulting a missing
        # (or misspelled) Hs/Tp/beta would evaluate the wrong sea state
        # and return it as ok:true — in a parity-gated service, wrong
        # numbers must never be quieter than a 400
        missing = [k for k in ("Hs", "Tp", "beta") if k not in payload]
        if missing:
            return (400, {"ok": False,
                          "error": f"missing case scalar(s) {missing}"},
                    design)
        try:
            case = {k: float(payload[k]) for k in ("Hs", "Tp", "beta")}
        except (TypeError, ValueError):
            return (400, {"ok": False,
                          "error": "Hs/Tp/beta must be numbers"}, design)
        out_keys = payload.get("out_keys")
        if out_keys is not None and not (
                isinstance(out_keys, list)
                and all(isinstance(k, str) for k in out_keys)):
            return (400, {"ok": False,
                          "error": "out_keys must be a string list"}, design)
        try:
            fut = self.batcher.submit(
                entry, case["Hs"], case["Tp"], case["beta"],
                out_keys=tuple(out_keys) if out_keys else None,
                escalate_f64=bool(payload.get("escalate_f64")),
                client=client, trace_ctx=current_ids())
        except batcher_mod.QuotaExceeded as e:
            return (429, {"ok": False, "error": "client quota exceeded",
                          "retry_after_s": round(e.retry_after_s, 3)},
                    design)
        except batcher_mod.RejectError as e:
            return (503, {"ok": False, "error": str(e),
                          "reason": e.reason}, design)
        except ValueError as e:
            return 400, {"ok": False, "error": str(e)}, design
        try:
            result = await asyncio.wait_for(asyncio.wrap_future(fut),
                                            timeout=self.timeout_s)
        except asyncio.TimeoutError:
            fut.cancel()
            return (408, {"ok": False,
                          "error": f"evaluation exceeded {self.timeout_s}s"},
                    design)
        except Exception as e:  # noqa: BLE001 — dispatch failure
            return 500, {"ok": False, "error": repr(e)[:300]}, design
        return (422 if result["severe"] else 200), encode_result(result), \
            design

    def _healthz(self):
        from raft_tpu_torch.aot import bank
        from raft_tpu_torch.obs.report import SERVE_STAGES
        from raft_tpu_torch.ops import linsolve

        snap = {c: metrics.counter(c).value for c in
                ("aot_programs_loaded", "aot_programs_compiled",
                 "serve_requests", "serve_dispatches",
                 "serve_rows_dispatched", "serve_coalesced",
                 "serve_rejected_quota", "serve_rejected_queue",
                 "serve_errors", "serve_escalations",
                 "serve_kernel_launches")}
        occ = metrics.histogram("serve_batch_occupancy").snapshot()
        lat = metrics.histogram("serve_request_s").snapshot()
        # tail attribution: per-stage latency histograms of every
        # dispatched request (the capture-level p50-vs-p95 stage table
        # lives in `obs report`; this is the live operator view)
        stages = {s: metrics.histogram(f"serve_stage_{s}_s").snapshot()
                  for s in SERVE_STAGES}
        window_s = float(config.get("SERVE_WINDOW_S"))
        win = metrics.window("serve_request_window_s").snapshot(window_s)
        slo_ms = float(config.get("SERVE_SLO_MS") or 0)
        return 200, {
            "ok": True,
            "draining": self.batcher.draining,
            "uptime_s": round(time.perf_counter() - _T0, 3),
            # the reference's xla_compiles / xla_real_compiles: the
            # port compiles one kernel library with nvcc, ahead of its
            # first launch, and traces nothing at run time
            "kernel": {"built_here": bool(linsolve.BUILT_HERE),
                       "loaded": linsolve._LIB is not None,
                       "launches": linsolve.launch_ledger()},
            "batch_occupancy": occ,
            "request_latency_s": lat,
            # the sliding view an operator pages on: p50/p95 over the
            # last RAFT_TPU_SERVE_WINDOW_S seconds + SLO state
            "window": win,
            "request_stages": stages,
            "slo": {"slo_ms": slo_ms or None,
                    "breaches": metrics.counter("serve_slo_breaches").value},
            # the kernel's launch ledger (one row per entry launched)
            "cost_ledger": bank.ledger_summary(),
            # the program bank beside it: its mode, the builds this
            # process charged (bank misses + nvcc runs), its nvcc runs
            # and the file its kernel library came from (a bank's copy
            # under RAFT_TPU_AOT=load|require on a warm bank)
            "aot": {"mode": bank.mode(), "builds": bank.builds(),
                    "nvcc_runs": linsolve.NVCC_RUNS,
                    "library": linsolve.loaded_library()},
            **self.batcher.stats(),
            **snap,
        }

    async def _route(self, method, path, body, client, headers,
                     peer_host="?"):
        """Returns ``(status, payload)`` or ``(status, payload,
        extra_response_headers)``."""
        if path == "/evaluate":
            if method != "POST":
                return 405, {"ok": False, "error": "POST required"}
            # deterministic replica failure modes for the fleet drills
            # (raft_tpu_torch.utils.faults): kill = SIGKILL mid-load, hang =
            # park past every timeout (wedged-but-alive), 5xx = error
            # response — the router must retry/break around all three
            if faults.take("replica_kill", "serve_evaluate"):
                os.kill(os.getpid(), signal.SIGKILL)
            if faults.take("replica_hang", "serve_evaluate"):
                await asyncio.sleep(2 * self.timeout_s)
                return 503, {"ok": False, "error": "hang fault elapsed"}
            if faults.take("replica_5xx", "serve_evaluate"):
                return 500, {"ok": False, "error": "injected 5xx fault"}
            if self.batcher.draining:
                return 503, {"ok": False, "error": "service is draining",
                             "reason": "draining"}
            return await self._evaluate(body, client,
                                        traceparent=headers.get("traceparent"))
        if path == "/drain":
            if method != "POST":
                return 405, {"ok": False, "error": "POST required"}
            # admin-gated: only loopback peers (the operator or a
            # co-hosted router evicting this replica) may drain
            if peer_host not in wire.LOOPBACK_HOSTS:
                return 403, {"ok": False,
                             "error": "drain is loopback-only"}
            if self._stop is None:
                return 503, {"ok": False,
                             "error": "server not accepting signals yet"}
            already = self.batcher.draining or self._stop.is_set()
            self._stop.set()  # same path as SIGTERM: shutdown() runs
            #                   after this response is written
            return 202, {"ok": True, "draining": True,
                         "already_draining": bool(already)}
        if method != "GET":
            return 405, {"ok": False, "error": "GET required"}
        if path == "/healthz":
            return self._healthz()
        if path == "/alerts":
            # live alert-engine state (+ the replica's golden-canary
            # summary when the canary path is enabled) — pure in-memory
            # reads, safe on the event loop
            from raft_tpu_torch.obs import alerts as alerts_mod
            from raft_tpu_torch.serve import canary as canary_mod

            payload = alerts_mod.endpoint_payload()
            payload["canary"] = canary_mod.replica_summary()
            return 200, payload
        if path == "/metrics":
            return 200, metrics.to_prometheus()  # text, not JSON
        if path == "/debug/flight":
            # the live flight ring as a JSONL shard — postmortem-grade
            # history (spans/events/metric deltas with logging off)
            # without restarting anything.  Loopback-gated like /drain:
            # ring payloads carry design hashes and client ids, which a
            # tenant must not be able to read
            if peer_host not in wire.LOOPBACK_HOSTS:
                return 403, {"ok": False,
                             "error": "/debug/flight is loopback-only"}
            from raft_tpu_torch.obs import flight

            return 200, flight.serialize_text(trigger="debug")  # text
        if path == "/designs":
            return 200, {"ok": True, "designs": self.batcher.registry.names()}
        return 404, {"ok": False, "error": f"no route {path}"}

    # -------------------------------------------------------- connection

    # request parsing + response formatting live in raft_tpu_torch.serve.wire
    # (shared with the fleet router)

    async def _read_request(self, reader):
        return await wire.read_request(reader)

    @staticmethod
    def _response_bytes(status, payload, keep_alive, extra_headers=None):
        return wire.response_bytes(status, payload, keep_alive,
                                   extra_headers)

    async def _handle(self, reader, writer):
        task = asyncio.current_task()
        self._handlers.add(task)
        peer = writer.get_extra_info("peername")
        peer_host = peer[0] if isinstance(peer, tuple) else "?"
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (ValueError, asyncio.IncompleteReadError) as e:
                    writer.write(self._response_bytes(
                        400, {"ok": False, "error": str(e)[:200]}, False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, headers, body = req
                client = headers.get("x-client") or peer_host
                t0 = time.perf_counter()
                extra = None
                try:
                    routed = await self._route(method, path, body,
                                               client, headers,
                                               peer_host=peer_host)
                    status, payload = routed[0], routed[1]
                    extra = routed[2] if len(routed) > 2 else None
                except Exception as e:  # noqa: BLE001 — keep serving
                    status, payload = 500, {"ok": False,
                                            "error": repr(e)[:300]}
                keep = (headers.get("connection", "keep-alive").lower()
                        != "close") and not self.batcher.draining \
                    and not (self._stop is not None and self._stop.is_set())
                writer.write(self._response_bytes(status, payload, keep,
                                                  extra))
                await writer.drain()
                log_event("serve_request", endpoint=path, method=method,
                          code=status, client=str(client),
                          wall_s=round(time.perf_counter() - t0, 6),
                          cache_hit=bool(payload.get("cache_hit"))
                          if isinstance(payload, dict) else False)
                metrics.counter("serve_http_requests").inc()
                if not keep:
                    break
        finally:
            self._handlers.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # ------------------------------------------------------------- serve

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self._stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        self.batcher.start()
        # arm the flight recorder's periodic flush + crash hooks (no-op
        # without RAFT_TPU_FLIGHT_DIR): a SIGKILLed replica must leave
        # its last seconds behind for the kill-a-replica postmortem
        from raft_tpu_torch.obs import flight

        flight.maybe_start()
        log_event("serve_start", host=self.host, port=self.port,
                  designs=self.batcher.registry.names(),
                  tick_ms=self.batcher.tick_s * 1e3,
                  batch_sizes=list(self.batcher.sizes))
        return self

    async def serve_until_stopped(self):
        """Block until SIGTERM/SIGINT, then drain gracefully."""
        await self._stop.wait()
        await self.shutdown()

    async def shutdown(self):
        """Graceful drain: refuse new work, finish in-flight requests,
        flush metrics."""
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        # 0. release fleet membership FIRST (file IO — executor): the
        #    router must stop routing NEW work here before we spend the
        #    drain window finishing the accepted work; a lease released
        #    at process exit instead would keep attracting traffic for
        #    the whole drain
        if self.on_drain_start is not None:
            try:
                await loop.run_in_executor(None, self.on_drain_start)
            except Exception as e:  # noqa: BLE001 — drain must proceed
                log_event("serve_error", error=repr(e)[:300], rows=0)
        # 1. stop accepting new connections; mark draining so keep-alive
        #    connections get 503 for new requests
        self._server.close()
        # 2. finish every accepted request (the batcher resolves all
        #    pending futures before drain() returns)
        drain_s = float(config.get("SERVE_DRAIN_S"))
        await loop.run_in_executor(None, self.batcher.drain, drain_s)
        # 3. let the open handlers write their final responses
        handlers = {t for t in self._handlers if not t.done()}
        if handlers:
            await asyncio.wait(handlers, timeout=drain_s)
        for t in list(self._handlers):
            t.cancel()
        await self._server.wait_closed()
        # 4. flush metrics for the scrape-at-exit consumers — file IO,
        #    so off the loop: open handlers are still writing their
        #    final responses while this runs (async-blocking lint)
        path = config.get("METRICS")
        if path:
            await loop.run_in_executor(None, metrics.export, path)
        # 5. append the session's run record (RAFT_TPU_RUNS_DIR): the
        #    metrics registry at drain carries the whole serving story
        #    — request/stage/occupancy histograms, waste counters,
        #    cost ledger — so the longitudinal store sees every session.
        #    Executor too: the record write is file IO plus a
        #    `git rev-parse` subprocess (obs.runs.git_sha)
        from raft_tpu_torch.obs import runs as obs_runs

        wall_s = time.perf_counter() - _T0
        requests = metrics.counter("serve_requests").value
        await loop.run_in_executor(
            None, lambda: obs_runs.maybe_record(
                "serve", wall_s=wall_s, extra={"requests": requests}))
        log_event("serve_stop",
                  requests=metrics.counter("serve_requests").value,
                  wall_s=round(time.perf_counter() - t0, 3))


async def run_server(batcher, host="127.0.0.1", port=8787, ready=None,
                     on_drain_start=None, provenance=None):
    """Start + block until signalled.  ``ready(server)`` runs after the
    socket binds (the CLI prints its ready line there; the fleet
    replica claims its membership lease there too)."""
    server = await Server(batcher, host, port,
                          on_drain_start=on_drain_start,
                          provenance=provenance).start()
    if ready is not None:
        ready(server)
    await server.serve_until_stopped()
    return server

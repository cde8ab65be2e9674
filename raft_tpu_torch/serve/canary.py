"""Golden-answer canary prober for the serving fleet (the port's
counterpart of ``raft_tpu/serve/canary.py``).

Health bits, breakers and lease TTLs catch replicas that are *dead or
erroring* — none of them catches a replica that is **silently wrong**:
warmed from a stale AOT bank, running under divergent flags, or on a
skewed toolchain, it answers 200 with numbers that differ from every
other replica's.  The canary is the in-band verification layer:

* **golden capture** — at serve/router warm-up, each registered design
  gets a content-addressed golden row: the design content hash + the
  exact canary case bits + the probed out_keys (REUSING
  :func:`raft_tpu_torch.serve.cache.result_cache_key`, so the golden's
  key IS the serving cache key) mapping to the selected outputs and the
  int32 status word.  On a replica, :func:`capture_goldens` dispatches
  each design once through the production funnel on the replica's
  device; at the router, the first probe response per key becomes the
  golden.
* **probing** — :class:`RouterCanary` is a daemon thread in the router
  process (blocking HTTP on THIS thread, never the event loop — the
  membership prober's pattern): every ``RAFT_TPU_CANARY_S`` seconds it
  sends one synthetic ``/evaluate`` per (replica, design) pair,
  pinned to each replica directly at its ledger endpoint (the ring
  routes a named design to ONE owner, so probing through the ladder
  would never see the others).
* **comparison** — the status word must match the golden **bit for
  bit**; float outputs compare within ``RAFT_TPU_CANARY_RTOL`` /
  ``ATOL``.  ``canary_pass`` / ``canary_fail`` counters feed the
  ``canary-failure`` alert rule.
* **provenance cross-check** — every probe response carries the
  ``x-raft-provenance`` header (bank key + bank sidecar sha + code
  hash + flags key + replica id); the canary groups them per design
  and requires all replicas to agree on everything but the replica id
  (:func:`raft_tpu_torch.obs.alerts.provenance_consistency`).  Two replicas
  serving from different bank versions alarm **even while both are
  individually numerically fine** — the ``canary_parity_ok`` gauge
  drops to 0, the offending provenance is published as the
  ``canary_parity`` alert context, and the ``canary-parity`` rule
  fires.

Zero overhead when ``RAFT_TPU_CANARY_S`` is unset: no thread, no
goldens, no per-request cost (the provenance header is stamped by the
server regardless — it is one precomputed string).
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np

from raft_tpu_torch.obs import alerts, metrics
from raft_tpu_torch.serve.cache import result_cache_key
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

#: the fixed synthetic sea state every canary probe evaluates —
#: deterministic by construction (the golden is whatever the first
#: dispatch answered, healthy or flagged; only DIVERGENCE alarms)
CANARY_CASE = (4.0, 9.0, 0.0)

#: alert-context key the parity verdict publishes under (the
#: ``canary-parity`` / ``canary-failure`` default rules attach it)
CONTEXT_KEY = "canary_parity"


def canary_out_keys(served=None):
    """The out_keys canary probes request (``RAFT_TPU_CANARY_OUT_KEYS``,
    default ``X0,status`` — small arrays, cheap probes), intersected
    with the served set when given; ``status`` is always included."""
    raw = config.get("CANARY_OUT_KEYS") or "X0,status"
    keys = tuple(k.strip() for k in raw.split(",") if k.strip())
    if served is not None:
        keys = tuple(k for k in keys if k in served)
    if "status" not in keys:
        keys = keys + ("status",)
    return keys


def golden_key(fingerprint, case, out_keys):
    """The content-addressed golden key: design content hash + exact
    case bits + probed out_keys — :func:`raft_tpu_torch.serve.cache.
    result_cache_key` verbatim."""
    Hs, Tp, beta = case
    return result_cache_key(fingerprint,
                            {"Hs": float(Hs), "Tp": float(Tp),
                             "beta": float(beta)}, out_keys)


def _release_view():
    """The release-parity context for :func:`raft_tpu_torch.obs.alerts.
    provenance_consistency` — which release ids are legitimately in
    the fleet right now (mid-rollout: two of them) and which bank shas
    each shipped.  None (pre-release behavior) when no release
    infrastructure is present or readable; the canary must keep
    working against pointer-less banks."""
    try:
        from raft_tpu_torch.aot import release

        return release.parity_context()
    except Exception:  # noqa: BLE001 — parity must not die on IO
        return None


def decode_outputs(outputs_json):
    """Host numpy arrays from one ``/evaluate`` response's ``outputs``
    payload (complex values arrive split as ``{"real", "imag"}`` —
    see ``raft_tpu_torch.serve.http._json_value``)."""
    out = {}
    for k, v in (outputs_json or {}).items():
        if isinstance(v, dict) and "real" in v and "imag" in v:
            out[k] = (np.asarray(v["real"], dtype=float)
                      + 1j * np.asarray(v["imag"], dtype=float))
        else:
            out[k] = np.asarray(v)
    return out


class CanaryState:
    """The socket-free canary core: golden store + comparison +
    cross-replica provenance bookkeeping.  Thread-safe — the router's
    canary thread and the ``/alerts`` endpoint share one instance."""

    def __init__(self, rtol=None, atol=None):
        self.rtol = float(rtol if rtol is not None
                          else config.get("CANARY_RTOL"))
        self.atol = float(atol if atol is not None
                          else config.get("CANARY_ATOL"))
        self._lock = threading.Lock()
        self._goldens: dict = {}  # raft-lint: guarded-by=self._lock
        #: {design: {replica: provenance dict}} — the parity check's view
        self._provenance: dict = {}  # raft-lint: guarded-by=self._lock
        #: {(design, replica): "addr:port" the stamp was probed from} —
        #: a same-rid TAKEOVER (rolling upgrade) replaces the process
        #: behind the endpoint, so a stamp observed from the previous
        #: endpoint is void, not evidence of skew
        self._prov_from: dict = {}  # raft-lint: guarded-by=self._lock
        #: {replica: {"endpoint", "n"}} — observations folded in AT the
        #: replica's current endpoint; the run restarts when the
        #: endpoint changes or the replica departs, so the rollout
        #: gate's fresh-probe count only credits the CURRENT process.
        #: (A gate counting fleet-wide passes goes green off the
        #: candidate's healthy neighbors; one counting per-rid probes
        #: still goes green off the OLD process, which keeps answering
        #: its drain window while the canary's membership snapshot is
        #: a beat stale — the endpoint is the process identity.)
        self._probes: dict = {}  # raft-lint: guarded-by=self._lock
        #: {golden key or "provenance": failure detail} currently failing
        self._failing: dict = {}  # raft-lint: guarded-by=self._lock

    # ------------------------------------------------------------ goldens

    def capture(self, key, design, case, out_keys, outputs, status,
                replica=None, provenance=None):
        """Store one golden row under its content key (first capture
        wins — a golden is immutable).  Returns True when THIS call
        created it.  The stored dict is the ``canary-golden`` schema
        family."""
        status = int(np.asarray(status))
        rec = {
            "key": str(key),
            "design": str(design),
            "case": tuple(float(c) for c in case),
            "out_keys": tuple(out_keys),
            "outputs": {k: np.array(v) for k, v in (outputs or {}).items()},
            "status": status,
            "replica": str(replica) if replica else None,
            "provenance": dict(provenance) if provenance else None,
            "t_unix": round(time.time(), 3),
        }
        with self._lock:
            if key in self._goldens:
                return False
            self._goldens[key] = rec
        metrics.counter("canary_goldens").inc()
        log_event("canary_golden", design=str(design), key=str(key)[:24],
                  status=status, replica=str(replica) if replica else None)
        return True

    def compare(self, golden, outputs, status):
        """One row against its golden: the int32 status word must match
        **bit for bit**; float/complex outputs within rtol/atol.
        Returns ``(ok, reason)``."""
        status = int(np.asarray(status))
        if status != golden["status"]:
            return False, (f"status {status} != golden "
                           f"{golden['status']} (bit-exact contract)")
        gold_outputs = golden["outputs"]
        for k, gv in gold_outputs.items():
            if k == "status":
                continue
            v = (outputs or {}).get(k)
            if v is None:
                return False, f"output {k!r} missing from probe response"
            v, gv = np.asarray(v), np.asarray(gv)
            if v.shape != gv.shape:
                return False, (f"output {k!r} shape {v.shape} != golden "
                               f"{gv.shape}")
            if not np.allclose(v, gv, rtol=self.rtol, atol=self.atol,
                               equal_nan=True):
                delta = float(np.max(np.abs(v - gv)))
                return False, (f"output {k!r} max |delta| {delta:.3e} "
                               f"outside rtol={self.rtol} "
                               f"atol={self.atol}")
        return True, "match"

    # ------------------------------------------------------------ observe

    def observe(self, design, replica, fingerprint, case, out_keys,
                outputs, status, provenance=None, endpoint=None):
        """Fold one probe response in: first response per golden key
        becomes the golden, later ones compare; the provenance joins
        the per-design cross-replica view.  Returns the verdict dict
        (also emitted as a ``canary_check`` event)."""
        key = golden_key(fingerprint, case, out_keys)
        created = self.capture(key, design, case, out_keys, outputs,
                               status, replica=replica,
                               provenance=provenance)
        with self._lock:
            golden = self._goldens[key]
        if created:
            ok, reason = True, "golden"
        else:
            ok, reason = self.compare(golden, outputs, status)
        with self._lock:
            run = self._probes.get(str(replica))
            if run is None or (endpoint is not None
                               and run.get("endpoint") != str(endpoint)):
                run = {"endpoint": (str(endpoint) if endpoint is not None
                                    else None), "n": 0}
                self._probes[str(replica)] = run
            run["n"] += 1
            if provenance is not None:
                self._provenance.setdefault(str(design), {})[
                    str(replica)] = dict(provenance)
                if endpoint is not None:
                    self._prov_from[(str(design), str(replica))] = \
                        str(endpoint)
            if ok:
                self._failing.pop(key, None)
            else:
                self._failing[key] = {"design": str(design),
                                      "replica": str(replica),
                                      "reason": reason}
        _failing, prov = self._refresh_parity()
        if ok and prov["consistent"]:
            metrics.counter("canary_pass").inc()
        else:
            metrics.counter("canary_fail").inc()
        verdict = {"design": str(design), "replica": str(replica),
                   "ok": bool(ok and prov["consistent"]),
                   "golden_created": created, "reason": reason,
                   "provenance_ok": prov["consistent"], "key": key}
        log_event("canary_check", design=verdict["design"],
                  replica=verdict["replica"], ok=verdict["ok"],
                  reason=reason, provenance_ok=prov["consistent"],
                  key=str(key)[:24])
        return verdict

    def _refresh_parity(self):
        """Recompute the cross-replica provenance verdict from current
        state and publish the parity gauge + alert context.  Returns
        ``(failing, provenance_verdict)``."""
        with self._lock:
            prov_view = {d: dict(m) for d, m in self._provenance.items()}
        prov = alerts.provenance_consistency(prov_view,
                                             releases=_release_view())
        with self._lock:
            if prov["consistent"]:
                self._failing.pop("provenance", None)
            else:
                self._failing["provenance"] = {"splits": prov["splits"]}
            failing = {k: dict(v) for k, v in self._failing.items()}
        parity_ok = not failing
        metrics.gauge("canary_parity_ok").set(1.0 if parity_ok else 0.0)
        alerts.set_context(
            CONTEXT_KEY,
            None if parity_ok else {"failing": failing,
                                    "provenance": prov})
        return failing, prov

    def prune(self, replicas):
        """Forget canary state of replicas no longer in the fleet
        membership: a drained/evicted/replaced replica's provenance
        stamp must not ghost-split parity forever (a rolling upgrade
        REPLACES stamps, it does not accumulate them).  Goldens stay —
        they are content-addressed and replica-agnostic.

        ``replicas`` is the membership view: an iterable of replica
        ids, or ``{rid: {"addr", "port", ...}}`` (the router's live
        snapshot) — with endpoints, a stamp observed from an endpoint
        the rid no longer answers at is ALSO dropped (a same-rid
        takeover mid-rolling-upgrade: the old process's stamp would
        otherwise red-flag parity for one probe interval right as the
        expected-skew window closes).  Returns True when anything was
        dropped."""
        keep = {str(r) for r in replicas}
        endpoints = {}
        if isinstance(replicas, dict):
            for rid, info in replicas.items():
                if isinstance(info, dict) and "port" in info:
                    endpoints[str(rid)] = \
                        f"{info.get('addr')}:{info['port']}"
        changed = False
        reset_rids = set()
        with self._lock:
            for design in list(self._provenance):
                members = self._provenance[design]
                for rid in list(members):
                    seen_at = self._prov_from.get((design, rid))
                    stale = (rid not in keep
                             or (seen_at is not None
                                 and rid in endpoints
                                 and seen_at != endpoints[rid]))
                    if stale:
                        del members[rid]
                        self._prov_from.pop((design, rid), None)
                        reset_rids.add(rid)
                        changed = True
                if not members:
                    del self._provenance[design]
            for rid in list(self._probes):
                if rid not in keep or rid in reset_rids:
                    # departed or replaced: the observation run restarts
                    # for the new process (observe() also restarts it on
                    # its own when the probed endpoint changes)
                    del self._probes[rid]
                    changed = True
            for key in list(self._failing):
                if key != "provenance" and \
                        self._failing[key].get("replica") not in keep:
                    del self._failing[key]
                    changed = True
        if changed:
            self._refresh_parity()
        return changed

    # ------------------------------------------------------------ queries

    def summary(self):
        """JSON-ready canary state (joined into ``GET /alerts``)."""
        with self._lock:
            goldens = len(self._goldens)
            failing = {k: dict(v) for k, v in self._failing.items()}
            prov_view = {d: dict(m) for d, m in self._provenance.items()}
            probes = {rid: dict(run) for rid, run in self._probes.items()}
        return {
            "goldens": goldens,
            "passes": metrics.counter("canary_pass").value,
            "fails": metrics.counter("canary_fail").value,
            "probes": probes,
            "parity_ok": not failing,
            "failing": failing,
            "provenance": alerts.provenance_consistency(
                prov_view, releases=_release_view()),
        }


# ------------------------------------------------- replica-side goldens

_REPLICA_LOCK = threading.Lock()
#: the replica's own golden store, captured at warm-up (None until
#: RAFT_TPU_CANARY_S enables the canary path)
_REPLICA_CANARY: list = []  # raft-lint: guarded-by=_REPLICA_LOCK


def capture_goldens(entries, device=None, out_keys=None, state=None):
    """Replica-side warm-up capture: dispatch each registered design
    ONCE at the canary case through the production funnel
    (:func:`raft_tpu_torch.serve.engine.dispatch`) on ``device``
    (default: the current CUDA device; raises without one) and store
    the golden rows.  ``out_keys`` is the SERVER's dispatched out_keys
    tuple — the capture reuses the already-warmed program (dispatching
    a canary-only out_keys subset would mint a different bank key and
    fail a require-mode replica at startup); the golden stores only
    the canary subset.  Returns the :class:`CanaryState` (also
    installed as the process replica store ``GET /alerts`` reports)."""
    from raft_tpu_torch.serve import engine

    state = state if state is not None else CanaryState()
    served = tuple(out_keys) if out_keys else engine.DEFAULT_OUT_KEYS
    keys = canary_out_keys(served=served)
    Hs, Tp, beta = CANARY_CASE
    for entry in entries:
        out = engine.dispatch([entry], [Hs], [Tp], [beta],
                              out_keys=served, device=device,
                              record_metrics=False)
        row = {k: out[k][0] for k in keys}
        state.capture(golden_key(entry.fingerprint, CANARY_CASE, keys),
                      entry.name, CANARY_CASE, keys, row,
                      row["status"])
    with _REPLICA_LOCK:
        _REPLICA_CANARY[:] = [state]
    return state


def replica_summary():
    """The replica's golden-store summary for ``GET /alerts`` (None
    when the canary path is disabled)."""
    with _REPLICA_LOCK:
        state = _REPLICA_CANARY[0] if _REPLICA_CANARY else None
    return state.summary() if state is not None else None


# ---------------------------------------------------- router-side prober


def _http_evaluate(addr, port, design, case, out_keys, timeout_s=60.0):
    """One blocking probe request (canary THREAD only, never the event
    loop).  Returns ``(status_code, body_dict, provenance_dict)`` or
    None when the replica is unreachable/garbled — a dead replica is
    the membership prober's finding, not a canary failure."""
    Hs, Tp, beta = case
    payload = {"design": str(design), "Hs": Hs, "Tp": Tp, "beta": beta,
               "out_keys": list(out_keys), "client": "canary"}
    conn = http.client.HTTPConnection(addr, int(port), timeout=timeout_s)
    try:
        conn.request("POST", "/evaluate", body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              "X-Client": "canary"})
        resp = conn.getresponse()
        body = resp.read()
        headers = {k.lower(): v for k, v in resp.getheaders()}
        data = json.loads(body)
        if not isinstance(data, dict):
            return None
        return (resp.status, data,
                alerts.parse_provenance(headers.get("x-raft-provenance")))
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


class RouterCanary(threading.Thread):
    """Daemon thread probing every (replica, design) pair directly at
    its ledger endpoint every ``RAFT_TPU_CANARY_S`` seconds and
    feeding :class:`CanaryState` — low-rate by construction (one tiny
    request per pair per period; after the first probe per key the
    replica answers from its result cache)."""

    def __init__(self, state, canary=None, interval_s=None,
                 case=CANARY_CASE, probe=None):
        super().__init__(name="raft-router-canary", daemon=True)
        #: the router's RouterState (membership + design fingerprints)
        self.state = state
        self.canary = canary if canary is not None else CanaryState()
        self.interval_s = float(interval_s if interval_s is not None
                                else config.get("CANARY_S"))
        self.case = tuple(case)
        #: injectable probe fn (tests): (addr, port, design, case,
        #: out_keys) -> (status_code, body, provenance) | None
        self._probe = probe if probe is not None else _http_evaluate
        self._stop_evt = threading.Event()

    def probe_once(self):
        """One canary pass over the current membership; returns the
        verdict list."""
        snap = self.state.snapshot()
        # departed replicas (drained/evicted) must not ghost-split the
        # provenance parity view forever, and a REPLACED replica's
        # stamp (same rid, new endpoint after a rolling-upgrade
        # takeover) is the old process's — void it before comparing
        self.canary.prune(snap["replicas"])
        fingerprints = self.state.design_fingerprints()
        verdicts = []
        for rid, info in sorted(snap["replicas"].items()):
            # intersect with what THIS replica's lease says it serves
            # (replica-side capture does the same): probing an unserved
            # out_key would be a 400, not a canary verdict.  Pre-
            # out_keys leases declare nothing -> the configured default.
            served = self.state.served_out_keys(rid)
            out_keys = canary_out_keys(served=served or None)
            for design in info["designs"]:
                fp = fingerprints.get(design)
                if not fp:
                    continue  # no content hash -> no golden identity
                resp = self._probe(info["addr"], info["port"], design,
                                   self.case, out_keys)
                if resp is None:
                    continue  # dead/unreachable: membership's problem
                code, body, prov = resp
                if code not in (200, 422) or "status" not in body:
                    metrics.counter("canary_errors").inc()
                    continue
                verdicts.append(self.canary.observe(
                    design, rid, fp, self.case, out_keys,
                    decode_outputs(body.get("outputs")), body["status"],
                    provenance=prov,
                    endpoint=f"{info['addr']}:{info['port']}"))
        return verdicts

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:
                pass  # a bad pass must never kill the canary

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)

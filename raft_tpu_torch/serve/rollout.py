"""Canary-gated rolling upgrade of the serving fleet to a cut release
(the port's counterpart of ``raft_tpu/serve/rollout.py``).

The zero-downtime recipe, replica by replica ("surf replacement" — the
fleet never shrinks, a key never moves):

1. **resolve + preflight** — the candidate release manifest must
   verify (signature, content address, every entry present in the
   shared bank with its exact sha).  The builds were paid at warm-up/
   cut time; a rollout builds nothing.
2. **promote + mark** — flip ``releases/current.json`` to the
   candidate and write ``releases/rollout.json`` (``from``/``to``):
   from here until the marker clears, BOTH release ids are legitimate
   fleet members — the router canary's provenance-consistency check
   reads exactly this window (:func:`raft_tpu_torch.aot.release.
   parity_context`), so a mixed-version fleet mid-rollout is expected
   state, not an alarm.
3. **per replica: spawn → seize → drain → canary** — spawn the
   upgraded process under the manifest's captured flag environment
   (``--takeover``, on the fleet's ``--device``): it warms from the
   bank, binds, then atomically
   SEIZES the same replica id's lease (same ring vnodes — the router
   sees one endpoint change, no key movement) and only then is the
   old process drained (in-flight work finishes behind the failover
   ladder).  The step passes once the router's canary has probed the
   mixed fleet green (``ROLLOUT_CANARY_PROBES`` fresh passes, zero
   fresh fails, parity ok) with no firing alert.
4. **automatic rollback** — ANY step failure (join timeout, red
   canary, firing alert) re-points ``current`` at the parent release
   and rolls the already-upgraded replicas back the same seize-and-
   drain way.  No operator input; the run record names the aborted
   release.

The whole rollout emits one ``rollout`` span (steps as child spans,
spawned replicas stitched in via traceparent propagation), a
``rollout_*`` event stream, and one ``rollout`` run record
(:mod:`raft_tpu_torch.obs.runs`) — the ``rollout-record`` schema family.

``FleetOps`` isolates every side effect (ledger reads, process spawn,
drain POSTs, canary verdicts) behind one injectable seam, so the
state machine is unit-testable without sockets or subprocesses.
"""

from __future__ import annotations

import http.client
import json
import time

from raft_tpu_torch.obs import metrics, runs
from raft_tpu_torch.obs.spans import propagation_env, span
from raft_tpu_torch.serve import fleet
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event


def _http_get_json(url, path, timeout_s=5.0):
    """Blocking GET of ``{url}{path}``; parsed body or None."""
    base = url.split("//", 1)[-1].rstrip("/")
    host, _, port = base.partition(":")
    conn = http.client.HTTPConnection(host, int(port or 80),
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return None
        return json.loads(body)
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


def _http_drain(addr, port, timeout_s=5.0):
    """POST /drain to one replica endpoint (loopback admin); True when
    the replica acknowledged (202/200)."""
    conn = http.client.HTTPConnection(addr, int(port), timeout=timeout_s)
    try:
        conn.request("POST", "/drain", body=b"{}",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status in (200, 202)
    except (OSError, http.client.HTTPException):
        return False
    finally:
        conn.close()


def gate_decision(payload, baseline, need, replica=None, endpoint=None):
    """Pure per-poll gate decision for one rollout step from one
    ``/alerts`` payload snapshot: ``("green"|"red"|"pending",
    reason)``.  Green requires ``need`` observations of the replaced
    ``replica`` at its post-seize ``endpoint`` specifically (the
    canary's per-replica observation run restarts on an endpoint
    change, so its count is the new process's probe count); without a
    replica/endpoint the gate falls back to fleet-wide fresh passes.
    Factored out of :meth:`FleetOps.canary_verdict` so a model checker
    can interleave the REAL gate against the canary state machine —
    the fleet-wide-pass race (green off the candidate's neighbours)
    lives exactly here."""
    can = (payload or {}).get("canary")
    if not can:
        return "pending", "no-canary"
    fails = int(can.get("fails") or 0) - baseline["fails"]
    if fails > 0:
        return "red", "canary-fail"
    if not can.get("parity_ok", True):
        return "red", "canary-parity"
    active = (payload or {}).get("active") or []
    if active:
        names = sorted(a.get("rule") or "?" for a in active)
        return "red", "alert:" + ",".join(names)
    if replica is not None and endpoint:
        run = (can.get("probes") or {}).get(str(replica)) or {}
        fresh = (int(run.get("n") or 0)
                 if run.get("endpoint") == str(endpoint) else 0)
    else:
        fresh = int(can.get("passes") or 0) - baseline["passes"]
    if fresh >= need:
        return "green", f"canary-green({fresh})"
    return "pending", "waiting"


class FleetOps:
    """The rollout driver's side-effect seam against a real fleet:
    ledger reads, takeover spawns, drain POSTs and router-canary
    verdicts.  Tests inject a fake with the same five methods.
    ``device`` is forwarded to every spawned replica (``--device``)."""

    def __init__(self, root, designs_spec, router_url=None, device=None):
        self.root = root
        self.designs_spec = list(designs_spec)
        self.router_url = router_url
        self.device = device
        self.ledger = fleet.FleetLedger(root)
        self.poll_s = float(config.get("ROLLOUT_POLL_S"))

    def live(self):
        return self.ledger.live()

    def spawn_takeover(self, rid, env):
        """Spawn the upgraded replica under the release's captured
        flag environment; it seizes ``rid``'s lease after warm+bind.
        The traceparent env stitches it into the rollout trace."""
        wenv = dict(env or {})
        wenv.update(propagation_env())
        proc, _rid = fleet.spawn_replica(
            self.root, self.designs_spec, replica_id=rid, env=wenv,
            extra_args=["--takeover"], device=self.device)
        return proc

    def wait_takeover(self, rid, prev_rec, timeout_s, proc=None):
        """Block until ``rid``'s lease changed hands (token differs
        from the previous owner's) and is live; the new lease record,
        or None on timeout / candidate death."""
        deadline = time.monotonic() + float(timeout_s)
        prev_token = (prev_rec or {}).get("token")
        while time.monotonic() < deadline:
            if proc is not None and proc.poll() is not None:
                return None  # candidate died before seizing (see log)
            rec = self.live().get(rid)
            if rec is not None and rec.get("token") != prev_token:
                return rec
            time.sleep(self.poll_s)
        return None

    def drain(self, rec):
        """Drain the PREVIOUS owner of a seized lease at its old
        endpoint (the lease already names the new one)."""
        if not rec or not rec.get("port"):
            return False
        return _http_drain(rec.get("addr") or "127.0.0.1", rec["port"])

    def canary_baseline(self):
        """Pass/fail counters before a step, so the gate only credits
        FRESH probe results; None when no router canary is attached."""
        if not self.router_url:
            return None
        payload = _http_get_json(self.router_url, "/alerts")
        can = (payload or {}).get("canary")
        if not can:
            return None
        return {"passes": int(can.get("passes") or 0),
                "fails": int(can.get("fails") or 0)}

    def canary_verdict(self, baseline, timeout_s, replica=None,
                       endpoint=None):
        """Gate one step on the live router canary: green needs
        ``ROLLOUT_CANARY_PROBES`` probes **of the replaced replica at
        its post-seize endpoint** (the canary's per-replica observation
        run restarts when the probed endpoint changes, so its count IS
        the new process's probe count — fleet-wide passes from healthy
        neighbors, and probes of the OLD process still answering its
        drain window, can never green the gate before the candidate
        was observed), with zero fresh fails anywhere, parity ok, and
        no active alert.  Returns ``(ok, reason)``; skipped (no
        router/canary attached) counts as green — standalone fleets
        can still roll.  Without ``replica``/``endpoint`` the gate
        falls back to fleet-wide fresh passes."""
        if not self.router_url or baseline is None:
            return True, "canary-skipped"
        need = int(config.get("ROLLOUT_CANARY_PROBES"))
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            payload = _http_get_json(self.router_url, "/alerts")
            verdict, reason = gate_decision(payload, baseline, need,
                                            replica=replica,
                                            endpoint=endpoint)
            if verdict != "pending":
                return verdict == "green", reason
            time.sleep(self.poll_s)
        return False, "canary-timeout"


def _upgrade_one(ops, rid, prev_rec, env, timeout_s):
    """One surf replacement: spawn under ``env``, wait for the seize,
    drain the old owner, gate on the canary.  ``(ok, reason)``."""
    baseline = ops.canary_baseline()
    proc = ops.spawn_takeover(rid, env)
    rec = ops.wait_takeover(rid, prev_rec, timeout_s, proc=proc)
    if rec is None:
        return False, "join-timeout"
    ops.drain(prev_rec)
    endpoint = f"{rec.get('addr') or '127.0.0.1'}:{rec.get('port')}"
    return ops.canary_verdict(baseline, timeout_s, replica=rid,
                              endpoint=endpoint)


def build_record(to_release, from_release, ok, replaced, rolled_back,
                 reason, steps, wall_s):
    """The ``rollout-record`` payload embedded in the run record's
    ``extra`` block — names the candidate (and, on rollback, the
    ABORTED release sha the postmortem greps for)."""
    record = {
        "to": to_release,
        "from": from_release,
        "ok": bool(ok),
        "replaced": list(replaced),
        "rolled_back": bool(rolled_back),
        "aborted": (to_release if rolled_back else None),
        "reason": reason,
        "steps": list(steps),
        "wall_s": round(float(wall_s), 3),
    }
    return record


def summarize_record(record):
    """One console line from a rollout record (CLI footer + drill
    assertions)."""
    verb = ("rolled back" if record.get("rolled_back")
            else "upgraded" if record["ok"] else "failed")
    n = len(record.get("replaced") or ())
    return (f"rollout {record['to']}: {verb} ({n} replaced, "
            f"reason={record.get('reason') or 'clean'}, "
            f"{record.get('wall_s')}s)")


def run_rollout(root, to_release, designs_spec, router_url=None,
                ops=None, device=None):
    """Drive one canary-gated rolling upgrade of the fleet at ``root``
    to ``to_release``; returns the rollout record (see
    :func:`build_record`).  ``device`` is the upgraded replicas'
    ``--device``.  Exceptions before the promote leave the fleet
    untouched; any failure after it triggers automatic rollback."""
    from raft_tpu_torch.aot import release

    t0 = time.monotonic()
    man = release.load_release(to_release)
    if man is None:
        raise FileNotFoundError(
            f"no release {to_release!r} under {release.releases_dir()} "
            "(cut + verify it first)")
    problems = release.verify_manifest(man) \
        or release.verify_against_bank(man)
    if problems:
        raise ValueError(f"refusing to roll out {to_release}: "
                         + "; ".join(problems))
    from_release = release.current_release()
    parent_man = release.load_release(from_release) \
        if from_release else None
    ops = ops if ops is not None else FleetOps(root, designs_spec,
                                               router_url=router_url,
                                               device=device)
    timeout_s = float(config.get("ROLLOUT_HEALTH_TIMEOUT_S"))
    fleet_now = ops.live()
    order = sorted(fleet_now)
    steps, upgraded = [], []
    ok, reason = True, None
    with span("rollout", to=to_release):
        log_event("rollout_start", to=to_release,
                  **{"from": from_release}, replicas=order, root=root)
        release.promote(to_release)
        release.write_rollout_marker(from_release, to_release)
        try:
            for rid in order:
                st = time.monotonic()
                with span("rollout_step", replica=rid):
                    step_ok, why = _upgrade_one(
                        ops, rid, fleet_now[rid], man.get("env") or {},
                        timeout_s)
                wall = round(time.monotonic() - st, 3)
                log_event("rollout_step", replica=rid, phase="upgrade",
                          ok=step_ok, wall_s=wall)
                steps.append({"replica": rid, "phase": "upgrade",
                              "ok": step_ok, "reason": why,
                              "wall_s": wall})
                # the seize may have landed even when the canary then
                # failed — the candidate owns the lease and must be
                # rolled back with the green ones
                upgraded.append(rid)
                if not step_ok:
                    ok, reason = False, why
                    break
            if not ok and from_release:
                metrics.counter("rollout_rollbacks").inc()
                log_event("rollout_rollback", to=from_release,
                          reason=reason, aborted=to_release)
                release.promote(from_release)
                for rid in upgraded:
                    st = time.monotonic()
                    prev = ops.live().get(rid) or fleet_now.get(rid)
                    with span("rollout_step", replica=rid,
                              phase="rollback"):
                        back_ok, back_why = _upgrade_one(
                            ops, rid, prev,
                            (parent_man or {}).get("env") or {},
                            timeout_s)
                    wall = round(time.monotonic() - st, 3)
                    log_event("rollout_step", replica=rid,
                              phase="rollback", ok=back_ok, wall_s=wall)
                    steps.append({"replica": rid, "phase": "rollback",
                                  "ok": back_ok, "reason": back_why,
                                  "wall_s": wall})
        finally:
            release.clear_rollout_marker()
        wall_s = time.monotonic() - t0
        log_event("rollout_done", to=to_release, ok=ok,
                  replaced=len(upgraded if ok else ()),
                  rolled_back=not ok, wall_s=round(wall_s, 3))
    record = build_record(to_release, from_release, ok,
                          upgraded if ok else [], not ok, reason,
                          steps, wall_s)
    runs.maybe_record("rollout", label=to_release, wall_s=wall_s,
                      extra=record)
    return record

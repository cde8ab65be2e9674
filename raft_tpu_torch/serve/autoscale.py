"""SLO-driven autoscaler for the serving fleet (router-side daemon; the
port's counterpart of ``raft_tpu/serve/autoscale.py``).

Scaling signals are the fleet's EXISTING telemetry — nothing new is
measured:

* **scale OUT** on sustained alert pressure: the router's alert
  engine (:func:`raft_tpu_torch.obs.alerts.installed_engine`) firing
  ``slo-breach`` or ``breaker-storm`` means the fleet is missing its
  latency SLO or shedding replicas — more capacity, started from the
  shared program bank, builds nothing;
* **scale IN** on sustained low occupancy: every replica's lease
  health snapshot carries ``busy_s`` (the cumulative solve wall of
  every dispatch the replica ran — :func:`raft_tpu_torch.serve.engine.
  busy_s`, the port's stand-in for the reference's banked-program
  cost ledger), so lease-to-lease deltas give a fleet busy-fraction
  without touching any replica.

The hysteresis/for-duration/cooldown state machine is NOT reinvented:
the two conditions are private :class:`~raft_tpu_torch.obs.alerts.Rule`
entries (``autoscale-hot`` above 0.5 pressure for
``RAFT_TPU_AUTOSCALE_OUT_FOR_S``; ``autoscale-cold`` below
``RAFT_TPU_AUTOSCALE_LOW_OCC`` occupancy for the longer
``RAFT_TPU_AUTOSCALE_IN_FOR_S``) evaluated by a private
:class:`~raft_tpu_torch.obs.alerts.AlertEngine` with an injectable clock —
exactly the engine the default pack runs on, so the for-duration and
resolve-hysteresis semantics are the drill-tested ones.  On top of
the rule durations: hard ``[AUTOSCALE_MIN, AUTOSCALE_MAX]`` bounds,
one action per tick, and ``AUTOSCALE_COOLDOWN_S`` between actions
(scale-out must not immediately un-scale on the next tick's stale
occupancy — the anti-flap guard the drill asserts).

Scale-out spawns a replica through :func:`raft_tpu_torch.serve.fleet.
spawn_replica` (it joins via the normal lease path); scale-in POSTs
``/drain`` to the NEWEST joiner (LIFO — the operator's baseline
capacity is the last to go) and lets drain-equals-release remove it
from the ring.  Zero overhead when ``RAFT_TPU_AUTOSCALE_EVAL_S`` is
unset: no thread, no state.

Replicas that share one card time-share it, so scale-out there raises
*availability* and queue fairness, not aggregate throughput — the
drill asserts the control loop (signals, bounds, cooldown, no flap),
not a throughput win.  With a card per replica the same loop buys real
capacity.
"""

from __future__ import annotations

import threading
import time

from raft_tpu_torch.obs import alerts, metrics
from raft_tpu_torch.serve import fleet
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

#: alert rules whose sustained firing means "under-capacity"
PRESSURE_RULES = ("slo-breach", "breaker-storm")


def scaling_rules():
    """The two private for-duration rules the autoscaler evaluates
    (hysteresis both ways: a condition must HOLD to act and must stay
    clean to re-arm)."""
    out_for = float(config.get("AUTOSCALE_OUT_FOR_S"))
    in_for = float(config.get("AUTOSCALE_IN_FOR_S"))
    return [
        alerts.Rule("autoscale-hot", "gauge:autoscale_pressure:value",
                    "above", threshold=0.5, for_s=out_for,
                    clear_s=out_for, severity="info",
                    help="sustained slo-breach/breaker-storm pressure "
                         "— the fleet wants another replica"),
        alerts.Rule("autoscale-cold", "gauge:autoscale_occupancy:value",
                    "below",
                    threshold=float(config.get("AUTOSCALE_LOW_OCC")),
                    for_s=in_for, clear_s=in_for, severity="info",
                    help="sustained low dispatch occupancy — the "
                         "fleet is over-provisioned"),
    ]


class FleetBackend:
    """The autoscaler's side-effect seam against a real fleet: lease
    reads, alert pressure, replica spawn and drain.  Tests inject a
    fake with the same four observers + two actuators.  ``device`` is
    forwarded to every spawned replica (``--device``)."""

    def __init__(self, root, designs_spec=(), clock=time.monotonic,
                 device=None):
        self.root = root
        self.designs_spec = list(designs_spec)
        self.device = device
        self.ledger = fleet.FleetLedger(root)
        self._clock = clock
        self._busy: dict = {}    # rid -> (busy_s, t) previous sample
        self._spawned = 0
        self._procs: list = []   # keep Popen handles (no zombie reap race)

    def n_replicas(self):
        return len(self.ledger.live())

    def occupancy(self):
        """Fleet busy-fraction in [0, 1]: mean per-replica rate of
        ``healthz.busy_s`` (the replica's dispatch solve wall) between
        consecutive samples.  0.0 until two samples exist — a cold
        autoscaler must not scale in on ignorance alone (the cold
        rule's for-duration covers the warm-up window)."""
        now = self._clock()
        live = self.ledger.live()
        fracs = []
        for rid, rec in live.items():
            busy = float((rec.get("healthz") or {}).get("busy_s") or 0.0)
            prev = self._busy.get(rid)
            self._busy[rid] = (busy, now)
            if prev is None or now <= prev[1]:
                continue
            frac = max(0.0, busy - prev[0]) / (now - prev[1])
            fracs.append(min(1.0, frac))
        self._busy = {rid: v for rid, v in self._busy.items()
                      if rid in live}
        return sum(fracs) / len(fracs) if fracs else 0.0

    def pressure(self):
        """1.0 while the process's installed alert engine has a
        :data:`PRESSURE_RULES` member actively firing, else 0.0 — the
        autoscaler rides the default pack's own for-duration/clear
        state, it does not re-derive SLO math."""
        engine = alerts.installed_engine()
        if engine is None:
            return 0.0
        names = {a.get("rule") for a in engine.active()}
        return 1.0 if names & set(PRESSURE_RULES) else 0.0

    def scale_out(self):
        """Spawn one replica into the fleet (normal lease join path);
        its replica id, or None when no designs spec was given (a
        design-less router can only scale in)."""
        if not self.designs_spec:
            return None
        self._spawned += 1
        proc, rid = fleet.spawn_replica(
            self.root, self.designs_spec, device=self.device,
            index=1000 + self._spawned)  # clear of operator indices:
        # the replica-fault forwarding (FLEET_FAULT_REPLICA) must never
        # target an autoscaler spawn
        self._procs.append(proc)
        return rid

    def scale_in(self):
        """Drain the NEWEST joiner (LIFO); drain-equals-release drops
        it from the ring, the failover ladder finishes its in-flight
        work.  Returns the drained replica id, or None."""
        from raft_tpu_torch.serve.rollout import _http_drain

        live = self.ledger.live()
        if not live:
            return None
        rid = max(live, key=lambda r: float(live[r].get("claimed_t")
                                            or 0.0))
        rec = live[rid]
        if not _http_drain(rec.get("addr") or "127.0.0.1",
                           rec.get("port") or 0):
            return None
        return rid


class Autoscaler(threading.Thread):
    """Daemon thread ticking :meth:`step` every
    ``RAFT_TPU_AUTOSCALE_EVAL_S`` seconds.  All policy state (rule
    durations via a private :class:`~raft_tpu_torch.obs.alerts.AlertEngine`,
    cooldown, bounds) lives here; all side effects live in the
    injectable ``backend``."""

    def __init__(self, root=None, designs_spec=(), backend=None,
                 clock=time.monotonic, interval_s=None, minimum=None,
                 maximum=None, cooldown_s=None, device=None):
        super().__init__(name="raft-autoscale", daemon=True)
        self.backend = backend if backend is not None \
            else FleetBackend(root, designs_spec, clock=clock,
                              device=device)
        self._clock = clock
        self.interval_s = float(interval_s if interval_s is not None
                                else config.get("AUTOSCALE_EVAL_S"))
        self.minimum = int(minimum if minimum is not None
                           else config.get("AUTOSCALE_MIN"))
        self.maximum = int(maximum if maximum is not None
                           else config.get("AUTOSCALE_MAX"))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else config.get("AUTOSCALE_COOLDOWN_S"))
        self.engine = alerts.AlertEngine(rules=scaling_rules(),
                                         sink_path=None, clock=clock)
        self._last_action_t = None
        self._stop_evt = threading.Event()

    def step(self, now=None):
        """One control tick.  Returns ``None`` or ``("out"|"in",
        replica_id)`` — at most one action per tick, bounded,
        cooldown-gated."""
        now = self._clock() if now is None else float(now)
        press = float(self.backend.pressure())
        occ = float(self.backend.occupancy())
        metrics.gauge("autoscale_pressure").set(press)
        metrics.gauge("autoscale_occupancy").set(occ)
        self.engine.evaluate({"gauge:autoscale_pressure:value": press,
                              "gauge:autoscale_occupancy:value": occ},
                             now=now)
        active = {a["rule"] for a in self.engine.active()}
        n = int(self.backend.n_replicas())
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self.cooldown_s)
        if cooling:
            return None
        if "autoscale-hot" in active and n < self.maximum:
            rid = self.backend.scale_out()
            if rid is not None:
                self._last_action_t = now
                metrics.counter("autoscale_outs").inc()
                log_event("autoscale_out", replicas=n + 1,
                          reason="pressure", pressure=press)
                return "out", rid
        elif "autoscale-cold" in active and "autoscale-hot" not in active \
                and n > self.minimum:
            rid = self.backend.scale_in()
            if rid is not None:
                self._last_action_t = now
                metrics.counter("autoscale_ins").inc()
                log_event("autoscale_in", replica=rid, replicas=n - 1,
                          reason="low-occupancy",
                          occupancy=round(occ, 4))
                return "in", rid
        return None

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                pass  # a bad tick must never kill the router

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)

"""Replica membership ledger of the horizontal serving fleet (the port's
counterpart of ``raft_tpu/serve/fleet.py``, on the same on-disk format).

One serving process became N **replica** processes, each running
:mod:`raft_tpu_torch.serve` from the SAME program bank, fronted by the
consistent-hash failover router (:mod:`raft_tpu_torch.serve.router`).
Membership and liveness are the fabric's lease model verbatim — this
module reuses the atomic primitives the sweep fabric trusts
(:func:`raft_tpu_torch.parallel.fabric.lease_claim` / ``lease_read`` /
``lease_rewrite`` / ``lease_remove``):

* **claim = join** — a replica that bound its socket (and finished its
  warm-up) claims ``<root>/_fleet/replicas/<rid>.json`` with
  ``O_CREAT|O_EXCL``; the lease body carries its port, the bucket
  signatures + design content fingerprints it serves (the router's
  hash-ring routing keys) and a small health snapshot;
* **renewed lease = alive** — a daemon renewer rewrites the lease
  (tmp + ``os.replace``) every ``ttl/3``, refreshing ``renewed_t`` and
  the health snapshot;
* **expired lease = dead** — a replica that stops renewing (SIGKILL,
  OOM, wedged host) simply ages out: the router evicts the lease
  (atomic rename — exactly one evictor wins) and drops the replica
  from its ring;
* **drain = release** — graceful shutdown releases the lease at drain
  START (``POST /drain`` / SIGTERM), so the router stops routing new
  work to a draining replica while it finishes the accepted work.

The ledger needs a shared filesystem and nothing else — the same
requirement the program bank and the sweep fabric already have.  The
JAX package's ledger and this one read each other's lease directories.

``run_fleet`` is the local coordinator (``python -m raft_tpu_torch.serve
fleet --replicas N``): optionally warm the shared bank once, spawn N
replica server subprocesses, wait for their leases, forward SIGTERM.
Replica *i* runs on the device the caller names (``--device``); with
several visible cards it is pinned the way a fabric worker is
(:func:`raft_tpu_torch.parallel.fabric._worker_device_env`), with one
card every replica runs on ``cuda:0``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.parallel import fabric, resilience
from raft_tpu_torch.parallel.fabric import (lease_claim, lease_read,
                                            lease_remove, lease_rewrite)
from raft_tpu_torch.utils import config, fsops
from raft_tpu_torch.utils.structlog import log_event

FLEET_DIRNAME = "_fleet"

#: fault kinds targeted at one replica (stripped from the rest by the
#: coordinator, like the fabric's worker_kill forwarding).
#: ``provenance_skew`` perturbs the replica's reported bank/code
#: identity at startup — the canary drill's deterministic stand-in for
#: a stale-banked or env-skewed replica
REPLICA_FAULT_KINDS = ("replica_kill", "replica_hang", "replica_5xx",
                       "provenance_skew")


def fleet_dir(root):
    return os.path.join(root, FLEET_DIRNAME)


def _replicas_dir(root):
    return os.path.join(fleet_dir(root), "replicas")


def _lease_path(root, rid):
    return os.path.join(_replicas_dir(root), f"{rid}.json")


def router_record_path(root):
    return os.path.join(fleet_dir(root), "router.json")


def read_router_record(root):
    """The router's last published membership record, or None."""
    try:
        return json.loads(fsops.read_text(router_record_path(root)))
    except (OSError, ValueError):
        return None


class FleetLedger:
    """The replica-membership ledger rooted at ``root`` (usually the
    serving deploy directory next to the program bank).  Replica-side
    methods (:meth:`claim`/:meth:`seize`/:meth:`renew`/:meth:`release`)
    are token-guarded like fabric shard leases; observer-side methods
    (:meth:`replicas`/:meth:`live`/:meth:`expired`/:meth:`evict`) are
    what the router's membership prober runs."""

    def __init__(self, root, replica_id=None):
        self.root = root
        self.replica_id = replica_id
        self.token = uuid.uuid4().hex
        # what this replica's seize installed and the token it displaced
        # (None: it claimed, or seized no one's)
        self._seized = None
        self._displaced = None
        # NO mkdir here: read-side users (fleet --status, the router's
        # prober) must not conjure a ledger tree under a typo'd path —
        # the write path (claim) creates it

    # ------------------------------------------------------ replica side

    def _record(self, port, host, designs, buckets, healthz, out_keys):
        now = time.time()
        return {
            "replica": self.replica_id,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "addr": str(host),
            "port": int(port),
            "claimed_t": now,
            "renewed_t": now,
            "ttl_s": float(config.get("FLEET_TTL_S")),
            "designs": dict(designs or {}),
            "buckets": list(buckets or ()),
            "out_keys": list(out_keys or ()),
            "healthz": dict(healthz or {}),
            "token": self.token,
        }

    def claim(self, port, host="127.0.0.1", designs=None, buckets=None,
              healthz=None, out_keys=None):
        """Join the fleet: exclusive lease creation for this replica id.
        ``designs`` maps served design name -> {"sig": bucket-signature
        fingerprint, "fingerprint": design content hash} (the router
        hashes these into its ring keys); ``buckets`` is the distinct
        signature fingerprint list; ``out_keys`` is the out_keys tuple
        this replica dispatches (the router canary intersects its probe
        keys with this — a probe asking for an unserved key is a 400)."""
        fsops.makedirs(_replicas_dir(self.root), exist_ok=True)
        rec = self._record(port, host, designs, buckets, healthz, out_keys)
        if not lease_claim(_lease_path(self.root, self.replica_id), rec):
            return False
        metrics.counter("fleet_joins").inc()
        log_event("replica_join", replica=self.replica_id, port=int(port),
                  designs=sorted(rec["designs"]), root=self.root)
        return True

    def seize(self, port, host="127.0.0.1", designs=None, buckets=None,
              healthz=None, out_keys=None):
        """TAKE OVER an existing lease: unconditionally rewrite the
        replica id's lease with THIS process's record + token (one
        atomic rename — readers see the old owner or the new one,
        never a gap in membership).  The rolling-upgrade replacement
        path: the upgraded process warms + binds first, seizes the
        SAME rid (same ring vnodes — zero key movement), and only then
        is the old process drained; the old owner's renew/release no-op
        on the token mismatch.  Outside a rollout, prefer :meth:`claim`
        — seizing a healthy stranger's lease is an operator error this
        method will happily commit.

        A renewal of the displaced owner that read the lease before this
        rewrite writes its own record back after it (a lost update: the
        seize would never show).  This replica's :meth:`renew` then
        takes the lease again, while the displaced owner's next renewal
        reads this token and stops."""
        fsops.makedirs(_replicas_dir(self.root), exist_ok=True)
        prev, _ = self.read(self.replica_id)
        rec = self._record(port, host, designs, buckets, healthz, out_keys)
        self._seized = dict(rec)
        self._displaced = (prev or {}).get("token")
        lease_rewrite(_lease_path(self.root, self.replica_id), rec)
        metrics.counter("fleet_takeovers").inc()
        log_event("replica_takeover", replica=self.replica_id,
                  port=int(port),
                  prev_port=(prev or {}).get("port"), root=self.root)
        return True

    def renew(self, healthz=None):
        """Refresh ``renewed_t`` (+ the health snapshot); False when
        the lease is no longer this replica's (evicted or released) —
        the renewer does NOT re-claim: an evicted replica rejoining
        must go through the explicit join path.  After a :meth:`seize`,
        a lease that holds the displaced owner's token again (its
        renewal wrote over the seize) is taken again."""
        rec, _ = self.read(self.replica_id)
        if (rec and self._displaced is not None
                and rec.get("token") == self._displaced):
            prev_port = rec.get("port")
            rec = dict(self._seized)
            log_event("replica_takeover", replica=self.replica_id,
                      port=int(rec["port"]), prev_port=prev_port,
                      root=self.root)
        if not rec or rec.get("token") != self.token:
            return False
        rec["renewed_t"] = time.time()
        if healthz is not None:
            rec["healthz"] = dict(healthz)
        lease_rewrite(_lease_path(self.root, self.replica_id), rec)
        return True

    def release(self, reason="drain"):
        """Leave the fleet (drain start / clean exit).  True when this
        call removed the lease."""
        rec, _ = self.read(self.replica_id)
        if not rec or rec.get("token") != self.token:
            return False
        removed = lease_remove(_lease_path(self.root, self.replica_id))
        if removed:
            log_event("replica_drain", replica=self.replica_id,
                      reason=str(reason), root=self.root)
        return removed

    # ----------------------------------------------------- observer side

    def read(self, rid):
        return lease_read(_lease_path(self.root, rid))

    def replicas(self):
        """Every readable lease: ``{replica_id: (record, mtime)}``."""
        out = {}
        try:
            names = fsops.listdir(_replicas_dir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec, mtime = lease_read(os.path.join(_replicas_dir(self.root),
                                                 name))
            if rec is not None:
                out[name[:-5]] = (rec, mtime)
        return out

    @staticmethod
    def lease_age(rec, mtime, now=None):
        """Seconds since the lease was last renewed."""
        now = time.time() if now is None else now
        return now - float(rec.get("renewed_t") or mtime or now)

    @staticmethod
    def _ttl(rec):
        return float(rec.get("ttl_s") or config.get("FLEET_TTL_S"))

    def live(self, now=None):
        """``{replica_id: record}`` of every lease renewed within its
        TTL — the router's ring membership source."""
        now = time.time() if now is None else now
        return {rid: rec for rid, (rec, mtime) in self.replicas().items()
                if self.lease_age(rec, mtime, now) <= self._ttl(rec)}

    def expired(self, now=None):
        """``{replica_id: (record, age_s)}`` of leases past their TTL
        (dead replicas awaiting eviction)."""
        now = time.time() if now is None else now
        out = {}
        for rid, (rec, mtime) in self.replicas().items():
            age = self.lease_age(rec, mtime, now)
            if age > self._ttl(rec):
                out[rid] = (rec, age)
        return out

    def evict(self, rid, reason="expired", age_s=None):
        """Atomically remove a dead replica's lease (router-side).
        True when THIS caller won the removal race."""
        if not lease_remove(_lease_path(self.root, rid)):
            return False
        metrics.counter("fleet_evictions").inc()
        log_event("replica_evict", replica=rid, reason=str(reason),
                  age_s=round(float(age_s), 3) if age_s is not None
                  else None, root=self.root)
        return True

    def summary(self, now=None):
        """Ledger snapshot for the ``fleet --status`` CLI / tests."""
        now = time.time() if now is None else now
        reps = {}
        for rid, (rec, mtime) in self.replicas().items():
            age = self.lease_age(rec, mtime, now)
            reps[rid] = {
                "port": rec.get("port"),
                "pid": rec.get("pid"),
                "designs": sorted(rec.get("designs") or ()),
                "age_s": round(age, 3),
                "live": age <= self._ttl(rec),
            }
        router = read_router_record(self.root)
        out = {
            "root": self.root,
            "replicas": reps,
            "n_live": sum(1 for r in reps.values() if r["live"]),
            "router": None,
        }
        if router:
            out["router"] = {
                "t": router.get("t"),
                "pid": router.get("pid"),
                "n_replicas": router.get("n_replicas"),
                "replicas": sorted(router.get("replicas") or ()),
            }
        return out


class LeaseRenewer(threading.Thread):
    """Daemon thread renewing a replica's fleet lease every ``ttl/3``
    (the fabric ``_Renewer`` pattern).  ``healthz`` is an optional
    callable returning the snapshot dict to refresh in the lease body
    — it runs on THIS thread, off the server's event loop."""

    def __init__(self, ledger, healthz=None):
        super().__init__(name=f"raft-fleet-lease-{ledger.replica_id}",
                         daemon=True)
        self.ledger = ledger
        self.healthz = healthz
        ttl = float(config.get("FLEET_TTL_S"))
        self.interval_s = max(ttl / 3.0, 0.05)
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                snap = self.healthz() if self.healthz is not None else None
                self.ledger.renew(healthz=snap)
            except Exception:
                pass  # renewal must never kill the server

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)


# ------------------------------------------------------- local coordinator


def _strip_replica_faults(env, index):
    """Forward the replica-targeted fault kinds to exactly ONE spawned
    replica (``RAFT_TPU_FLEET_FAULT_REPLICA``), stripping them from the
    rest — every replica arming ``replica_kill`` from a shared
    environment would kill the whole fleet once each."""
    fspecs = env.get(config.env_name("FAULTS"), "")
    if fspecs and index != int(config.get("FLEET_FAULT_REPLICA")):
        kept = [s for s in fspecs.split(",") if s.strip()
                and s.strip().split(":")[0] not in REPLICA_FAULT_KINDS]
        env[config.env_name("FAULTS")] = ",".join(kept)
    return env


def spawn_replica(root, designs_spec, index=0, replica_id=None,
                  host="127.0.0.1", env=None, extra_args=(), device=None,
                  replicas_total=1):
    """Spawn one replica server subprocess (``python -m
    raft_tpu_torch.serve``) against the fleet ledger at ``root``
    (ephemeral port; the lease carries the real one).  ``device`` is
    forwarded as ``--device`` when given; with several visible cards
    replica ``index`` of ``replicas_total`` is pinned as a fabric worker
    is.  stdout/stderr land in ``_fleet/replicas/<rid>.log``.  Returns
    ``(Popen, replica_id)``."""
    rid = replica_id or f"r{index}-{uuid.uuid4().hex[:6]}"
    wenv = dict(os.environ)
    wenv.update(fabric._worker_device_env(index, int(replicas_total)))
    wenv.update(env or {})
    _strip_replica_faults(wenv, index)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    old_pp = wenv.get("PYTHONPATH", "")
    wenv["PYTHONPATH"] = repo + (os.pathsep + old_pp if old_pp else "")
    # every fleet replica leaves a black box: unless the operator
    # pointed the flight recorder elsewhere, its dumps land next to
    # the replica logs — a SIGKILLed replica's last seconds are then
    # one `obs trace --merge` away from its survivors' story
    wenv.setdefault(
        config.env_name("FLIGHT_DIR"),
        os.path.abspath(os.path.join(_replicas_dir(root), "flight")))
    fsops.makedirs(_replicas_dir(root), exist_ok=True)
    logf = open(os.path.join(_replicas_dir(root), f"{rid}.log"), "ab")
    argv = [sys.executable, "-m", "raft_tpu_torch.serve"]
    for spec in designs_spec:
        argv += ["--designs", spec]
    argv += ["--host", host, "--port", "0",
             "--fleet-dir", os.path.abspath(root), "--replica-id", rid]
    if device is not None:
        argv += ["--device", str(device)]
    argv += list(extra_args)
    try:
        proc = subprocess.Popen(argv, env=wenv, stdout=logf,
                                stderr=subprocess.STDOUT, cwd=repo)
    finally:
        logf.close()  # the child keeps its own handle
    log_event("fleet_spawn", root=root, replica=rid, pid=proc.pid)
    return proc, rid


def design_paths(designs_spec):
    """The design paths of ``--designs`` specs (``name=path`` or a bare
    path, comma lists allowed)."""
    return [s.split("=", 1)[1] if "=" in s else s
            for spec in designs_spec for s in spec.split(",") if s]


def warm_shared_bank(designs_spec, device=None):
    """Warm the shared program bank ONCE for every design of
    ``designs_spec`` through the same serve funnel the replicas
    dispatch (bucket signature x batch ladder, default out_keys), under
    ``RAFT_TPU_AOT=load`` whatever the caller's mode
    (:func:`raft_tpu_torch.aot.warmup.warmup_model`).  Returns the
    warm-up's per-program reports."""
    from raft_tpu_torch.aot.warmup import warmup_model

    paths = design_paths(designs_spec)
    return warmup_model(design=paths[0], kinds=("serve",), designs=paths,
                        device=device)


def run_fleet(root, replicas, designs_spec, host="127.0.0.1",
              extra_args=(), warm_bank=False, join_timeout_s=600.0,
              on_ready=None, device=None):
    """Local fleet coordinator: optionally warm the shared program bank
    ONCE, spawn ``replicas`` server subprocesses, wait for their
    membership leases, then babysit until SIGTERM/SIGINT (forwarded to
    every replica, which drains gracefully).  Returns 0 on clean
    shutdown.

    The one-warm-up-for-N-replicas recipe is the whole point of the
    shared bank: the coordinator pays the first runs once and every
    replica then starts under ``RAFT_TPU_AOT=require``, building
    nothing and running no ``nvcc`` — the bank directory is the deploy
    artifact."""
    env = {}
    if warm_bank:
        warm_shared_bank(designs_spec, device=device)
        env[config.env_name("AOT")] = "require"
    ledger = FleetLedger(root)
    # install the stop signal BEFORE spawning: a SIGTERM during the
    # join window must drain the replicas already spawned, not orphan
    # them behind a dead coordinator
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    procs = []
    try:
        # append as we go: if spawn k fails, the finally block must
        # still drain replicas 0..k-1 (a comprehension would discard
        # them with its exception)
        for i in range(int(replicas)):
            procs.append(spawn_replica(root, designs_spec, index=i,
                                       host=host, env=env,
                                       extra_args=extra_args,
                                       device=device,
                                       replicas_total=int(replicas)))
        my_rids = {rid for _p, rid in procs}
        deadline = time.time() + float(join_timeout_s)
        while not stop.is_set():
            # only THIS coordinator's replicas count toward readiness —
            # a predecessor fleet's not-yet-expired leases in the same
            # --fleet-dir must not fake a ready fleet of dead ports
            live = ledger.live()
            if my_rids <= set(live):
                break
            dead = [rid for p, rid in procs if p.poll() is not None]
            if dead:
                raise RuntimeError(
                    f"replica(s) {dead} exited before joining the fleet "
                    f"(see {_replicas_dir(root)}/<rid>.log)")
            if time.time() > deadline:
                raise RuntimeError(
                    f"fleet join timed out: "
                    f"{len(my_rids & set(live))}/{len(procs)} leases "
                    f"after {join_timeout_s}s")
            time.sleep(0.25)
        if not stop.is_set():
            live = ledger.live()
            ports = {rid: live[rid].get("port")
                     for rid in sorted(my_rids) if rid in live}
            if on_ready is not None:
                on_ready(ports)
            stop.wait()
    finally:
        # every exit path — clean SIGTERM, join failure, timeout,
        # KeyboardInterrupt — drains the replicas it spawned
        rcs = _shutdown_replicas(procs)
    return 0 if all(rc == 0 for rc in rcs.values()) else 1


def _shutdown_replicas(procs):
    """SIGTERM every live replica of ``[(Popen, replica_id), ...]``,
    wait out the drain window, SIGKILL stragglers.  Returns
    {replica_id: returncode}."""
    for p, _rid in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    rcs = {}
    drain_s = float(config.get("SERVE_DRAIN_S"))
    for p, rid in procs:
        try:
            rcs[rid] = p.wait(timeout=drain_s + 30.0)
        except subprocess.TimeoutExpired:
            p.kill()
            rcs[rid] = p.wait(timeout=10.0)
    return rcs


def publish_router_record(root, rec):
    """Atomic write of the router's membership view (``router.json``)
    — the second `_fleet/` record family, read by ``fleet --status``
    and the drill assertions."""
    fsops.makedirs(fleet_dir(root), exist_ok=True)
    resilience._atomic_json(router_record_path(root), rec)

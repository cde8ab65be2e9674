"""Consistent-hash failover router for the horizontal serving fleet (the
port's counterpart of ``raft_tpu/serve/router.py``).

The thin front of the fleet: a stdlib asyncio process that owns
fleet **membership** (off the ``_fleet/`` lease ledger —
:mod:`raft_tpu_torch.serve.fleet`) and the **robustness ladder**, and proxies
``POST /evaluate`` to replica servers so clients see ONE durable
endpoint while replicas die, drain and join underneath:

* **consistent-hash affinity** — requests hash by ``(bucket signature,
  design content hash)`` (:func:`routing_key`) onto a vnode ring
  (:class:`HashRing`), so a repeated design always lands on the same
  replica and replica result/program caches stay hot; adding or
  removing a replica moves only the keys it owns (tier-1-asserted);
* **failover retries** — a connect failure, dropped response,
  per-attempt timeout, or retryable 5xx (500/502/503) moves the
  request to the next ring replica after a capped exponential backoff
  (``Retry-After`` honored; shared schedule with the client —
  :func:`raft_tpu_torch.serve.client.backoff_delay`).  Re-dispatch is safe
  by construction: serving evaluations are content-addressed
  (cache key = design hash + exact case bits + flags), so a duplicate
  dispatch is benign — the same argument that makes fabric
  double-compute benign;
* **per-replica circuit breaker** — ``RAFT_TPU_ROUTER_BREAKER_FAILS``
  consecutive failures open the breaker (``breaker_open`` event);
  after ``ROUTER_BREAKER_COOLDOWN_S`` one half-open trial (live
  request or ledger-prober ``/healthz`` probe) closes it again
  (``breaker_close``);
* **hedged requests** — with ``RAFT_TPU_ROUTER_HEDGE_MS`` set, a
  first attempt still unanswered after that long fires a second copy
  at the next ring replica and the first good response wins (p99
  straggler insurance; off by default);
* **graceful degradation** — only when every owning replica is dead or
  breaker-open does the client see ``503`` + ``Retry-After``
  (``router_reject``).

Membership runs on a daemon **prober thread** (file + HTTP probe IO
stays off the event loop): every ``RAFT_TPU_ROUTER_PROBE_S`` it reads
the lease ledger, health-checks joiners over ``/healthz`` before
admitting them to the ring, evicts expired leases (atomic rename —
exactly one evictor), closes breakers whose replica answers probes
again, and publishes the router's membership view to
``_fleet/router.json``.  Join and drain need NO router restart: a new
replica warms, claims, and takes traffic on the prober's next pass; a
draining replica releases its lease at drain start and the ring drops
it while its accepted work finishes.

The router runs no device work and imports no torch itself: it reads
leases, proxies bytes and keeps breakers.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import http.client
import json
import os
import signal
import threading
import time

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import (format_traceparent, parse_traceparent,
                                      span)
from raft_tpu_torch.serve import fleet, wire
from raft_tpu_torch.serve.client import backoff_delay
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

_T0 = time.perf_counter()

#: upstream HTTP statuses the failover ladder treats as retryable:
#: 500 (replica bug / injected 5xx), 502, and 503 (draining replica /
#: full admission queue — another replica may have room).  429 is NOT
#: here: per-client quota is the client's problem on every replica.
RETRYABLE_STATUSES = (500, 502, 503)


def _hash64(s):
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def routing_key(payload, designs=None):
    """The ring key of one /evaluate payload: ``(bucket signature,
    design content hash)``.

    ``designs`` maps served design name -> {"sig", "fingerprint"}
    (merged from the lease bodies), so a named design routes by its
    bucket-signature fingerprint + content hash; an inline design
    routes by the hash of its JSON body (same design re-posted = same
    replica = warm inline-entry and result caches); an unknown name
    routes by the name itself (the owning replica answers the 404)."""
    if isinstance(payload, dict) and payload.get("design_inline") is not None:
        blob = json.dumps(payload["design_inline"], sort_keys=True,
                          default=str)
        return "|inline:" + hashlib.sha256(blob.encode()).hexdigest()[:24]
    name = str((payload or {}).get("design"))
    d = (designs or {}).get(name) or {}
    sig = str(d.get("sig") or "")
    dk = str(d.get("fingerprint") or "design:" + name)
    return f"{sig}|{dk}"


class HashRing:
    """Consistent-hash ring with virtual nodes.  Pure data structure —
    :class:`RouterState` serializes access under its lock."""

    def __init__(self, vnodes=None):
        self.vnodes = int(vnodes if vnodes is not None
                          else config.get("ROUTER_VNODES"))
        self._points = []    # sorted [(hash, replica_id)]
        self._members = set()

    def __len__(self):
        return len(self._members)

    def __contains__(self, rid):
        return rid in self._members

    def members(self):
        return sorted(self._members)

    def add(self, rid):
        if rid in self._members:
            return
        self._members.add(rid)
        for i in range(self.vnodes):
            bisect.insort(self._points, (_hash64(f"{rid}#{i}"), rid))

    def remove(self, rid):
        if rid not in self._members:
            return
        self._members.discard(rid)
        self._points = [p for p in self._points if p[1] != rid]

    def owners(self, key, n=None):
        """Distinct replicas clockwise from ``key``'s ring position —
        ``owners(key)[0]`` is the affinity owner, the rest are the
        failover order.  Stability property (tier-1-asserted): removing
        a replica never changes the owner of a key it did not own."""
        if not self._points:
            return []
        n = len(self._members) if n is None else min(n, len(self._members))
        i = bisect.bisect_right(self._points, (_hash64(key), ""))
        out = []
        for j in range(len(self._points)):
            rid = self._points[(i + j) % len(self._points)][1]
            if rid not in out:
                out.append(rid)
                if len(out) >= n:
                    break
        return out


class Breaker:
    """Per-replica circuit breaker.

    closed --``fails`` consecutive failures--> open --``cooldown_s``-->
    half-open (ONE trial admitted) --success--> closed / --failure-->
    open again.  ``clock`` is injectable for deterministic tests.
    Transitions are returned (``"open"``/``"close"``) so the owner can
    emit the registered events exactly once per transition."""

    def __init__(self, fails=None, cooldown_s=None, clock=time.monotonic):
        self.fails = int(fails if fails is not None
                         else config.get("ROUTER_BREAKER_FAILS"))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else config.get("ROUTER_BREAKER_COOLDOWN_S"))
        self._clock = clock
        self._consecutive = 0
        self._opened_t = None       # None = closed
        self._trial_inflight = False

    @property
    def state(self):
        if self._opened_t is None:
            return "closed"
        if self._clock() - self._opened_t >= self.cooldown_s:
            return "half_open"
        return "open"

    def retry_after_s(self):
        """Seconds until this breaker would admit a half-open trial."""
        if self._opened_t is None:
            return 0.0
        return max(0.0, self.cooldown_s - (self._clock() - self._opened_t))

    def allow(self):
        """May a request be sent now?  Half-open admits exactly one
        in-flight trial at a time."""
        st = self.state
        if st == "closed":
            return True
        if st == "open":
            return False
        if self._trial_inflight:
            return False
        self._trial_inflight = True
        return True

    def record_success(self):
        was_open = self._opened_t is not None
        self._consecutive = 0
        self._trial_inflight = False
        self._opened_t = None
        return "close" if was_open else None

    def record_failure(self):
        st = self.state
        self._consecutive += 1
        self._trial_inflight = False
        if st == "half_open" or (st == "closed"
                                 and self._consecutive >= self.fails):
            self._opened_t = self._clock()
            return "open"
        if st == "open":
            self._opened_t = self._clock()  # extend the cooldown
        return None

    def release_trial(self):
        """Un-take a half-open trial slot without recording an outcome
        (the attempt was cancelled before completing — hedge loser)."""
        self._trial_inflight = False


class RouterState:
    """Membership + breaker state shared between the asyncio request
    path and the ledger-prober thread."""

    def __init__(self, vnodes=None):
        self._lock = threading.Lock()
        self._replicas = {}  # raft-lint: guarded-by=self._lock
        self._designs = {}   # raft-lint: guarded-by=self._lock
        self._breakers = {}  # raft-lint: guarded-by=self._lock
        self._ring = HashRing(vnodes)  # raft-lint: guarded-by=self._lock

    # ---------------------------------------------------- membership

    def apply_membership(self, live):
        """Reconcile the ring against ``{replica_id: lease_record}``
        (the ledger's live set).  Returns ``(added, removed,
        replaced)`` — ``replaced`` is the same-rid *endpoint* changes
        (a rolling-upgrade takeover re-binds the replica id to a new
        port): the rid keeps its vnodes, so NO key moves and no other
        replica's assignment is touched; only its breaker resets (the
        old endpoint's failure history says nothing about the new
        process)."""
        with self._lock:
            added = sorted(set(live) - set(self._replicas))
            removed = sorted(set(self._replicas) - set(live))
            replaced = []
            for rid in removed:
                self._ring.remove(rid)
                self._replicas.pop(rid, None)
                self._breakers.pop(rid, None)
            for rid, rec in live.items():
                old = self._replicas.get(rid)
                info = {
                    "addr": str(rec.get("addr") or "127.0.0.1"),
                    "port": int(rec.get("port") or 0),
                    "designs": dict(rec.get("designs") or {}),
                    "out_keys": list(rec.get("out_keys") or ()),
                    "healthz": dict(rec.get("healthz") or {}),
                }
                if old is not None and (old["addr"], old["port"]) != \
                        (info["addr"], info["port"]):
                    replaced.append(rid)
                    self._breakers[rid] = Breaker()
                self._replicas[rid] = info
                if rid not in self._ring:
                    self._ring.add(rid)
                self._breakers.setdefault(rid, Breaker())
            designs = {}
            for info in self._replicas.values():
                for name, d in info["designs"].items():
                    designs.setdefault(name, dict(d or {}))
            self._designs = designs
        return added, removed, sorted(replaced)

    def endpoint(self, rid):
        with self._lock:
            info = self._replicas.get(rid)
            return (info["addr"], info["port"]) if info else None

    def key_of(self, payload):
        with self._lock:
            return routing_key(payload, self._designs)

    def design_fingerprints(self):
        """{design name: content fingerprint} from the lease bodies —
        the canary's golden-key identity (the same hash the serving
        result cache keys on)."""
        with self._lock:
            return {name: str((d or {}).get("fingerprint") or "")
                    for name, d in self._designs.items()}

    def served_out_keys(self, rid):
        """The out_keys tuple a replica's lease declared it dispatches
        (empty for pre-out_keys leases) — the canary intersects its
        probe keys with this so a probe never 400s on an unserved
        key."""
        with self._lock:
            info = self._replicas.get(rid)
            return tuple(info["out_keys"]) if info else ()

    def owners(self, key):
        with self._lock:
            return self._ring.owners(key)

    def pick(self, key, attempt, exclude=()):
        """The replica for one failover attempt: ring-owner order
        rotated by ``attempt``, skipping excluded and breaker-refusing
        replicas.  None when nobody can take the request."""
        with self._lock:
            cands = self._ring.owners(key)
            n = len(cands)
            for i in range(n):
                rid = cands[(attempt + i) % n]
                if rid in exclude:
                    continue
                br = self._breakers.get(rid)
                if br is None or br.allow():
                    return rid
            return None

    def min_retry_after_s(self):
        """The soonest any breaker would half-open (the 503
        Retry-After hint when every replica is refusing)."""
        with self._lock:
            waits = [br.retry_after_s() for br in self._breakers.values()]
        return min(waits) if waits else 1.0

    # ------------------------------------------------------- breakers

    def record_failure(self, rid, reason):
        metrics.counter("router_upstream_errors").inc()
        with self._lock:
            br = self._breakers.get(rid)
            transition = br.record_failure() if br else None
        if transition == "open":
            metrics.counter("router_breaker_opens").inc()
            log_event("breaker_open", replica=rid,
                      reason=str(reason)[:160],
                      fails=br.fails, cooldown_s=br.cooldown_s)

    def record_success(self, rid, probe=False):
        with self._lock:
            br = self._breakers.get(rid)
            transition = br.record_success() if br else None
        if transition == "close":
            metrics.counter("router_breaker_closes").inc()
            log_event("breaker_close", replica=rid, probe=bool(probe))

    def release_trial(self, rid):
        """Give back a half-open trial slot whose attempt was
        cancelled before it could record an outcome (hedge loser)."""
        with self._lock:
            br = self._breakers.get(rid)
            if br is not None:
                br.release_trial()

    def breaker_states(self):
        with self._lock:
            return {rid: br.state for rid, br in self._breakers.items()}

    def half_open_replicas(self):
        """Replicas whose breaker has cooled down to half-open (the
        prober health-checks these so recovery does not depend on
        client traffic).  Still-open breakers are NOT probed: closing
        one early would bypass the documented cooldown — and /healthz
        answering says nothing about the /evaluate path a hang/5xx
        fault wedged."""
        with self._lock:
            return {rid: self._replicas[rid]
                    for rid, br in self._breakers.items()
                    if br.state == "half_open" and rid in self._replicas}

    def members(self):
        with self._lock:
            return self._ring.members()

    # ------------------------------------------------------ snapshots

    def snapshot(self):
        with self._lock:
            return {
                "n_replicas": len(self._replicas),
                "replicas": {
                    rid: {"addr": info["addr"], "port": info["port"],
                          "designs": sorted(info["designs"]),
                          "breaker": self._breakers[rid].state}
                    for rid, info in sorted(self._replicas.items())},
                "designs": {name: str((d or {}).get("sig") or "")
                            for name, d in sorted(self._designs.items())},
            }

    def ring_view(self):
        """{design name: replica owner order} — the affinity map the
        drill reads to pick its kill target."""
        with self._lock:
            return {name: self._ring.owners(routing_key({"design": name},
                                                        self._designs))
                    for name in sorted(self._designs)}

    def membership_record(self):
        """The ``_fleet/router.json`` record (schema family
        ``router-membership``)."""
        snap = self.snapshot()
        rec = {
            "version": 1,
            "t": time.time(),
            "pid": os.getpid(),
            "n_replicas": snap["n_replicas"],
            "replicas": snap["replicas"],
            "designs": snap["designs"],
        }
        return rec


# ------------------------------------------------------- membership prober


def _http_healthz(addr, port, timeout_s=3.0):
    """Blocking /healthz probe (prober THREAD only, never the event
    loop).  Returns the parsed body or None."""
    conn = http.client.HTTPConnection(addr, int(port), timeout=timeout_s)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return None
        return json.loads(body)
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


class LedgerProber(threading.Thread):
    """Daemon thread owning all membership IO: lease-ledger scans,
    joiner /healthz confirmation, expired-lease eviction, breaker-open
    recovery probes, and the ``router.json`` publication."""

    def __init__(self, root, state, interval_s=None, probe_http=True):
        super().__init__(name="raft-router-prober", daemon=True)
        self.root = root
        self.state = state
        self.ledger = fleet.FleetLedger(root)
        self.interval_s = float(interval_s if interval_s is not None
                                else config.get("ROUTER_PROBE_S"))
        self.probe_http = bool(probe_http)
        #: joiners that failed their admission /healthz probe this
        #: pass (prober-thread private)
        self._deferred = set()
        #: last published router.json content minus its timestamp
        #: (prober-thread private; gates steady-state republication)
        self._last_published = None
        self._stop_evt = threading.Event()

    def probe_once(self):
        """One membership pass (also called synchronously at startup
        so the router binds with a populated ring)."""
        # evict expired leases first: exactly one evictor wins the
        # rename; a lost race just means another router (or a rescan)
        # already evicted
        for rid, (_rec, age) in self.ledger.expired().items():
            self.ledger.evict(rid, reason="expired", age_s=age)
        live = self.ledger.live()
        if self.probe_http:
            members = set(self.state.members())
            self._deferred = {
                rid for rid, rec in live.items()
                if rid not in members and _http_healthz(
                    rec.get("addr") or "127.0.0.1",
                    rec.get("port") or 0) is None}
            live = {rid: rec for rid, rec in live.items()
                    if rid not in self._deferred}
        added, removed, replaced = self.state.apply_membership(live)
        if added or removed or replaced:
            log_event("router_ring_update", added=added, removed=removed,
                      replaced=replaced, n_replicas=len(live))
            metrics.gauge("router_replicas").set(len(live))
        # breaker recovery without client traffic: a HALF-OPEN replica
        # (cooldown served) that answers /healthz closes via the normal
        # bookkeeping (probe=True on the breaker_close event)
        if self.probe_http:
            for rid, info in self.state.half_open_replicas().items():
                if _http_healthz(info["addr"], info["port"]) is not None:
                    self.state.record_success(rid, probe=True)
        # publish the membership view only when it CHANGED (modulo the
        # timestamp): a steady-state fleet must not rewrite router.json
        # on the shared filesystem every probe period forever
        rec = self.state.membership_record()
        comparable = {k: v for k, v in rec.items() if k != "t"}
        if comparable != self._last_published:
            try:
                fleet.publish_router_record(self.root, rec)
                self._last_published = comparable
            except OSError:
                pass  # the view is advisory; routing state is in memory
        return added, removed

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:
                pass  # a bad pass must never kill membership

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)


# ----------------------------------------------------------------- router


class Router:
    """One router instance: membership state + prober + asyncio HTTP
    front end."""

    def __init__(self, root, host="127.0.0.1", port=8788, vnodes=None,
                 probe_http=True):
        self.root = root
        self.host = host
        self.port = int(port)
        self.state = RouterState(vnodes)
        self.prober = LedgerProber(root, self.state,
                                   probe_http=probe_http)
        self.retries = int(config.get("ROUTER_RETRIES"))
        self.backoff_s = float(config.get("ROUTER_BACKOFF_MS")) / 1e3
        self.backoff_cap_s = float(config.get("ROUTER_BACKOFF_CAP_MS")) / 1e3
        self.timeout_s = float(config.get("ROUTER_TIMEOUT_S"))
        self.hedge_s = float(config.get("ROUTER_HEDGE_MS")) / 1e3
        self._server = None
        self._stop = None
        self._handlers = set()
        #: handlers currently processing a request (vs parked on an
        #: idle keep-alive read): shutdown awaits only these
        self._busy = set()
        #: the golden-answer canary daemon (None unless
        #: RAFT_TPU_CANARY_S > 0 — started in start())
        self.canary = None

    # ------------------------------------------------- failover ladder

    async def send_to(self, rid, method, path, body, headers):
        """One upstream attempt under its ``router_upstream`` span."""
        ep = self.state.endpoint(rid)
        if ep is None:
            raise wire.UpstreamError("gone", f"replica {rid} left the ring")
        with span("router_upstream", replica=rid, path=path):
            return await wire.proxy_request(
                ep[0], ep[1], method, path, body, headers,
                timeout_s=self.timeout_s)

    async def failover(self, key, send, sleep=None):
        """The robustness ladder for one request.  ``send(rid)``
        performs one attempt (injectable in tests); returns
        ``(rid, attempts, hedged, status, headers, body)`` or a
        ``(None, attempts, hedged, 503, ...)`` rejection when every
        owning replica is dead or breaker-open."""
        sleep = sleep or asyncio.sleep
        last_reason = "no_replicas"
        last_rid = None
        retry_after = None
        hedged = False
        tried = 0
        for attempt in range(self.retries + 1):
            rid = self.state.pick(key, attempt)
            if rid is None:
                break
            if tried:
                # an upstream Retry-After is THAT replica's window —
                # honor it only when re-trying the same replica; a
                # failover to a different (healthy) one must not
                # inherit the draining replica's stall
                ra = retry_after if rid == last_rid else None
                delay = backoff_delay(tried - 1, base_s=self.backoff_s,
                                      cap_s=self.backoff_cap_s,
                                      retry_after_s=ra)
                metrics.counter("router_retries").inc()
                log_event("router_retry", replica=rid, attempt=tried,
                          reason=last_reason, delay_s=round(delay, 4))
                await sleep(delay)
            tried += 1
            try:
                rid, did_hedge, result = await self._attempt(
                    key, rid, send, first=(attempt == 0))
            except wire.UpstreamError as e:
                last_reason = e.reason
                # the error may have come from the HEDGE replica, not
                # the primary — attribute its Retry-After to whoever
                # actually produced it
                last_rid = getattr(e, "rid", rid)
                retry_after = getattr(e, "retry_after_s", None)
                continue
            hedged = hedged or did_hedge
            status, hdrs, data = result
            return rid, tried, hedged, status, hdrs, data
        if tried == 0 and self.state.owners(key):
            last_reason = "all_breakers_open"
        metrics.counter("router_rejected").inc()
        retry_s = max(retry_after or 0.0, self.state.min_retry_after_s(),
                      1.0)
        log_event("router_reject", reason=last_reason, attempts=tried,
                  retry_after_s=round(retry_s, 3))
        payload = {"ok": False, "reason": last_reason,
                   "error": "no replica available "
                            f"(last failure: {last_reason})",
                   "retry_after_s": round(retry_s, 3)}
        return None, tried, hedged, 503, {}, payload

    async def _attempt(self, key, rid, send, first):
        """One ladder attempt with optional hedging.  Success/failure
        is recorded on the breaker of the replica that actually
        answered; raises :class:`~raft_tpu_torch.serve.wire.UpstreamError`
        when every copy of the attempt failed."""
        if not (first and self.hedge_s > 0):
            return rid, False, await self._classified(rid, send)
        t1 = asyncio.ensure_future(self._classified(rid, send))
        done, _ = await asyncio.wait({t1}, timeout=self.hedge_s)
        if t1 in done:
            # t1 already resolved — this await returns (or raises the
            # classified error) immediately
            return rid, False, await t1
        rid2 = self.state.pick(key, 1, exclude=(rid,))
        if rid2 is None:
            return rid, False, await t1
        metrics.counter("router_hedges").inc()
        log_event("router_hedge", primary=rid, replica=rid2,
                  hedge_ms=self.hedge_s * 1e3)
        t2 = asyncio.ensure_future(self._classified(rid2, send))
        owners = {t1: rid, t2: rid2}
        pending = {t1, t2}
        last_err = None
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                try:
                    result = await t  # resolved — returns/raises now
                except wire.UpstreamError as e:
                    last_err = e
                    continue
                for p in pending:
                    p.cancel()
                    # a loser that FINISHED (with its error) in the
                    # race window must still have its exception
                    # retrieved, or asyncio logs it at gc
                    p.add_done_callback(
                        lambda ft: ft.cancelled() or ft.exception())
                    # a cancelled attempt never reaches its breaker
                    # bookkeeping — give back the half-open trial slot
                    # it may hold, or the breaker refuses traffic until
                    # an external probe clears it
                    self.state.release_trial(owners[p])
                return owners[t], True, result
        raise last_err

    async def _classified(self, rid, send):
        """One attempt + breaker bookkeeping: raises UpstreamError on
        transport failure OR retryable HTTP status (both count against
        the breaker); any other status is a success."""
        try:
            status, hdrs, data = await send(rid)
        except wire.UpstreamError as e:
            self.state.record_failure(rid, e.reason)
            e.rid = rid
            raise
        if status in RETRYABLE_STATUSES:
            self.state.record_failure(rid, f"http_{status}")
            err = wire.UpstreamError(f"http_{status}")
            err.rid = rid
            ra = (hdrs or {}).get("retry-after")
            if ra and str(ra).isdigit():
                err.retry_after_s = float(ra)
            raise err
        self.state.record_success(rid)
        return status, hdrs, data

    # ------------------------------------------------------------ routes

    async def _proxy_evaluate(self, body, headers, client):
        """Route one /evaluate: parse enough of the payload to compute
        the ring key, then run the failover ladder.  The
        ``router_request`` span adopts the client's traceparent and is
        forwarded as the replica's parent — one merged trace covers
        client -> router -> replica -> dispatch."""
        t0 = time.perf_counter()
        try:
            payload = json.loads(body or b"{}")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"ok": False, "error": f"bad JSON body: {e}"}, {}
        if not isinstance(payload, dict):
            return 400, {"ok": False,
                         "error": "body must be a JSON object"}, {}
        key = self.state.key_of(payload)
        # boundary="client": the router is the fleet's front door, so
        # an adopted traceparent ALWAYS came from an external client —
        # its parent span legitimately lives in the client's telemetry,
        # and the merge --check orphan rule excuses exactly this (an
        # internally-propagated parent, fabric-style, must still
        # resolve in-capture)
        req_span = span("router_request", endpoint="/evaluate",
                        remote=parse_traceparent(headers.get("traceparent")),
                        boundary="client",
                        client=str(client), key=key[:48])
        with req_span:
            fwd = {k: v for k, v in headers.items()
                   if k in ("x-client", "content-type")}
            # every client must keep its own quota identity at the
            # replicas: without this, anonymous clients collapse into
            # one token bucket keyed on the ROUTER's address
            fwd.setdefault("x-client", str(client))
            tp = format_traceparent(req_span.trace_id, req_span.span_id) \
                if req_span.span_id else headers.get("traceparent")
            if tp:
                fwd["traceparent"] = tp

            async def send(rid):
                return await self.send_to(rid, "POST", "/evaluate", body,
                                          fwd)

            rid, attempts, hedged, status, hdrs, data = \
                await self.failover(key, send)
        wall = time.perf_counter() - t0
        metrics.counter("router_requests").inc()
        # latency exemplar: who answered the p99 route and which trace
        # holds its span tree (attempt/hedge counts tell the failover
        # story without opening the trace)
        exemplar = {"replica": str(rid), "code": int(status),
                    "attempts": int(attempts), "hedged": int(bool(hedged))}
        if req_span.span_id is not None:
            exemplar["trace_id"] = req_span.trace_id
            exemplar["span_id"] = req_span.span_id
        metrics.histogram("router_request_s").observe(wall,
                                                      exemplar=exemplar)
        metrics.window("router_request_window_s").observe(wall,
                                                          exemplar=exemplar)
        prov = (hdrs.get("x-raft-provenance")
                if isinstance(hdrs, dict) else None)
        log_event("router_request", replica=rid, code=int(status),
                  attempts=attempts, hedged=bool(hedged),
                  design=str(payload.get("design") or "inline"),
                  wall_s=round(wall, 6), provenance=prov)
        extra = {}
        if isinstance(hdrs, dict) and hdrs.get("traceparent"):
            extra["traceparent"] = hdrs["traceparent"]
        if prov:
            # forward the replica's provenance stamp verbatim: the
            # client sees WHAT produced its numbers even through the
            # failover front (serve/client.py parses it into
            # last_provenance)
            extra["x-raft-provenance"] = prov
        if rid is not None:
            # which replica answered — the affinity drill reads this
            extra["x-raft-replica"] = str(rid)
        if rid is None:
            extra["Retry-After"] = str(
                max(1, int(float(data.get("retry_after_s") or 0)) + 1))
            return status, data, extra
        if isinstance(data, (bytes, bytearray)):
            try:
                data = json.loads(data)
            except ValueError:
                data = data.decode(errors="replace")
        return status, data, extra

    def _healthz(self):
        snap = self.state.snapshot()
        counters = {c: metrics.counter(c).value for c in
                    ("router_requests", "router_retries", "router_hedges",
                     "router_breaker_opens", "router_breaker_closes",
                     "router_rejected", "router_upstream_errors")}
        win = metrics.window("router_request_window_s").snapshot(
            float(config.get("SERVE_WINDOW_S")))
        return 200, {"ok": True,
                     "uptime_s": round(time.perf_counter() - _T0, 3),
                     "fleet_dir": self.root,
                     "window": win,
                     **snap, **counters}

    async def _route(self, method, path, body, headers, client,
                     peer_host="?"):
        if path == "/evaluate":
            if method != "POST":
                return 405, {"ok": False, "error": "POST required"}, {}
            return await self._proxy_evaluate(body, headers, client)
        if method != "GET":
            return 405, {"ok": False, "error": "GET required"}, {}
        if path == "/healthz":
            status, payload = self._healthz()
            return status, payload, {}
        if path == "/alerts":
            # live alert-engine state + the router canary's golden/
            # parity summary — in-memory reads only, loop-safe
            from raft_tpu_torch.obs import alerts as alerts_mod

            payload = alerts_mod.endpoint_payload()
            payload["canary"] = (self.canary.canary.summary()
                                 if self.canary is not None else None)
            return 200, payload, {}
        if path == "/ring":
            return 200, {"ok": True, "ring": self.state.ring_view()}, {}
        if path == "/designs":
            snap = self.state.snapshot()
            return 200, {"ok": True,
                         "designs": sorted(snap["designs"])}, {}
        if path == "/metrics":
            return 200, metrics.to_prometheus(), {}
        if path == "/debug/flight":
            # the router's black box, loopback-only like the replica's:
            # serialize the live ring without touching disk
            if peer_host not in wire.LOOPBACK_HOSTS:
                return 403, {"ok": False,
                             "error": "/debug/flight is loopback-only"}, {}
            from raft_tpu_torch.obs import flight

            return 200, flight.serialize_text(trigger="debug"), {}
        return 404, {"ok": False, "error": f"no route {path}"}, {}

    # -------------------------------------------------------- connection

    async def _handle(self, reader, writer):
        task = asyncio.current_task()
        self._handlers.add(task)
        peer = writer.get_extra_info("peername")
        peer_host = peer[0] if isinstance(peer, tuple) else "?"
        try:
            while True:
                try:
                    req = await wire.read_request(reader)
                except (ValueError, asyncio.IncompleteReadError) as e:
                    writer.write(wire.response_bytes(
                        400, {"ok": False, "error": str(e)[:200]}, False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, headers, body = req
                client = headers.get("x-client") or peer_host
                self._busy.add(task)
                try:
                    try:
                        status, payload, extra = await self._route(
                            method, path, body, headers, client,
                            peer_host=peer_host)
                    except Exception as e:  # noqa: BLE001 — keep routing
                        status, payload, extra = 500, {
                            "ok": False, "error": repr(e)[:300]}, {}
                    keep = (headers.get("connection",
                                        "keep-alive").lower() != "close") \
                        and not (self._stop is not None
                                 and self._stop.is_set())
                    writer.write(wire.response_bytes(status, payload,
                                                     keep, extra))
                    await writer.drain()
                finally:
                    self._busy.discard(task)
                metrics.counter("router_http_requests").inc()
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
        loop = asyncio.get_running_loop()
        # arm the flight recorder's flusher/crash hooks (no-op without
        # RAFT_TPU_FLIGHT_DIR): a SIGKILLed router leaves a black box
        from raft_tpu_torch.obs import flight

        flight.maybe_start()
        # populate the ring BEFORE binding: the first client request
        # must never race an empty membership (ledger IO — executor)
        await loop.run_in_executor(None, self.prober.probe_once)
        self.prober.start()
        if float(config.get("CANARY_S") or 0) > 0:
            # golden-answer canary: low-rate probes pinned per replica,
            # compared bit-for-status / tolerance-for-floats against
            # content-addressed goldens + cross-replica provenance
            # consistency (raft_tpu_torch.serve.canary); blocking probe
            # IO lives on ITS thread, like the membership prober
            from raft_tpu_torch.serve.canary import RouterCanary

            self.canary = RouterCanary(self.state)
            self.canary.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._stop = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self._stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        snap = self.state.snapshot()
        log_event("router_start", host=self.host, port=self.port,
                  fleet_dir=self.root, n_replicas=snap["n_replicas"],
                  replicas=sorted(snap["replicas"]))
        return self

    async def serve_until_stopped(self):
        await self._stop.wait()
        await self.shutdown()

    async def shutdown(self):
        """Stop accepting, let in-flight proxied requests finish, stop
        the prober."""
        loop = asyncio.get_running_loop()
        self._server.close()
        # await only handlers MID-REQUEST; ones parked on an idle
        # keep-alive read would hold the drain window for nothing —
        # cancel those immediately
        for t in list(self._handlers - self._busy):
            t.cancel()
        busy = {t for t in self._busy if not t.done()}
        if busy:
            await asyncio.wait(busy,
                               timeout=float(config.get("SERVE_DRAIN_S")))
        for t in list(self._handlers):
            t.cancel()
        await self._server.wait_closed()
        await loop.run_in_executor(None, self.prober.stop)
        if self.canary is not None:
            await loop.run_in_executor(None, self.canary.stop)
        path = config.get("METRICS")
        if path:
            await loop.run_in_executor(None, metrics.export, path)
        # append the session's run record (RAFT_TPU_RUNS_DIR): the
        # router's registry at shutdown carries the fleet's routing
        # story — request/retry/hedge/breaker counters, the sliding
        # latency window, canary pass/fail — so `obs runs regress`
        # sees router sessions too (replicas already record theirs in
        # serve/http.py).  Executor: file IO + a `git rev-parse`
        # subprocess (obs.runs.git_sha)
        from raft_tpu_torch.obs import runs as obs_runs

        wall_s = time.perf_counter() - _T0
        requests = metrics.counter("router_requests").value
        await loop.run_in_executor(
            None, lambda: obs_runs.maybe_record(
                "router", wall_s=wall_s, extra={"requests": requests}))
        log_event("router_stop",
                  requests=metrics.counter("router_requests").value,
                  retries=metrics.counter("router_retries").value)


async def run_router(root, host="127.0.0.1", port=8788, ready=None):
    """Start + block until signalled (the ``router`` CLI entry)."""
    router = await Router(root, host, port).start()
    if ready is not None:
        ready(router)
    await router.serve_until_stopped()
    return router

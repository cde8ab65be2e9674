"""The port's serving fleet (``raft_tpu_torch/serve/{router,fleet}.py``)
against the reference's ``tests/test_router.py``, test for test under
the same names: fast socket-free units for the hash ring, breaker state
machine, retry/hedge decision logic, fleet lease ledger and client
backoff, plus the slow-tier subprocess drills on the CPU (replicas
``--device cpu`` under ``RAFT_TPU_AOT=require`` from one warmed program
bank) — kill-a-replica under live load with zero dropped responses,
the replica fault kinds, the stale-bank canary, the report's router
section.  Where the reference asserts zero XLA compiles
(``xla_real_compiles``), the port's replica reports what it built
(``kernel.built_here``, ``aot.builds``).

Beyond the reference: the routing key, the ring's owner order, the
breaker and the router state held against the JAX package's on the
same seeded inputs and clocks."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_env_guard import raft_env_unchanged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "torch_port")


@pytest.fixture(autouse=True)
def _raft_env_guard():
    """Fail a test that leaves a RAFT_TPU_* variable behind (routers and
    replicas are built in this process)."""
    with raft_env_unchanged():
        yield


# ------------------------------------------------------------- hash ring


def test_hash_ring_stability_add_remove_moves_only_own_keys():
    from raft_tpu_torch.serve.router import HashRing

    ring = HashRing(vnodes=64)
    for rid in ("r0", "r1", "r2"):
        ring.add(rid)
    keys = [f"sig{i % 3}|design:{i}" for i in range(200)]
    before = {k: ring.owners(k)[0] for k in keys}
    # removing r1 must not move any key r1 did not own
    ring.remove("r1")
    after = {k: ring.owners(k)[0] for k in keys}
    assert len(ring) == 2 and "r1" not in ring
    for k in keys:
        if before[k] != "r1":
            assert after[k] == before[k], k
        else:
            assert after[k] in ("r0", "r2")
    # re-adding restores exactly the old ownership (hash positions are
    # content-derived, not arrival-ordered)
    ring.add("r1")
    assert {k: ring.owners(k)[0] for k in keys} == before
    # owner order is distinct and covers the membership
    owners = ring.owners(keys[0])
    assert sorted(owners) == ["r0", "r1", "r2"]
    assert len(set(owners)) == 3


def test_hash_ring_distribution_and_empty():
    from raft_tpu_torch.serve.router import HashRing

    ring = HashRing(vnodes=64)
    assert ring.owners("anything") == []
    ring.add("a")
    ring.add("b")
    counts = {"a": 0, "b": 0}
    for i in range(400):
        counts[ring.owners(f"key{i}")[0]] += 1
    # vnodes keep the split sane (not 95/5)
    assert min(counts.values()) > 80, counts


def test_routing_key_sig_and_content_hash():
    from raft_tpu_torch.serve.router import routing_key

    designs = {"spar": {"sig": "abc123", "fingerprint": "fp-spar"}}
    k1 = routing_key({"design": "spar", "Hs": 4.0}, designs)
    k2 = routing_key({"design": "spar", "Hs": 9.0}, designs)
    assert k1 == k2 == "abc123|fp-spar"  # case scalars don't move keys
    # unknown design still routes deterministically (replica 404s)
    assert routing_key({"design": "nope"}, designs) == "|design:nope"
    # inline designs route by content hash: same body = same replica
    d = {"type": "spar", "depth": 200.0}
    ka = routing_key({"design_inline": d}, designs)
    kb = routing_key({"design_inline": dict(d)}, designs)
    kc = routing_key({"design_inline": {**d, "depth": 210.0}}, designs)
    assert ka == kb and ka != kc and ka.startswith("|inline:")


# -------------------------------------------------------------- breaker


def test_breaker_state_machine():
    from raft_tpu_torch.serve.router import Breaker

    clock = [0.0]
    b = Breaker(fails=3, cooldown_s=5.0, clock=lambda: clock[0])
    assert b.state == "closed" and b.allow()
    assert b.record_failure() is None
    assert b.record_failure() is None
    assert b.state == "closed"
    assert b.record_failure() == "open"      # 3rd consecutive opens
    assert b.state == "open" and not b.allow()
    assert 0 < b.retry_after_s() <= 5.0
    clock[0] += 5.0
    assert b.state == "half_open"
    assert b.allow()                          # ONE half-open trial
    assert not b.allow()                      # second trial refused
    assert b.record_failure() == "open"       # failed trial re-opens
    assert b.state == "open"
    clock[0] += 5.0
    assert b.allow()
    assert b.record_success() == "close"      # trial success closes
    assert b.state == "closed" and b.retry_after_s() == 0.0
    # a success resets the consecutive-failure count
    b.record_failure()
    b.record_failure()
    assert b.record_success() is None
    assert b.record_failure() is None and b.state == "closed"


def test_breaker_release_trial_returns_half_open_slot():
    from raft_tpu_torch.serve.router import Breaker

    clock = [0.0]
    b = Breaker(fails=1, cooldown_s=1.0, clock=lambda: clock[0])
    b.record_failure()
    clock[0] += 1.0
    assert b.state == "half_open" and b.allow() and not b.allow()
    # a cancelled attempt (hedge loser) gives the trial slot back
    # without recording an outcome — the breaker must not wedge
    b.release_trial()
    assert b.allow()
    assert b.record_success() == "close"


def test_failover_retry_after_only_for_same_replica(tmp_path, monkeypatch):
    """A draining replica's Retry-After must not stall the failover to
    a DIFFERENT healthy replica — only a same-replica re-try honors
    it."""
    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_RETRIES="3",
                        RAFT_TPU_ROUTER_BACKOFF_MS="10",
                        RAFT_TPU_ROUTER_BACKOFF_CAP_MS="1000",
                        RAFT_TPU_ROUTER_BREAKER_FAILS="10")
    _join_all(router, ["r0", "r1"])
    key = "k"
    owner = router.state.owners(key)[0]
    delays = []

    async def send(rid):
        if rid == owner:
            return 503, {"retry-after": "5"}, {"ok": False}
        return 200, {}, {"ok": True}

    async def record_sleep(d):
        delays.append(d)

    rid, tried, _h, status, _hdrs, _b = asyncio.run(
        router.failover(key, send, sleep=record_sleep))
    assert status == 200 and rid != owner and tried == 2
    # the one backoff before the OTHER replica uses the exponential
    # base (10ms), not the drainer's 5s window
    assert delays == [0.01]


def test_breaker_success_while_closed_no_transition():
    from raft_tpu_torch.serve.router import Breaker

    b = Breaker(fails=2, cooldown_s=1.0, clock=lambda: 0.0)
    assert b.record_success() is None


# ------------------------------------------------------ backoff schedule


def test_backoff_delay_schedule_deterministic():
    from raft_tpu_torch.serve.client import backoff_delay

    # capped exponential, no jitter: exact schedule
    sched = [backoff_delay(a, base_s=0.05, cap_s=2.0) for a in range(8)]
    assert sched == [0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 2.0, 2.0]
    # an explicit server Retry-After wins over the curve (even past cap)
    assert backoff_delay(0, 0.05, 2.0, retry_after_s=3.0) == 3.0
    assert backoff_delay(6, 0.05, 2.0, retry_after_s=0.5) == 2.0
    # jitter scales up to +100%, never below the base delay
    lo = backoff_delay(2, 0.05, 2.0, jitter=lambda: 0.0)
    hi = backoff_delay(2, 0.05, 2.0, jitter=lambda: 0.999)
    assert lo == 0.2 and 0.2 < hi < 0.4


def test_client_retries_honor_retry_after(monkeypatch):
    from raft_tpu_torch.serve.client import ServeClient

    sleeps = []
    c = ServeClient("127.0.0.1", 1, retries=3, backoff_base_s=0.05,
                    backoff_cap_s=2.0, jitter=False,
                    sleep=sleeps.append)
    responses = [(429, {"ok": False, "retry_after_s": 0.7}),
                 (503, {"ok": False}),
                 (200, {"ok": True})]
    calls = []

    def fake_round_trip(method, path, payload=None, headers=None):
        calls.append((method, path))
        return responses[len(calls) - 1]

    monkeypatch.setattr(c, "_round_trip", fake_round_trip)
    code, body = c.request("POST", "/evaluate", {"design": "spar"})
    assert code == 200 and body["ok"]
    assert len(calls) == 3
    # first delay honored the 429's retry_after_s, second fell back to
    # the exponential curve
    assert sleeps == [0.7, 0.1]


def test_client_retries_exhausted_returns_last_reject(monkeypatch):
    from raft_tpu_torch.serve.client import ServeClient

    c = ServeClient("127.0.0.1", 1, retries=2, jitter=False,
                    sleep=lambda _s: None)
    monkeypatch.setattr(c, "_round_trip",
                        lambda *a, **k: (503, {"ok": False}))
    code, _body = c.request("POST", "/evaluate", {})
    assert code == 503
    # retries=0 (the default flag value) never sleeps
    c0 = ServeClient("127.0.0.1", 1, retries=0,
                     sleep=lambda _s: pytest.fail("slept with retries=0"))
    monkeypatch.setattr(c0, "_round_trip",
                        lambda *a, **k: (429, {"ok": False}))
    assert c0.request("GET", "/healthz")[0] == 429


# ------------------------------------------------- failover ladder (async)


def _mk_router(tmp_path, monkeypatch, **flags):
    """A Router wired to a tmp fleet dir with deterministic flags and
    no real sockets (tests drive `failover` with injected send fns)."""
    from raft_tpu_torch.serve.router import Router

    defaults = {"RAFT_TPU_ROUTER_RETRIES": "3",
                "RAFT_TPU_ROUTER_BACKOFF_MS": "1",
                "RAFT_TPU_ROUTER_BACKOFF_CAP_MS": "4",
                "RAFT_TPU_ROUTER_BREAKER_FAILS": "2",
                "RAFT_TPU_ROUTER_BREAKER_COOLDOWN_S": "30",
                "RAFT_TPU_ROUTER_HEDGE_MS": "0"}
    defaults.update(flags)
    for k, v in defaults.items():
        monkeypatch.setenv(k, v)
    router = Router(str(tmp_path), probe_http=False)
    return router


def _join(router, rid, port=1000):
    router.state.apply_membership({rid: {"addr": "127.0.0.1",
                                         "port": port, "designs": {}}})


def _join_all(router, rids):
    router.state.apply_membership(
        {rid: {"addr": "127.0.0.1", "port": 1000 + i, "designs": {}}
         for i, rid in enumerate(rids)})


def test_failover_retries_onto_next_replica(tmp_path, monkeypatch):
    from raft_tpu_torch.serve import wire

    router = _mk_router(tmp_path, monkeypatch)
    _join_all(router, ["r0", "r1", "r2"])
    key = "sig|fp"
    owner = router.state.owners(key)[0]
    attempts = []

    async def send(rid):
        attempts.append(rid)
        if rid == owner:
            raise wire.UpstreamError("connect", "refused")
        return 200, {}, {"ok": True}

    async def no_sleep(_d):
        return None

    rid, tried, hedged, status, _h, body = asyncio.run(
        router.failover(key, send, sleep=no_sleep))
    assert status == 200 and body["ok"] and not hedged
    assert tried == 2
    assert attempts[0] == owner          # affinity owner tried first
    assert rid == attempts[1] != owner   # failover in ring order


def test_failover_5xx_retryable_and_breaker_opens(tmp_path, monkeypatch):
    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_RETRIES="5")
    _join_all(router, ["r0", "r1"])
    key = "k"
    owner = router.state.owners(key)[0]
    calls = {"r0": 0, "r1": 0}

    async def send(rid):
        calls[rid] += 1
        if rid == owner:
            return 500, {}, {"ok": False}
        return 200, {}, {"ok": True}

    async def no_sleep(_d):
        return None

    rid, _tried, _h, status, _hdrs, _b = asyncio.run(
        router.failover(key, send, sleep=no_sleep))
    assert status == 200 and rid != owner
    # drive the owner's breaker open with a second request (FAILS=2)
    asyncio.run(router.failover(key, send, sleep=no_sleep))
    assert router.state.breaker_states()[owner] == "open"
    # breaker-open owner is skipped entirely now: one attempt, no retry
    calls[owner] = 0
    rid, tried, _h, status, _hdrs, _b = asyncio.run(
        router.failover(key, send, sleep=no_sleep))
    assert status == 200 and tried == 1 and calls[owner] == 0


def test_failover_all_dead_is_503_with_retry_after(tmp_path, monkeypatch):
    from raft_tpu_torch.serve import wire

    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_RETRIES="2",
                        RAFT_TPU_ROUTER_BREAKER_FAILS="1")

    async def send(rid):
        raise wire.UpstreamError("connect", "refused")

    async def no_sleep(_d):
        return None

    # empty ring: immediate graceful 503
    rid, tried, _h, status, _hdrs, body = asyncio.run(
        router.failover("k", send, sleep=no_sleep))
    assert rid is None and status == 503 and tried == 0
    assert body["reason"] == "no_replicas"
    assert body["retry_after_s"] >= 1.0
    # both replicas dead: ladder exhausts, breakers open, reject
    _join_all(router, ["r0", "r1"])
    rid, tried, _h, status, _hdrs, body = asyncio.run(
        router.failover("k", send, sleep=no_sleep))
    assert rid is None and status == 503 and tried >= 1
    # now every breaker is open -> all_breakers_open without attempts
    rid, tried, _h, status, _hdrs, body = asyncio.run(
        router.failover("k", send, sleep=no_sleep))
    assert rid is None and status == 503 and tried == 0
    assert body["reason"] == "all_breakers_open"


def test_failover_backoff_delays_and_retry_after(tmp_path, monkeypatch):
    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_RETRIES="3",
                        RAFT_TPU_ROUTER_BACKOFF_MS="100",
                        RAFT_TPU_ROUTER_BACKOFF_CAP_MS="1000",
                        RAFT_TPU_ROUTER_BREAKER_FAILS="10")
    _join(router, "r0")
    delays = []
    n = {"v": 0}

    async def send(rid):
        n["v"] += 1
        if n["v"] < 4:
            # a draining replica: 503 with an explicit Retry-After
            return 503, {"retry-after": "1"}, {"ok": False}
        return 200, {}, {"ok": True}

    async def record_sleep(d):
        delays.append(round(d, 4))

    rid, tried, _h, status, _hdrs, _b = asyncio.run(
        router.failover("k", send, sleep=record_sleep))
    assert status == 200 and tried == 4
    # Retry-After=1s outranks the 0.1/0.2/0.4 exponential curve
    assert delays == [1.0, 1.0, 1.0]


def test_hedge_fires_after_delay_first_good_wins(tmp_path, monkeypatch):
    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_HEDGE_MS="10")
    _join_all(router, ["r0", "r1"])
    key = "k"
    owner = router.state.owners(key)[0]
    started = []

    async def send(rid):
        started.append(rid)
        if rid == owner:
            await asyncio.sleep(5.0)        # the p99 straggler
            return 200, {}, {"ok": True, "from": "straggler"}
        return 200, {}, {"ok": True, "from": "hedge"}

    t0 = time.monotonic()
    rid, tried, hedged, status, _hdrs, body = asyncio.run(
        router.failover(key, send))
    assert time.monotonic() - t0 < 2.0      # did not wait for straggler
    assert status == 200 and hedged and tried == 1
    assert rid != owner and body["from"] == "hedge"
    assert started == [owner, rid]          # hedge fired second


def test_hedge_not_fired_when_primary_fast(tmp_path, monkeypatch):
    router = _mk_router(tmp_path, monkeypatch,
                        RAFT_TPU_ROUTER_HEDGE_MS="5000")
    _join_all(router, ["r0", "r1"])

    async def send(rid):
        return 200, {}, {"ok": True}

    rid, tried, hedged, status, _hdrs, _b = asyncio.run(
        router.failover("k", send))
    assert status == 200 and not hedged and tried == 1


# ------------------------------------------------------ fleet lease ledger


def test_fleet_lease_claim_renew_expire_evict(tmp_path, monkeypatch):
    from raft_tpu_torch.serve.fleet import FleetLedger

    monkeypatch.setenv("RAFT_TPU_FLEET_TTL_S", "0.4")
    root = str(tmp_path)
    a = FleetLedger(root, replica_id="ra")
    assert a.claim(8001, designs={"spar": {"sig": "s", "fingerprint": "f"}},
                   buckets=["s"], healthz={"draining": False})
    # claim is exclusive per replica id
    a2 = FleetLedger(root, replica_id="ra")
    assert not a2.claim(8002)
    b = FleetLedger(root, replica_id="rb")
    assert b.claim(8003)
    obs = FleetLedger(root)
    assert set(obs.live()) == {"ra", "rb"}
    assert obs.live()["ra"]["port"] == 8001
    assert obs.live()["ra"]["designs"]["spar"]["sig"] == "s"
    # renew keeps a lease alive past its TTL; a silent replica expires
    time.sleep(0.25)
    assert a.renew(healthz={"draining": False, "pending": 0})
    time.sleep(0.25)
    live, expired = obs.live(), obs.expired()
    assert "ra" in live and "rb" not in live
    assert "rb" in expired and expired["rb"][1] > 0.4
    # eviction: exactly one winner, and the loser sees False
    assert obs.evict("rb", reason="expired", age_s=expired["rb"][1])
    assert not obs.evict("rb")
    assert set(obs.replicas()) == {"ra"}
    # release at drain start: lease gone while the process still runs
    assert a.release(reason="drain")
    assert obs.replicas() == {}
    assert not a.renew()      # a released lease is NOT silently re-claimed
    # token guard: a stranger never releases someone else's lease
    assert b.claim(8004)
    stranger = FleetLedger(root, replica_id="rb")
    assert not stranger.release()
    assert set(obs.replicas()) == {"rb"}


def test_fleet_summary_and_router_record(tmp_path, monkeypatch):
    from raft_tpu_torch.serve import fleet

    monkeypatch.setenv("RAFT_TPU_FLEET_TTL_S", "30")
    root = str(tmp_path)
    led = fleet.FleetLedger(root, replica_id="r0")
    led.claim(9000, designs={"spar": {"sig": "s", "fingerprint": "f"}})
    s = led.summary()
    assert s["n_live"] == 1 and s["replicas"]["r0"]["port"] == 9000
    assert s["router"] is None
    fleet.publish_router_record(root, {
        "version": 1, "t": time.time(), "pid": os.getpid(),
        "n_replicas": 1,
        "replicas": {"r0": {"addr": "127.0.0.1", "port": 9000,
                            "designs": ["spar"], "breaker": "closed"}},
        "designs": {"spar": "s"}})
    s = led.summary()
    assert s["router"]["n_replicas"] == 1
    assert s["router"]["replicas"] == ["r0"]


def test_prober_membership_reconciliation(tmp_path, monkeypatch):
    """Socket-free prober pass: joins admit, expiry evicts, the ring
    updates, router.json is published."""
    from raft_tpu_torch.serve import fleet
    from raft_tpu_torch.serve.router import LedgerProber, RouterState

    monkeypatch.setenv("RAFT_TPU_FLEET_TTL_S", "0.3")
    root = str(tmp_path)
    state = RouterState(vnodes=16)
    prober = LedgerProber(root, state, probe_http=False)
    a = fleet.FleetLedger(root, replica_id="ra")
    b = fleet.FleetLedger(root, replica_id="rb")
    a.claim(8001)
    b.claim(8002)
    added, removed = prober.probe_once()
    assert sorted(added) == ["ra", "rb"] and not removed
    assert state.snapshot()["n_replicas"] == 2
    assert state.endpoint("ra") == ("127.0.0.1", 8001)
    rec = fleet.read_router_record(root)
    assert rec["n_replicas"] == 2 and set(rec["replicas"]) == {"ra", "rb"}
    # rb dies (stops renewing): next pass evicts it from ledger + ring
    t0 = time.time()
    while time.time() - t0 < 2.0:
        a.renew()
        if fleet.FleetLedger(root).expired():
            break
        time.sleep(0.05)
    added, removed = prober.probe_once()
    assert removed == ["rb"] and state.snapshot()["n_replicas"] == 1
    assert "rb" not in fleet.FleetLedger(root).replicas()  # evicted
    # a drained replica leaves the ring without eviction machinery
    a.release()
    _added, removed = prober.probe_once()
    assert removed == ["ra"] and state.snapshot()["n_replicas"] == 0




# ------------------------------------------------- equal to the reference


def _seeded_payloads(n, seed):
    """``n`` /evaluate payloads from a numpy seed: named designs (known
    and unknown) and inline designs, with seeded case scalars."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = int(rng.integers(3))
        case = {"Hs": float(rng.uniform(1, 12)),
                "Tp": float(rng.uniform(4, 20)),
                "beta": float(rng.uniform(-1, 1))}
        if kind == 0:
            out.append(dict(case, design=str(rng.choice(
                ["spar", "semi", "mhk"]))))
        elif kind == 1:
            out.append(dict(case, design=f"d{int(rng.integers(50))}"))
        else:
            out.append(dict(case, design_inline={
                "type": "spar", "depth": float(rng.integers(100, 400)),
                "members": [int(x) for x in rng.integers(0, 9, 3)]}))
    return out


DESIGN_META = {"spar": {"sig": "0f327e60becd", "fingerprint": "fp-spar"},
               "semi": {"sig": "9a1b2c3d4e5f", "fingerprint": "fp-semi"},
               "mhk": {"sig": "77aa88bb99cc", "fingerprint": "fp-mhk"}}


@pytest.mark.parametrize("n_members", [2, 3, 4, 5])
def test_routing_key_and_ring_owners_equal_the_references(n_members):
    """1000 seeded payloads at 2-5 members: the port's routing keys and
    the ring's owner order are the reference's, before and after an add
    and a remove."""
    from raft_tpu.serve import router as jr
    from raft_tpu_torch.serve import router as tr

    payloads = _seeded_payloads(1000, seed=n_members)
    keys = [tr.routing_key(p, DESIGN_META) for p in payloads]
    assert keys == [jr.routing_key(p, DESIGN_META) for p in payloads]
    rng = np.random.default_rng(100 + n_members)
    rids = [f"r{int(x)}-{i}" for i, x in
            enumerate(rng.integers(0, 10 ** 6, n_members + 1))]
    t, j = tr.HashRing(vnodes=64), jr.HashRing(vnodes=64)
    for rid in rids[:n_members]:
        t.add(rid)
        j.add(rid)

    def owners():
        a = [t.owners(k) for k in keys]
        assert a == [j.owners(k) for k in keys]
        return a

    before = owners()
    t.add(rids[-1])
    j.add(rids[-1])
    added = owners()
    t.remove(rids[0])
    j.remove(rids[0])
    owners()
    # the ring moved only the keys the joiner took
    assert all(b[0] == a[0] or a[0] == rids[-1]
               for b, a in zip(before, added))


@pytest.mark.parametrize("seed", range(3))
def test_breaker_transitions_equal_the_references(seed):
    """The same injected clock and outcome sequence drive the port's and
    the reference's Breaker through the same states, admissions,
    transitions and Retry-After hints."""
    from raft_tpu.serve.router import Breaker as JB
    from raft_tpu_torch.serve.router import Breaker as TB

    rng = np.random.default_rng(seed)
    clock = [0.0]
    t = TB(fails=3, cooldown_s=2.0, clock=lambda: clock[0])
    j = JB(fails=3, cooldown_s=2.0, clock=lambda: clock[0])
    for _ in range(400):
        op = int(rng.integers(5))
        clock[0] += float(rng.choice([0.0, 0.3, 1.1, 2.5]))
        if op == 0:
            got, want = t.allow(), j.allow()
        elif op == 1:
            got, want = t.record_failure(), j.record_failure()
        elif op == 2:
            got, want = t.record_success(), j.record_success()
        elif op == 3:
            got, want = t.release_trial(), j.release_trial()
        else:
            got, want = t.retry_after_s(), j.retry_after_s()
        assert got == want
        assert t.state == j.state


@pytest.mark.parametrize("seed", range(2))
def test_router_state_transitions_equal_the_references(seed, monkeypatch):
    """Seeded membership passes (joins, leaves, same-rid endpoint
    replacements) and outcome sequences give the same ring updates,
    picks, breaker states, snapshots and ring views in both packages'
    RouterState under one injected monotonic clock."""
    from raft_tpu.serve import router as jr
    from raft_tpu_torch.serve import router as tr

    clock = [1000.0]
    for mod in (jr, tr):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    monkeypatch.setenv("RAFT_TPU_ROUTER_BREAKER_FAILS", "2")
    monkeypatch.setenv("RAFT_TPU_ROUTER_BREAKER_COOLDOWN_S", "1.5")
    rng = np.random.default_rng(seed)
    t, j = tr.RouterState(vnodes=32), jr.RouterState(vnodes=32)
    pool = [f"r{i}" for i in range(5)]
    keys = [tr.routing_key(p, DESIGN_META)
            for p in _seeded_payloads(40, seed)]
    for step in range(60):
        clock[0] += float(rng.choice([0.0, 0.5, 2.0]))
        if step % 6 == 0:
            members = [r for r in pool if rng.random() < 0.7] or pool[:1]
            live = {r: {"addr": "127.0.0.1",
                        "port": 1000 + pool.index(r)
                        + 100 * int(rng.integers(2)),
                        "designs": {n: DESIGN_META[n] for n in ("spar",
                                                                "semi")}}
                    for r in members}
            assert t.apply_membership(live) == j.apply_membership(live)
        rid = str(rng.choice(pool))
        if rng.random() < 0.5:
            t.record_failure(rid, "connect")
            j.record_failure(rid, "connect")
        else:
            t.record_success(rid)
            j.record_success(rid)
        k = keys[int(rng.integers(len(keys)))]
        attempt = int(rng.integers(3))
        assert t.pick(k, attempt) == j.pick(k, attempt)
        assert t.breaker_states() == j.breaker_states()
        assert t.min_retry_after_s() == j.min_retry_after_s()
    assert t.snapshot() == j.snapshot()
    assert t.ring_view() == j.ring_view()
    assert t.design_fingerprints() == j.design_fingerprints()


def test_fleet_ledgers_read_each_others_lease_directories(tmp_path,
                                                          monkeypatch):
    """A lease directory written by either package's FleetLedger is read
    by the other's with the same live set, records and summary; a seize
    and an eviction by one are seen by the other; the router record
    round-trips."""
    from raft_tpu.serve import fleet as jf
    from raft_tpu_torch.serve import fleet as tf

    monkeypatch.setenv("RAFT_TPU_FLEET_TTL_S", "30")
    root = str(tmp_path)
    meta = {"spar": {"sig": "s", "fingerprint": "f"}}
    assert tf.FleetLedger(root, replica_id="rt").claim(
        8001, designs=meta, buckets=["s"], out_keys=["X0", "status"])
    assert jf.FleetLedger(root, replica_id="rj").claim(
        8002, designs=meta, buckets=["s"], out_keys=["X0", "status"])
    # the same id is exclusive across packages
    assert not jf.FleetLedger(root, replica_id="rt").claim(9000)
    assert not tf.FleetLedger(root, replica_id="rj").claim(9000)
    now = time.time()
    t_obs, j_obs = tf.FleetLedger(root), jf.FleetLedger(root)
    assert t_obs.live(now) == j_obs.live(now)
    assert set(t_obs.live(now)) == {"rt", "rj"}
    assert t_obs.summary(now) == j_obs.summary(now)
    # a seize by the port's replica is the reference's takeover
    new = tf.FleetLedger(root, replica_id="rj")
    assert new.seize(8003, designs=meta)
    assert j_obs.live()["rj"]["port"] == 8003
    assert j_obs.live()["rj"]["token"] == new.token
    # an eviction by the reference is seen by the port
    assert jf.FleetLedger(root).evict("rt", reason="expired", age_s=1.0)
    assert set(t_obs.live()) == {"rj"}
    rec = {"version": 1, "t": now, "pid": 1, "n_replicas": 1,
           "replicas": {"rj": {"addr": "127.0.0.1", "port": 8003,
                               "designs": ["spar"], "breaker": "closed"}},
           "designs": {"spar": "s"}}
    jf.publish_router_record(root, rec)
    assert tf.read_router_record(root) == rec
    assert t_obs.summary(now)["router"] == j_obs.summary(now)["router"]

# ------------------------------------------------------ subprocess drills
#
# Everything below spawns real replica servers + the router (slow
# tier).  One module-scoped bank warmup is shared: the fleet contract
# is N replicas from ONE immutable bank, so the tests prove exactly
# that — replicas run RAFT_TPU_AOT=require + RAFT_TPU_COMPILE_BUDGET=0.

SPAR = os.path.join(FIX, "design_spar.json")
MHK = os.path.join(FIX, "design_mhk.json")
#: per-design case pools, small on purpose: repeats are what prove
#: cache affinity under the router
CASES = {
    "spar": [(4.0, 9.0, 0.0), (5.0, 10.0, 0.1), (6.0, 11.0, 0.0),
             (4.5, 9.5, -0.1)],
    "mhk": [(2.0, 7.0, 0.0), (2.5, 8.0, 0.1), (3.0, 9.0, 0.0),
            (3.5, 8.5, -0.1)],
}


@pytest.fixture(scope="module")
def warm_bank(tmp_path_factory):
    """Warm the serve programs for spar+mhk ONCE (ladder 1,2 on the CPU)
    into a module-shared bank — the fleet deploy artifact."""
    base = tmp_path_factory.mktemp("fleet_bank")
    bank = str(base / "bank")
    env = dict(os.environ,
               PYTHONPATH=ROOT,
               RAFT_TPU_SERVE_MAX_BATCH="2",
               RAFT_TPU_AOT="load", RAFT_TPU_AOT_DIR=bank)
    for drop in ("RAFT_TPU_LOG", "RAFT_TPU_FAULTS", "RAFT_TPU_AOT_MISS",
                 "RAFT_TPU_COMPILE_BUDGET"):
        env.pop(drop, None)
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.aot", "warmup", "--kinds",
         "serve", "--design", SPAR, "--design", MHK, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return {"bank": bank}


def _fleet_env(warm, logdir, extra=None):
    env = dict(os.environ,
               PYTHONPATH=ROOT,
               RAFT_TPU_SERVE_TICK_MS="10",
               RAFT_TPU_SERVE_MAX_BATCH="2",
               RAFT_TPU_SERVE_DRAIN_S="20",
               RAFT_TPU_FLEET_TTL_S="2.5",
               RAFT_TPU_AOT="require",
               RAFT_TPU_COMPILE_BUDGET="0",
               RAFT_TPU_AOT_DIR=warm["bank"],
               RAFT_TPU_LOG=str(logdir) + os.sep)
    env.pop("RAFT_TPU_FAULTS", None)
    env.update(extra or {})
    return env


def _spawn_replica(root, rid, env, out_path):
    with open(out_path, "ab") as logf:
        return subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.serve",
             "--designs", f"spar={SPAR}", "--designs", f"mhk={MHK}",
             "--port", "0", "--fleet-dir", str(root),
             "--replica-id", rid, "--device", "cpu"],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)


def _wait_live(root, rids, procs, deadline_s):
    from raft_tpu_torch.serve.fleet import FleetLedger

    ledger = FleetLedger(str(root))
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        live = ledger.live()
        if set(rids) <= set(live):
            return live
        for rid, p in procs.items():
            if rid in rids and p.poll() is not None:
                raise AssertionError(
                    f"replica {rid} exited rc={p.returncode} before "
                    "joining the fleet")
        time.sleep(0.3)
    raise AssertionError(f"replicas {rids} never all joined: "
                         f"{sorted(ledger.live())}")


def _spawn_router(root, env, extra=None):
    renv = dict(env)
    renv.update({"RAFT_TPU_ROUTER_PROBE_S": "0.4",
                 "RAFT_TPU_ROUTER_RETRIES": "5",
                 "RAFT_TPU_ROUTER_BACKOFF_MS": "25",
                 "RAFT_TPU_ROUTER_BACKOFF_CAP_MS": "400",
                 "RAFT_TPU_ROUTER_TIMEOUT_S": "120",
                 "RAFT_TPU_ROUTER_BREAKER_FAILS": "2",
                 "RAFT_TPU_ROUTER_BREAKER_COOLDOWN_S": "1"})
    renv.update(extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.serve", "router",
         "--fleet-dir", str(root), "--port", "0"],
        cwd=ROOT, env=renv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    for line in proc.stdout:
        if "routing" in line and "http://" in line:
            port = int(line.split("http://", 1)[1].split()[0]
                       .rsplit(":", 1)[1])
            return proc, port
        if time.monotonic() - t0 > 120:
            break
    raise AssertionError("router never printed its ready line")


def _wait_router_replicas(port, n, deadline_s=60):
    from raft_tpu_torch.serve.client import ServeClient

    c = ServeClient("127.0.0.1", port, timeout=30)
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < deadline_s:
            code, h = c.healthz()
            if code == 200 and h["n_replicas"] == n:
                return h
            time.sleep(0.4)
    finally:
        c.close()
    raise AssertionError(f"router never converged to {n} replicas: {h}")


def _read_fleet_events(logdir):
    events = []
    for name in os.listdir(logdir):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(logdir, name)) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass
    return events


def _terminate_all(procs, timeout=60):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait(timeout=10))
    return rcs


@pytest.mark.slow
def test_kill_a_replica_drill_zero_dropped(warm_bank, tmp_path):
    """THE acceptance drill: 2 replicas under 64 concurrent in-flight
    requests, SIGKILL one mid-burst — every accepted request resolves
    200/422 (zero dropped responses), the dead lease expires and is
    evicted from the ring, a replacement joins from the warm bank with
    zero backend compiles, a drain re-routes mid-flight work, and the
    whole session merges onto one trace with 0 orphan spans.

    The live fleet-health layer rides along: the router runs the
    alert engine (RAFT_TPU_ALERT_EVAL_S) + golden canary
    (RAFT_TPU_CANARY_S) — the SIGKILL must fire the breaker-storm
    alert within an eval interval and resolve it after the storm ends,
    the canary must pass on the bank-consistent fleet, and the steady
    phase must fire ZERO alerts (no false positives)."""
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.fleet import FleetLedger
    from raft_tpu_torch.serve.router import HashRing, routing_key

    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    alert_sink = tmp_path / "alerts.jsonl"
    # canary on fleet-wide: replicas capture their warmup goldens, the
    # router probes; the alert engine runs on the ROUTER only (its
    # registry carries the breaker/eviction counters the pack watches)
    env = _fleet_env(warm_bank, logdir,
                     extra={"RAFT_TPU_CANARY_S": "0.5"})
    router_alert_env = {"RAFT_TPU_ALERT_EVAL_S": "0.25",
                        "RAFT_TPU_ALERTS": str(alert_sink)}
    procs = {}
    results, errors = [], []
    t_kill = None
    try:
        procs["rA"] = _spawn_replica(root, "rA", env,
                                     tmp_path / "rA.out")
        _wait_live(root, {"rA"}, procs, 300)
        # pick the second replica's id so the two designs get DISTINCT
        # ring owners (the test reproduces the router's hash math —
        # both replicas then carry live traffic, and the kill target
        # is deterministic, not a coin flip)
        designs_meta = FleetLedger(str(root)).live()["rA"]["designs"]
        spar_key = routing_key({"design": "spar"}, designs_meta)
        mhk_key = routing_key({"design": "mhk"}, designs_meta)
        victim = None
        for i in range(128):
            trial = HashRing()
            trial.add("rA")
            trial.add(f"rB{i}")
            if trial.owners(spar_key)[0] == f"rB{i}" \
                    and trial.owners(mhk_key)[0] == "rA":
                victim = f"rB{i}"
                break
        assert victim is not None
        survivor = "rA"
        procs[victim] = _spawn_replica(root, victim, env,
                                       tmp_path / "rB.out")
        _wait_live(root, {"rA", victim}, procs, 300)
        router_proc, port = _spawn_router(root, env,
                                          extra=router_alert_env)
        procs["router"] = router_proc
        _wait_router_replicas(port, 2, 60)
        probe = ServeClient("127.0.0.1", port, timeout=60)
        ring = probe.request("GET", "/ring")[1]["ring"]
        assert ring["spar"][0] == victim and ring["mhk"][0] == survivor

        def pool_case(i, j):
            design = ("spar", "mhk")[(i + j) % 2]
            return design, CASES[design][(i * 7 + j) % len(CASES[design])]

        def fresh_case(phase):
            # phase-unique NEVER-cached cases: the kill/drain phases
            # must interrupt REAL in-flight dispatches, not resolve
            # from the result cache before the fault even lands
            def gen(i, j):
                if (i + j) % 2:
                    return "spar", (4.0 + 0.003 * (phase * 1000 + i * 8 + j),
                                    9.0 + 0.001 * i, 0.0)
                return "mhk", (2.0 + 0.003 * (phase * 1000 + i * 8 + j),
                               7.5 + 0.001 * i, 0.0)
            return gen

        def worker(i, n, phase, case_fn):
            cl = ServeClient("127.0.0.1", port, client_id=f"c{phase}-{i}",
                            timeout=300)
            try:
                for j in range(n):
                    design, case = case_fn(i, j)
                    code, body = cl.evaluate(design, *case)
                    results.append(
                        (phase, design, code,
                         bool(isinstance(body, dict)
                              and body.get("cache_hit")),
                         cl.last_headers.get("x-raft-replica")))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append((phase, i, repr(e)))
            finally:
                cl.close()

        def run_phase(phase, n_threads, reqs, case_fn=pool_case,
                      kill_after_s=None, kill_proc=None, drain_port=None):
            threads = [threading.Thread(target=worker,
                                        args=(i, reqs, phase, case_fn))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            if kill_after_s is not None:
                time.sleep(kill_after_s)
                if kill_proc is not None:
                    kill_proc.kill()          # SIGKILL, mid-burst
                if drain_port is not None:
                    dc = ServeClient("127.0.0.1", drain_port, timeout=30)
                    assert dc.request("POST", "/drain")[0] == 202
                    dc.close()
            for t in threads:
                t.join(timeout=600)
            assert not any(t.is_alive() for t in threads)

        # ---- phase 1: steady state — affinity + cache hit rate
        run_phase(1, 16, 6)
        assert not errors, errors
        p1 = [r for r in results if r[0] == 1]
        assert len(p1) == 96
        assert all(code == 200 for (_, _, code, _, _) in p1), \
            [r for r in p1 if r[2] != 200][:3]
        for design in ("spar", "mhk"):
            answered = {r[4] for r in p1 if r[1] == design}
            # affinity: every steady-state request for a design landed
            # on its ring owner — replica caches stay hot
            assert answered == {ring[design][0]}, (design, answered, ring)
        hit_rate = sum(1 for r in p1 if r[3]) / len(p1)
        # the acceptance bar: within 10% of single-server BENCH_r07's
        # 0.72 — the pool engineers ~0.85 ideal; in-tick coalescing of
        # simultaneous duplicates is the honest slack
        assert hit_rate >= 0.648, hit_rate

        # ---- phase 2: SIGKILL the spar owner under 64 in-flight
        # requests — all fresh cases, so every one is a REAL dispatch
        # (a cached row would resolve before the kill even lands)
        t_kill = time.time()   # steady state before this must be alert-free
        run_phase(2, 64, 1, case_fn=fresh_case(2), kill_after_s=0.25,
                  kill_proc=procs[victim])
        assert not errors, errors
        p2 = [r for r in results if r[0] == 2]
        assert len(p2) == 64
        # ZERO dropped responses: every accepted request resolved
        # 200/422 (the router retried the in-flight ones onto the
        # survivor; duplicate dispatch is benign by construction)
        assert all(code in (200, 422) for (_, _, code, _, _) in p2), \
            sorted({code for (_, _, code, _, _) in p2})
        assert procs[victim].wait(timeout=10) == -signal.SIGKILL
        # the dead replica's lease expires (TTL 2.5s) and is evicted
        h = _wait_router_replicas(port, 1, 30)
        assert victim not in h["replicas"]
        assert victim not in FleetLedger(str(root)).replicas()

        # ---- phase 3: replacement joins from the warm bank, zero
        # compiles, zero router restarts
        procs["rC"] = _spawn_replica(root, "rC", env, tmp_path / "rC.out")
        live = _wait_live(root, {"rC"}, procs, 300)
        _wait_router_replicas(port, 2, 60)
        hc = ServeClient("127.0.0.1", live["rC"]["port"], timeout=60)
        code, health = hc.healthz()
        hc.close()
        assert code == 200
        # what stands for the reference's xla_real_compiles == 0: the
        # replica built no program and ran no nvcc
        assert not health["kernel"]["built_here"]
        assert health["aot"]["builds"] == 0
        assert health["aot_programs_compiled"] == 0
        assert health["aot_programs_loaded"] >= 4  # 2 buckets x ladder(1,2)
        run_phase(3, 16, 2)
        assert not errors, errors
        p3 = [r for r in results if r[0] == 3]
        assert all(code in (200, 422) for (_, _, code, _, _) in p3)

        # ---- phase 4: graceful drain of a replica under load — lease
        # released at drain start, router re-routes, accepted work
        # finishes, process exits 0
        drain_port = FleetLedger(str(root)).live()[survivor]["port"]
        run_phase(4, 16, 2, case_fn=fresh_case(4), kill_after_s=0.1,
                  drain_port=drain_port)
        assert not errors, errors
        p4 = [r for r in results if r[0] == 4]
        assert all(code in (200, 422) for (_, _, code, _, _) in p4)
        assert procs[survivor].wait(timeout=60) == 0
        _wait_router_replicas(port, 1, 30)
        probe.close()

        # ---- teardown: SIGTERM the rest; clean exits
        rcs = _terminate_all([procs["rC"], procs["router"]])
        assert rcs == [0, 0], rcs
    finally:
        _terminate_all([p for p in procs.values() if p.poll() is None],
                       timeout=30)

    # ---- capture assertions: the ladder was exercised and registered
    events = _read_fleet_events(logdir)
    names = [e.get("event") for e in events]
    assert names.count("replica_join") >= 3          # rA, rB, rC
    assert names.count("replica_drain") >= 1         # phase-4 drain
    assert names.count("replica_evict") >= 1         # the SIGKILL victim
    assert names.count("router_retry") >= 1
    assert names.count("breaker_open") >= 1
    retries = [e for e in events if e.get("event") == "router_retry"]
    known = {"connect", "dropped", "closed", "timeout", "gone",
             "protocol", "http_500", "http_502", "http_503"}
    assert retries and all(e.get("reason") in known for e in retries), \
        sorted({e.get("reason") for e in retries})
    # ---- live fleet health: the SIGKILL fired breaker-storm (within
    # an eval interval of the first breaker open), the storm RESOLVED
    # once the replacement fleet went quiet, the steady phase fired
    # ZERO false alerts, and the bank-consistent canary stayed green
    from raft_tpu_torch.obs.alerts import read_sink

    records, bad = read_sink(str(alert_sink))
    assert bad == 0
    fires = [r for r in records if r["kind"] == "fire"]
    assert fires, "no alert ever fired across the kill drill"
    assert min(r["t_unix"] for r in fires) >= t_kill - 0.5, \
        ("an alert fired during the steady phase", t_kill, fires)
    assert {r["rule"] for r in fires} <= {"breaker-storm", "lease-churn"}, \
        fires
    storm = [r for r in records if r["rule"] == "breaker-storm"]
    storm_fires = [r["t_unix"] for r in storm if r["kind"] == "fire"]
    storm_resolves = [r["t_unix"] for r in storm if r["kind"] == "resolve"]
    assert storm_fires, "breaker-storm never fired on the SIGKILL"
    assert storm_resolves and min(storm_resolves) > min(storm_fires), \
        ("breaker-storm never resolved after the replacement joined",
         storm)
    assert names.count("alert_fire") >= 1
    assert names.count("alert_resolve") >= 1
    # canary: replicas captured warmup goldens, the router probed every
    # (replica, design) pair, and the bank-consistent fleet never
    # tripped a parity/golden failure
    checks = [e for e in events if e.get("event") == "canary_check"]
    assert checks, "router canary never probed"
    assert all(c.get("ok") for c in checks), \
        [c for c in checks if not c.get("ok")][:3]
    assert names.count("canary_golden") >= 2
    # provenance stamped end to end: routed responses carried the
    # replica's x-raft-provenance, and every stamp agreed on bank+code
    provs = [e for e in events if e.get("event") == "router_request"
             and e.get("provenance")]
    assert provs, "no routed response carried a provenance stamp"
    from raft_tpu_torch.obs.alerts import parse_provenance

    stamped = {(parse_provenance(e["provenance"]) or {}).get("bank_sha")
               for e in provs if e.get("design") == "spar"}
    assert len(stamped) == 1 and "none" not in stamped, stamped
    # ---- one merged timeline, zero orphan spans.  The SIGKILLed
    # victim's shard legitimately carries unmatched span BEGINS (it
    # died mid-span — that is the drill), so the strict balanced-spans
    # --check runs over the surviving processes' shards; the full
    # merge must still resolve every cross-process parent (0 orphans).
    merged = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs", "trace", "--merge",
         str(logdir), "-o", str(tmp_path / "merged.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert merged.returncode == 0, merged.stdout + merged.stderr
    meta = json.loads((tmp_path / "merged.json").read_text())["otherData"]
    assert meta["spans_orphaned"] == 0, meta
    assert meta["pids"] >= 4, meta          # router + rA/victim/rC
    survivors_dir = tmp_path / "logs_survivors"
    survivors_dir.mkdir()
    victim_shard = f"trace-{procs[victim].pid}.jsonl"
    for name in os.listdir(logdir):
        if name.endswith(".jsonl") and name != victim_shard:
            (survivors_dir / name).write_bytes(
                (logdir / name).read_bytes())
    checked = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs", "trace", "--merge",
         str(survivors_dir), "-o", str(tmp_path / "merged_ok.json"),
         "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert checked.returncode == 0, checked.stdout + checked.stderr


@pytest.mark.slow
def test_replica_fault_kinds_drive_failover(warm_bank, tmp_path):
    """The three replica fault kinds drive the ladder deterministically:
    replica_hang -> per-attempt timeout + retry; replica_5xx ->
    retryable 500 + retry; replica_kill -> SIGKILL mid-request +
    failover to the survivor, all invisible to the client."""
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.fleet import FleetLedger
    from raft_tpu_torch.serve.router import HashRing, routing_key

    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    base_env = _fleet_env(warm_bank, logdir,
                          extra={"RAFT_TPU_SERVE_TIMEOUT_S": "30"})
    procs = []
    try:
        # rF alone owns everything: its armed faults fire in a known
        # order (hang first, then two 5xx) on the first client request
        envF = dict(base_env)
        envF["RAFT_TPU_FAULTS"] = ("replica_hang:serve_evaluate:1,"
                                   "replica_5xx:serve_evaluate:2")
        pF = _spawn_replica(root, "rF", envF, tmp_path / "rF.out")
        procs.append(pF)
        _wait_live(root, {"rF"}, {"rF": pF}, 300)
        router_proc, port = _spawn_router(
            root, base_env, extra={"RAFT_TPU_ROUTER_TIMEOUT_S": "4",
                                   "RAFT_TPU_ROUTER_BREAKER_FAILS": "10"})
        procs.append(router_proc)
        _wait_router_replicas(port, 1, 60)

        c = ServeClient("127.0.0.1", port, client_id="fault", timeout=120)
        code, body = c.evaluate("spar", *CASES["spar"][0])
        # hang (timeout) -> 500 -> 500 -> success, all on one request
        assert code == 200 and body["ok"], (code, body)
        _code, h = c.healthz()
        assert h["router_retries"] >= 3
        assert h["router_upstream_errors"] >= 3

        # ---- replica_kill: pick the joiner's id so it OWNS spar (the
        # test reproduces the router's ring math, so the kill target is
        # deterministic, not a coin flip)
        lease = FleetLedger(str(root)).live()["rF"]
        spar_key = routing_key({"design": "spar"}, lease["designs"])
        kill_id = None
        for i in range(64):
            ring = HashRing()
            ring.add("rF")
            ring.add(f"rK{i}")
            if ring.owners(spar_key)[0] == f"rK{i}":
                kill_id = f"rK{i}"
                break
        assert kill_id is not None
        envK = dict(base_env)
        envK["RAFT_TPU_FAULTS"] = "replica_kill:serve_evaluate:1"
        pK = _spawn_replica(root, kill_id, envK, tmp_path / "rK.out")
        procs.append(pK)
        _wait_live(root, {kill_id}, {kill_id: pK}, 300)
        _wait_router_replicas(port, 2, 60)
        # this request routes to the armed owner, which SIGKILLs itself
        # mid-request; the router fails it over to rF — still a 200
        code, body = c.evaluate("spar", *CASES["spar"][1])
        assert code == 200 and body["ok"], (code, body)
        assert pK.wait(timeout=30) == -signal.SIGKILL
        assert c.last_headers.get("x-raft-replica") == "rF"
        _wait_router_replicas(port, 1, 30)   # lease expired + evicted
        c.close()
    finally:
        _terminate_all([p for p in procs if p.poll() is None],
                       timeout=30)


@pytest.mark.slow
def test_canary_catches_stale_bank_provenance(warm_bank, tmp_path):
    """A provenance-divergent replica trips ``canary_parity`` with the
    offending provenance named in the alert payload.  The divergence
    is injected with the deterministic ``provenance_skew`` fault (the
    drill's stand-in for a genuinely stale-banked / env-skewed
    replica — same bank bytes, skewed reported identity): both
    replicas answer identical NUMBERS, so health bits, breakers and
    the golden compare all stay green — only the cross-replica
    provenance consistency check can see it."""
    import urllib.request

    from raft_tpu_torch.obs.alerts import read_sink
    from raft_tpu_torch.serve.client import ServeClient

    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    alert_sink = tmp_path / "alerts.jsonl"
    env = _fleet_env(warm_bank, logdir)
    envB = dict(env)
    envB["RAFT_TPU_FAULTS"] = "provenance_skew:serve_provenance:1"
    procs = []
    try:
        pA = _spawn_replica(root, "rA", env, tmp_path / "rA.out")
        procs.append(pA)
        pB = _spawn_replica(root, "rB", envB, tmp_path / "rB.out")
        procs.append(pB)
        _wait_live(root, {"rA", "rB"}, {"rA": pA, "rB": pB}, 300)
        router_proc, port = _spawn_router(
            root, env, extra={"RAFT_TPU_CANARY_S": "0.5",
                              "RAFT_TPU_ALERT_EVAL_S": "0.25",
                              "RAFT_TPU_ALERTS": str(alert_sink)})
        procs.append(router_proc)
        _wait_router_replicas(port, 2, 60)

        # the canary probes both replicas directly; within a few probe
        # + eval periods the provenance split must be firing at /alerts
        deadline = time.monotonic() + 60
        payload = None
        while time.monotonic() - deadline < 0:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/alerts", timeout=10) as r:
                payload = json.loads(r.read())
            active = {a["rule"] for a in payload.get("active") or ()}
            if "canary-parity" in active:
                break
            time.sleep(0.5)
        active = {a["rule"]: a for a in payload.get("active") or ()}
        assert "canary-parity" in active, payload
        # the alert payload names the offending provenance: the split
        # field(s) and the per-replica values, rB carrying the skew
        ctx = active["canary-parity"]["context"]
        splits = ctx["provenance"]["splits"]
        assert splits, ctx
        by_field = {s["field"]: s for s in splits}
        assert "bank_sha" in by_field, by_field
        assert by_field["bank_sha"]["values"]["rB"].startswith("skew"), \
            by_field
        assert not by_field["bank_sha"]["values"]["rA"].startswith("skew")
        # canary summary at the endpoint agrees
        assert payload["canary"]["parity_ok"] is False
        assert payload["canary"]["fails"] >= 1
        # the sink recorded the fire with the same context
        records, bad = read_sink(str(alert_sink))
        assert bad == 0
        parity = [r for r in records
                  if r["rule"] == "canary-parity" and r["kind"] == "fire"]
        assert parity and parity[0]["context"]["provenance"]["splits"]

        # client-visible provenance through the router: the response
        # stamp parses into last_provenance and names the replica that
        # answered (serve/client.py last_provenance)
        c = ServeClient("127.0.0.1", port, client_id="prov", timeout=120)
        code, _body = c.evaluate("spar", *CASES["spar"][0])
        assert code in (200, 422)
        assert c.last_provenance is not None, c.last_headers
        assert c.last_provenance["replica"] == \
            c.last_headers.get("x-raft-replica")
        assert {"bank_key", "bank_sha", "code", "flags"} <= \
            set(c.last_provenance)
        c.close()
    finally:
        _terminate_all([p for p in procs if p.poll() is None],
                       timeout=30)
    # the merged capture's report renders the INCONSISTENT provenance
    # line and the alerts section (canary failures included)
    events = _read_fleet_events(logdir)
    from raft_tpu_torch.obs.report import report_data

    data = report_data(events)
    assert data["alerts"] is not None
    assert data["alerts"]["canary"]["provenance_failures"] >= 1
    prov = (data["router"] or {}).get("provenance")
    if prov is not None:
        # the router section's consistency verdict (needs routed
        # traffic from BOTH replicas to see the split; the canary
        # section above is the authoritative detector)
        assert "splits" in prov


def test_report_router_section():
    """The obs-report fleet-router table renders from router events."""
    from raft_tpu_torch.obs.report import render_report, report_data

    events = [{"t": 0.0, "event": "proc_start", "unix_t": 0.0,
               "argv0": "x", "pid": 1}]
    for i in range(6):
        events.append({"t": 0.1 * i, "pid": 1, "event": "router_request",
                       "replica": "r0" if i % 2 else "r1", "code": 200,
                       "attempts": 1 + (i == 5), "hedged": False,
                       "design": "spar", "wall_s": 0.01 * (i + 1)})
    events.append({"t": 1.0, "pid": 1, "event": "router_retry",
                   "replica": "r0", "attempt": 1, "reason": "connect",
                   "delay_s": 0.05})
    events.append({"t": 1.1, "pid": 1, "event": "breaker_open",
                   "replica": "r1", "reason": "connect", "fails": 3,
                   "cooldown_s": 5.0})
    events.append({"t": 1.2, "pid": 1, "event": "replica_evict",
                   "replica": "r1", "reason": "expired", "age_s": 2.0,
                   "root": "/tmp/f"})
    data = report_data(events)
    router = data["router"]
    assert router["router_retry"] == 1
    assert router["breaker_open"] == 1 and router["replica_evict"] == 1
    rows = {(r["replica"], r["code"]): r for r in router["replicas"]}
    assert rows[("r0", 200)]["requests"] == 3
    assert rows[("r1", 200)]["requests"] == 3
    text = render_report(events)
    assert "fleet router" in text and "breakers 1 opened" in text
    # no router events -> no section
    assert report_data(events[:1])["router"] is None

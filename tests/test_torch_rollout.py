"""The port's rolling upgrades (``raft_tpu_torch/serve/rollout.py``)
against the reference's ``tests/test_rollout.py``, test for test under
the same names: the fast socket-free state machine (run_rollout against
a fake FleetOps with injected canary verdicts, the rollout-record
contract, the same-rid ring-replacement router fix, the lease seize
primitive), plus the slow-tier end-to-end drills on the CPU (replicas
``--device cpu``) — a live 2-replica fleet + router + canary under load
rolled A -> B (ladder change, zero dropped requests, no key movement)
and then B -> C where C's candidate is provenance-skewed: the canary
goes red and the rollout rolls itself back to B with no operator input;
a stale bank failing fast; the autoscaler's actuators against a real
fleet.  Where the reference asserts zero XLA compiles, the port's
replica reports what it built (``kernel.built_here``, ``aot.builds``).

Beyond the reference: ``gate_decision``, ``build_record`` and
``summarize_record`` held against the JAX package's on the same seeded
inputs."""

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
SPAR = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                    "design_spar.json")


@pytest.fixture(autouse=True)
def _raft_env_guard():
    """Fail a test that leaves a RAFT_TPU_* variable behind (rollout
    drivers and autoscalers are built in this process)."""
    with raft_env_unchanged():
        yield


# --------------------------------------------------- fast: state machine


class FakeOps:
    """Socket-free FleetOps stand-in: scripted canary verdicts, lease
    seizes modeled as token bumps, every side effect logged."""

    def __init__(self, fleet, verdicts=()):
        self.fleet = {rid: dict(rec) for rid, rec in fleet.items()}
        self.verdicts = list(verdicts)
        self.calls = []
        self._tok = 0

    def live(self):
        return {rid: dict(rec) for rid, rec in self.fleet.items()}

    def spawn_takeover(self, rid, env):
        self.calls.append(("spawn", rid, dict(env or {})))
        return None

    def wait_takeover(self, rid, prev_rec, timeout_s, proc=None):
        self._tok += 1
        rec = dict(prev_rec or {"replica": rid})
        rec["token"] = f"t{self._tok}"
        self.fleet[rid] = rec
        self.calls.append(("seize", rid))
        return rec

    def drain(self, rec):
        self.calls.append(("drain", (rec or {}).get("token")))
        return True

    def canary_baseline(self):
        return {"passes": 0, "fails": 0}

    def canary_verdict(self, baseline, timeout_s, replica=None,
                       endpoint=None):
        ok, why = (self.verdicts.pop(0) if self.verdicts
                   else (True, "canary-green(2)"))
        self.calls.append(("verdict", ok))
        return ok, why


@pytest.fixture()
def releases_ab(tmp_path, monkeypatch):
    """A parent/child release pair (empty entry sets: the bank check is
    trivially clean) with A promoted, plus distinguishable captured
    envs so the tests can see WHICH release's env spawned a replica."""
    from raft_tpu_torch.aot import bank, release

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    release._PARITY_CACHE[:] = []

    def cut(flags, env, parent=None, promote=False):
        man = release.build_manifest({}, bank.code_fingerprint(), flags,
                                     parent=parent)
        man["env"] = dict(env)
        release.sign_manifest(man)
        os.makedirs(release.releases_dir(), exist_ok=True)
        bank._atomic_write(
            release.manifest_path(man["release"]),
            (json.dumps(man, sort_keys=True) + "\n").encode())
        if promote:
            release.promote(man["release"])
        return man

    a = cut("fa", {"RAFT_TPU_SERVE_MAX_BATCH": "2"}, promote=True)
    b = cut("fb", {"RAFT_TPU_SERVE_MAX_BATCH": "4"},
            parent=a["release"])
    return release, a, b


def _fleet2():
    return {"r0": {"replica": "r0", "port": 1000, "token": "a0"},
            "r1": {"replica": "r1", "port": 1001, "token": "a1"}}


def test_rollout_green_path(releases_ab, tmp_path):
    from raft_tpu_torch.serve import rollout

    release, a, b = releases_ab
    ops = FakeOps(_fleet2())
    record = rollout.run_rollout(str(tmp_path), b["release"],
                                 ["spar=x.yaml"], ops=ops)
    assert record["ok"] and not record["rolled_back"]
    assert record["to"] == b["release"]
    assert record["from"] == a["release"]
    assert record["replaced"] == ["r0", "r1"]
    assert record["aborted"] is None
    assert [s["phase"] for s in record["steps"]] == ["upgrade", "upgrade"]
    assert release.current_release() == b["release"]
    assert release.read_rollout_marker() is None  # cleared on the way out
    # each replica: spawn under the CANDIDATE env -> seize -> drain the
    # old owner -> canary gate, in replica-id order
    spawns = [c for c in ops.calls if c[0] == "spawn"]
    assert [c[1] for c in spawns] == ["r0", "r1"]
    assert all(c[2].get("RAFT_TPU_SERVE_MAX_BATCH") == "4"
               for c in spawns)
    assert [c[0] for c in ops.calls[:4]] == ["spawn", "seize", "drain",
                                             "verdict"]
    drains = [c for c in ops.calls if c[0] == "drain"]
    assert [c[1] for c in drains] == ["a0", "a1"]  # the OLD tokens
    assert rollout.summarize_record(record).startswith(
        f"rollout {b['release']}: upgraded (2 replaced")


def test_rollout_red_canary_rolls_back(releases_ab, tmp_path):
    from raft_tpu_torch.serve import rollout

    release, a, b = releases_ab
    marker_seen = []

    class Ops(FakeOps):
        def canary_verdict(self, baseline, timeout_s, replica=None,
                           endpoint=None):
            # the expected-skew window must be OPEN while steps gate
            marker_seen.append(release.read_rollout_marker())
            return super().canary_verdict(baseline, timeout_s,
                                          replica=replica,
                                          endpoint=endpoint)

    ops = Ops(_fleet2(), verdicts=[(True, "canary-green(2)"),
                                   (False, "canary-parity")])
    record = rollout.run_rollout(str(tmp_path), b["release"],
                                 ["spar=x.yaml"], ops=ops)
    assert not record["ok"] and record["rolled_back"]
    assert record["reason"] == "canary-parity"
    # the postmortem contract: the record NAMES the aborted release
    assert record["aborted"] == b["release"]
    assert record["replaced"] == []
    # automatic rollback: current re-points at the parent, and BOTH
    # touched replicas (the green r0 and the red r1 — its seize may
    # have landed) are re-seized under the PARENT env
    assert release.current_release() == a["release"]
    phases = [(s["phase"], s["replica"]) for s in record["steps"]]
    assert phases == [("upgrade", "r0"), ("upgrade", "r1"),
                      ("rollback", "r0"), ("rollback", "r1")]
    spawns = [c for c in ops.calls if c[0] == "spawn"]
    assert [c[2].get("RAFT_TPU_SERVE_MAX_BATCH") for c in spawns] == \
        ["4", "4", "2", "2"]
    assert release.read_rollout_marker() is None
    assert all(m and m["from"] == a["release"] and m["to"] == b["release"]
               for m in marker_seen)
    assert "rolled back" in rollout.summarize_record(record)


def test_rollout_join_timeout_rolls_back(releases_ab, tmp_path):
    from raft_tpu_torch.serve import rollout

    release, a, b = releases_ab

    class Ops(FakeOps):
        def wait_takeover(self, rid, prev_rec, timeout_s, proc=None):
            if rid == "r0" and release.current_release() == b["release"]:
                return None  # candidate never seized
            return super().wait_takeover(rid, prev_rec, timeout_s, proc)

    record = rollout.run_rollout(str(tmp_path), b["release"],
                                 ["spar=x.yaml"], ops=Ops(_fleet2()))
    assert not record["ok"] and record["reason"] == "join-timeout"
    assert release.current_release() == a["release"]


def test_rollout_refuses_bad_candidate_before_promote(releases_ab,
                                                      tmp_path):
    from raft_tpu_torch.aot import bank
    from raft_tpu_torch.serve import rollout

    release, a, b = releases_ab
    ops = FakeOps(_fleet2())
    with pytest.raises(FileNotFoundError):
        rollout.run_rollout(str(tmp_path), "000000000000",
                            ["spar=x.yaml"], ops=ops)
    # tamper the stored candidate: the preflight refuses BEFORE any
    # promote/spawn — the fleet is untouched
    path = release.manifest_path(b["release"])
    man = json.loads(open(path, encoding="utf-8").read())
    man["flags"] = "tampered"
    bank._atomic_write(path, json.dumps(man).encode())
    with pytest.raises(ValueError, match="refusing to roll out"):
        rollout.run_rollout(str(tmp_path), b["release"],
                            ["spar=x.yaml"], ops=ops)
    assert release.current_release() == a["release"]
    assert ops.calls == []
    assert release.read_rollout_marker() is None


def test_rollout_record_is_run_recorded(releases_ab, tmp_path,
                                        monkeypatch):
    from raft_tpu_torch.serve import rollout

    release, a, b = releases_ab
    runs_dir = tmp_path / "runs"
    monkeypatch.setenv("RAFT_TPU_RUNS_DIR", str(runs_dir))
    rollout.run_rollout(str(tmp_path), b["release"], ["spar=x.yaml"],
                        ops=FakeOps(_fleet2()))
    recs = []
    for name in os.listdir(runs_dir):
        with open(runs_dir / name, encoding="utf-8") as f:
            recs.append(json.load(f))
    mine = [r for r in recs if r.get("kind") == "rollout"]
    assert mine and mine[0]["label"] == b["release"]
    assert mine[0]["extra"]["to"] == b["release"]
    assert mine[0]["extra"]["ok"] is True


# ---------------------------------------- fast: ring replacement + seize


def test_apply_membership_replaced_same_rid_no_key_movement():
    """Satellite regression: a same-rid endpoint change (the rollout
    seize) must count as REPLACED — ring untouched, breaker reset —
    not as an evict+join churning vnodes."""
    from raft_tpu_torch.serve.router import RouterState

    st = RouterState(vnodes=64)
    live = {"r0": {"addr": "127.0.0.1", "port": 1000, "designs": {}},
            "r1": {"addr": "127.0.0.1", "port": 1001, "designs": {}}}
    assert st.apply_membership(live) == (["r0", "r1"], [], [])
    keys = [f"sig{i}|fp{i}" for i in range(64)]
    before = {k: st.owners(k) for k in keys}
    # open r0's breaker, then seize: new endpoint, same rid
    for _ in range(8):
        st.record_failure("r0", "connect")
    assert st.breaker_states().get("r0") == "open"
    live2 = {"r0": {"addr": "127.0.0.1", "port": 2000, "designs": {}},
             "r1": dict(live["r1"])}
    added, removed, replaced = st.apply_membership(live2)
    assert (added, removed, replaced) == ([], [], ["r0"])
    # zero key movement: every owner list is byte-identical
    assert {k: st.owners(k) for k in keys} == before
    # the new process starts with a CLOSED breaker (old failures were
    # the old process's)
    assert st.breaker_states().get("r0") == "closed"
    assert st.endpoint("r0") == ("127.0.0.1", 2000)
    # an unchanged membership pass reports nothing
    assert st.apply_membership(live2) == ([], [], [])


def test_canary_prune_voids_replaced_endpoint_stamp(tmp_path,
                                                    monkeypatch):
    """The takeover-race regression: the canary's last observation of
    a rid can predate its seize.  Once membership shows the rid at a
    NEW endpoint, the old-endpoint stamp must be voided — otherwise
    parity red-flags the fleet for one probe interval exactly as the
    rollout's expected-skew window closes."""
    from raft_tpu_torch.aot import bank, release
    from raft_tpu_torch.serve.canary import CanaryState

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    release._PARITY_CACHE[:] = []
    sha_b = "b" * 16
    man = release.build_manifest({"k": {"payload_sha256": sha_b * 4}},
                                 "code", "flags")
    release.sign_manifest(man)
    os.makedirs(release.releases_dir(), exist_ok=True)
    bank._atomic_write(release.manifest_path(man["release"]),
                       (json.dumps(man, sort_keys=True) + "\n").encode())
    release.promote(man["release"])

    st = CanaryState(rtol=1e-6, atol=1e-9)
    stamp_new = {"release": man["release"], "bank_sha": sha_b,
                 "bank_key": "k", "code": "code", "flags": "flags"}
    stamp_old = dict(stamp_new, release="aaaaaaaaaaaa",
                     bank_sha="a" * 16)
    # r1's stamp was probed from its pre-takeover endpoint; r0 is
    # already on the new release.  No rollout marker: allowed = {new}.
    st.observe("spar", "r1", "fp", (4.0, 9.0, 0.0), ("status",), {},
               0, provenance=stamp_old, endpoint="127.0.0.1:1001")
    st.observe("spar", "r0", "fp", (4.0, 9.0, 0.0), ("status",), {},
               0, provenance=stamp_new, endpoint="127.0.0.1:1000")
    assert st.summary()["provenance"]["consistent"] is False
    # membership now shows r1 at its post-seize endpoint: the stale
    # stamp is void, parity green WITHOUT waiting for r1's next probe
    live = {"r0": {"addr": "127.0.0.1", "port": 1000},
            "r1": {"addr": "127.0.0.1", "port": 2001}}
    assert st.prune(live) is True
    summ = st.summary()
    assert summ["provenance"]["consistent"] is True
    assert summ["parity_ok"] is True
    # same-endpoint membership is NOT a takeover: nothing dropped
    st.observe("spar", "r1", "fp", (4.0, 9.0, 0.0), ("status",), {},
               0, provenance=stamp_new, endpoint="127.0.0.1:2001")
    assert st.prune(live) is False
    assert st.summary()["provenance"]["consistent"] is True
    # plain-iterable membership (replica-id only) still prunes departures
    assert st.prune(["r1"]) is True   # r0 left the fleet
    assert st.prune(["r1"]) is False


def test_canary_verdict_requires_probes_of_the_new_endpoint(
        tmp_path, monkeypatch):
    """The green-without-probing regression, both flavors: fleet-wide
    fresh passes accrue from the candidate's healthy neighbors, and
    per-rid probe counts accrue from the OLD process still answering
    its drain window while the canary's membership snapshot is a beat
    stale.  The gate must count the canary's observation run AT the
    post-seize endpoint — the process identity."""
    from raft_tpu_torch.serve import rollout

    monkeypatch.setenv("RAFT_TPU_ROLLOUT_CANARY_PROBES", "2")
    monkeypatch.setenv("RAFT_TPU_ROLLOUT_POLL_S", "0.01")
    payloads = []

    def fake_get(url, path, timeout_s=5.0):
        return payloads.pop(0) if len(payloads) > 1 else payloads[0]

    monkeypatch.setattr(rollout, "_http_get_json", fake_get)
    ops = rollout.FleetOps(str(tmp_path), ["spar=x.yaml"],
                           router_url="http://127.0.0.1:1")
    base = {"passes": 10, "fails": 0}
    new_ep = "127.0.0.1:2000"

    def can(passes, probes):
        return {"canary": {"passes": passes, "fails": 0,
                           "parity_ok": True, "probes": probes},
                "active": []}

    # neighbors rack up fleet-wide passes AND the draining old process
    # at :1000 keeps answering probes: neither may green the gate
    stale = {"r0": {"endpoint": "127.0.0.1:1000", "n": 7},
             "r1": {"endpoint": "127.0.0.1:1001", "n": 13}}
    payloads[:] = [can(30, stale)]
    ok, why = ops.canary_verdict(base, timeout_s=0.05, replica="r0",
                                 endpoint=new_ep)
    assert (ok, why) == (False, "canary-timeout")
    # the canary's run restarted at the new endpoint: its count IS the
    # new process's probe count — 2 observations = green
    payloads[:] = [can(31, {"r0": {"endpoint": new_ep, "n": 1}}),
                   can(32, {"r0": {"endpoint": new_ep, "n": 2}})]
    ok, why = ops.canary_verdict(base, timeout_s=5.0, replica="r0",
                                 endpoint=new_ep)
    assert ok is True and why == "canary-green(2)"
    # no replica/endpoint named (API compat): global fresh passes gate
    payloads[:] = [can(18, {})]
    ok, why = ops.canary_verdict(base, timeout_s=5.0)
    assert ok is True and why == "canary-green(8)"
    # fresh fails anywhere stay an immediate red regardless of probes
    payloads[:] = [{"canary": {"passes": 30, "fails": 1,
                               "parity_ok": True,
                               "probes": {"r0": {"endpoint": new_ep,
                                                 "n": 9}}},
                    "active": []}]
    ok, why = ops.canary_verdict(base, timeout_s=5.0, replica="r0",
                                 endpoint=new_ep)
    assert (ok, why) == (False, "canary-fail")


def test_fleet_seize_takes_over_lease(tmp_path):
    from raft_tpu_torch.serve.fleet import FleetLedger

    old = FleetLedger(str(tmp_path), replica_id="r0")
    assert old.claim(port=1000, designs={"spar": {}})
    prev = old.read("r0")[0]
    new = FleetLedger(str(tmp_path), replica_id="r0")
    assert new.seize(port=2000, designs={"spar": {}})
    rec = new.read("r0")[0]
    assert rec["port"] == 2000 and rec["token"] == new.token
    assert rec["token"] != prev["token"]
    # the dispossessed owner's renew/release no-op on token mismatch —
    # membership never flaps back to the old endpoint
    assert not old.renew()
    assert not old.release()
    assert new.read("r0")[0]["port"] == 2000
    # exactly one live lease, same rid throughout
    assert sorted(FleetLedger(str(tmp_path)).live()) == ["r0"]


def test_seize_outlasts_the_displaced_owners_inflight_renewal(tmp_path):
    """The old owner's renewal reads its lease, the seize lands, then
    the renewal writes the old record back (a lost update): the seizer's
    next renewal takes the lease again, and the old owner's next one
    stops."""
    from raft_tpu_torch.serve.fleet import FleetLedger

    old = FleetLedger(str(tmp_path), replica_id="r0")
    assert old.claim(port=1000, designs={"spar": {}})
    new = FleetLedger(str(tmp_path), replica_id="r0")
    read = old.read

    def read_then_seize(rid):
        got = read(rid)
        assert new.seize(port=2000, designs={"spar": {}})
        return got

    old.read = read_then_seize
    assert old.renew()          # wrote over the seize
    del old.read
    assert old.read("r0")[0]["token"] == old.token
    assert new.renew()          # takes the lease again
    rec = new.read("r0")[0]
    assert rec["token"] == new.token and rec["port"] == 2000
    assert not old.renew()
    assert FleetLedger(str(tmp_path)).live()["r0"]["token"] == new.token
    # a lease of a third owner is not the displaced one's: no re-seize
    third = FleetLedger(str(tmp_path), replica_id="r0")
    assert third.seize(port=3000, designs={"spar": {}})
    assert not new.renew()
    assert new.read("r0")[0]["token"] == third.token


# ------------------------------------------------- slow: the real drill


@pytest.fixture(scope="module")
def release_bank(tmp_path_factory):
    """Warm the spar serve programs under ladder A (max batch 2) and
    cut + promote release A — the fleet's starting state."""
    base = tmp_path_factory.mktemp("release_bank")
    bank = str(base / "bank")
    env = dict(os.environ,
               PYTHONPATH=ROOT,
               RAFT_TPU_SERVE_MAX_BATCH="2",
               # pow2, not the cost-pruned default: refinement reads
               # the bank's cost ledger, so a SECOND replica warming
               # after the first could prune differently — a per-
               # replica ladder split is exactly what the parity
               # canary alarms on, and this drill needs it QUIET
               # outside the poisoned window
               RAFT_TPU_SERVE_LADDER="pow2",
               RAFT_TPU_AOT="load", RAFT_TPU_AOT_DIR=bank)
    for drop in ("RAFT_TPU_LOG", "RAFT_TPU_FAULTS", "RAFT_TPU_AOT_MISS",
                 "RAFT_TPU_COMPILE_BUDGET", "RAFT_TPU_RUNS_DIR"):
        env.pop(drop, None)
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.aot", "warmup", "--kinds",
         "serve", "--design", SPAR, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rel_a = _cut_release(env, promote=True)
    return {"bank": bank, "env": env, "A": rel_a}


def _cut_release(env, promote=False, label=None):
    argv = [sys.executable, "-m", "raft_tpu_torch.aot", "release", "cut"]
    if promote:
        argv.append("--promote")
    if label:
        argv += ["--label", label]
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # "release <id> cut: N entries, parent X (<dir>)"
    return proc.stdout.split("release ", 1)[1].split()[0]


def _drill_env(warm, logdir, max_batch="2", extra=None):
    env = dict(os.environ,
               PYTHONPATH=ROOT,
               RAFT_TPU_SERVE_TICK_MS="10",
               RAFT_TPU_SERVE_LADDER="pow2",
               RAFT_TPU_SERVE_MAX_BATCH=max_batch,
               RAFT_TPU_SERVE_DRAIN_S="20",
               RAFT_TPU_FLEET_TTL_S="3",
               RAFT_TPU_AOT="require",
               RAFT_TPU_COMPILE_BUDGET="0",
               RAFT_TPU_AOT_DIR=warm["bank"],
               RAFT_TPU_CANARY_S="0.5",
               RAFT_TPU_LOG=str(logdir) + os.sep)
    for drop in ("RAFT_TPU_FAULTS", "RAFT_TPU_RUNS_DIR"):
        env.pop(drop, None)
    env.update(extra or {})
    return env


def _spawn_replica(root, rid, env, out_path):
    with open(out_path, "ab") as logf:
        return subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.serve",
             "--designs", f"spar={SPAR}", "--port", "0",
             "--fleet-dir", str(root), "--replica-id", rid,
             "--device", "cpu"],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)


def _wait_live(root, rids, deadline_s=300):
    from raft_tpu_torch.serve.fleet import FleetLedger

    ledger = FleetLedger(str(root))
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        live = ledger.live()
        if set(rids) <= set(live):
            return live
        time.sleep(0.3)
    raise AssertionError(f"replicas {rids} never joined: "
                         f"{sorted(ledger.live())}")


def _spawn_router(root, env, extra=None):
    renv = dict(env)
    renv.update({"RAFT_TPU_ROUTER_PROBE_S": "0.4",
                 "RAFT_TPU_ROUTER_RETRIES": "5",
                 "RAFT_TPU_ROUTER_BACKOFF_MS": "25",
                 "RAFT_TPU_ROUTER_BACKOFF_CAP_MS": "400",
                 "RAFT_TPU_ROUTER_TIMEOUT_S": "120"})
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


def _stop_pid(pid, deadline_s=60):
    """SIGTERM a (possibly non-child) process and wait for it to
    vanish — rollout candidates are the DRIVER's children, not ours."""
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        return True
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.3)
    return False


def _parse_record(stdout):
    """The rollout CLI prints the record as indented JSON followed by
    the one-line summary — raw_decode eats exactly the JSON."""
    return json.JSONDecoder().raw_decode(stdout)[0]


def _read_events(logdir):
    events = []
    for name in os.listdir(logdir):
        if name.endswith(".jsonl"):
            with open(os.path.join(logdir, name)) as f:
                for line in f:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        pass
    return events


def _replica_release(port, timeout=60):
    """One direct probe at a replica endpoint; the release id its
    provenance stamp carries."""
    from raft_tpu_torch.serve.client import ServeClient

    c = ServeClient("127.0.0.1", port, timeout=timeout)
    try:
        code, _ = c.evaluate("spar", 5.0, 10.0, 0.0)
        assert code in (200, 422), code
        return (c.last_provenance or {}).get("release")
    finally:
        c.close()


@pytest.mark.slow
def test_rolling_upgrade_and_automatic_rollback_drill(release_bank,
                                                      tmp_path):
    """THE release acceptance drill, one fleet end to end:

    1. 2 replicas on release A (ladder max 2) + router + canary +
       alert engine, steady load green;
    2. warm ladder B (max batch 4 — ONE new program), cut release B,
       roll A -> B under continuous load: zero dropped/5xx responses,
       both replicas replaced in place (<= N ring updates, no evict),
       the fleet's provenance converges on B, the driver + replicas
       merge onto one trace with 0 orphan spans;
    3. cut release C whose captured env arms provenance_skew (the
       deterministic stale-candidate stand-in), roll B -> C: the
       canary goes RED on the skewed candidate, the rollout rolls
       back to B automatically, the fleet converges on B, the run
       record names the aborted C sha, and canary-parity fired only
       during the bad window."""
    from raft_tpu_torch.aot import release as release_mod
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.fleet import FleetLedger

    warm = release_bank
    rel_a = warm["A"]
    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    runs_dir = tmp_path / "runs"
    alert_sink = tmp_path / "alerts.jsonl"
    # the alert pack trimmed to the canary rules: a draining old owner
    # mid-takeover may legitimately bounce a breaker, and this drill's
    # contract is "the CANARY gates the rollout" — the default pack's
    # breaker rules have their own drill in test_router
    rules_path = tmp_path / "rules.json"
    rules_path.write_text(json.dumps({"rules": [
        {"name": n, "disabled": True}
        for n in ("slo-breach", "breaker-storm", "lease-churn",
                  "cache-hit-collapse", "compile-budget-burn")]}))

    env_a = _drill_env(warm, logdir, max_batch="2")
    results, errors = [], []
    stop_load = threading.Event()

    def loader(i, port):
        cl = ServeClient("127.0.0.1", port, client_id=f"load-{i}",
                         timeout=300)
        j = 0
        try:
            while not stop_load.is_set():
                code, _ = cl.evaluate("spar", 4.0 + 0.01 * ((i + j) % 40),
                                      9.0 + 0.01 * (j % 30), 0.0)
                results.append(code)
                j += 1
                time.sleep(0.05)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append((i, repr(e)))
        finally:
            cl.close()

    procs = {}
    loaders = []
    try:
        procs["r0"] = _spawn_replica(root, "r0", env_a,
                                     tmp_path / "r0.out")
        procs["r1"] = _spawn_replica(root, "r1", env_a,
                                     tmp_path / "r1.out")
        _wait_live(root, {"r0", "r1"})
        router_proc, port = _spawn_router(
            root, env_a,
            extra={"RAFT_TPU_ALERT_EVAL_S": "0.25",
                   "RAFT_TPU_ALERT_RULES": str(rules_path),
                   "RAFT_TPU_ALERTS": str(alert_sink)})
        procs["router"] = router_proc
        leases0 = FleetLedger(str(root)).live()
        assert all(_replica_release(leases0[r]["port"]) == rel_a
                   for r in ("r0", "r1"))

        # ---- phase 2: warm ladder B, cut B, roll the live fleet
        warm_b_env = dict(warm["env"], RAFT_TPU_SERVE_MAX_BATCH="4",
                          RAFT_TPU_AOT="load")
        proc = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.aot", "warmup",
             "--kinds", "serve", "--design", SPAR, "--device", "cpu"],
            cwd=ROOT, env=warm_b_env, capture_output=True, text=True,
            timeout=900)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
        rel_b = _cut_release(warm_b_env, label="ladder max-batch 4")
        assert rel_b != rel_a

        for i in range(4):
            t = threading.Thread(target=loader, args=(i, port))
            t.start()
            loaders.append(t)
        time.sleep(2.0)  # steady load before the rollout

        driver_env = dict(env_a,
                          RAFT_TPU_RUNS_DIR=str(runs_dir),
                          RAFT_TPU_ROLLOUT_CANARY_PROBES="2",
                          RAFT_TPU_ROLLOUT_POLL_S="0.3",
                          RAFT_TPU_ROLLOUT_HEALTH_TIMEOUT_S="300")
        drv = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.serve", "rollout",
             "--fleet-dir", str(root), "--to", rel_b,
             "--designs", f"spar={SPAR}", "--device", "cpu",
             "--router-url", f"http://127.0.0.1:{port}"],
            cwd=ROOT, env=driver_env, capture_output=True, text=True,
            timeout=900)
        assert drv.returncode == 0, drv.stdout + drv.stderr
        record = _parse_record(drv.stdout)
        assert record["ok"] and record["replaced"] == ["r0", "r1"]
        assert not record["rolled_back"]
        assert release_mod.current_release(warm["bank"]) == rel_b

        # both replicas were replaced IN PLACE: same rids, new pids,
        # zero compiles (ladder 1,2,4 all banked), provenance all B
        leases_b = _wait_live(root, {"r0", "r1"})
        assert {leases_b[r]["pid"] for r in leases_b} \
            != {leases0[r]["pid"] for r in leases0}
        for rid in ("r0", "r1"):
            hc = ServeClient("127.0.0.1", leases_b[rid]["port"],
                             timeout=60)
            code, health = hc.healthz()
            hc.close()
            assert code == 200
            assert not health["kernel"]["built_here"]
            assert health["aot"]["builds"] == 0
            assert health["aot_programs_compiled"] == 0
            assert _replica_release(leases_b[rid]["port"]) == rel_b

        # ---- phase 3: a poisoned candidate C rolls itself back.
        # C shares B's bank view (parent=B differentiates the id); its
        # captured env additionally arms the provenance-skew fault —
        # the deterministic stand-in for a stale-banked candidate.
        # env is signed but NOT part of the content address, so the
        # manifest still verifies: exactly the "bad release ships a
        # bad environment" hole the canary gate exists to catch.
        rel_c = _cut_release(dict(warm_b_env), label="poisoned")
        assert rel_c not in (rel_a, rel_b)
        man_path = release_mod.manifest_path(rel_c, warm["bank"])
        man = json.loads(open(man_path, encoding="utf-8").read())
        man["env"]["RAFT_TPU_FAULTS"] = \
            "provenance_skew:serve_provenance"
        sys.path.insert(0, ROOT)
        from raft_tpu_torch.aot.release import sign_manifest

        with open(man_path, "w", encoding="utf-8") as f:
            json.dump(sign_manifest(man), f)
        t_bad = time.time()
        drv2 = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.serve", "rollout",
             "--fleet-dir", str(root), "--to", rel_c,
             "--designs", f"spar={SPAR}", "--device", "cpu",
             "--router-url", f"http://127.0.0.1:{port}"],
            cwd=ROOT, env=driver_env, capture_output=True, text=True,
            timeout=900)
        assert drv2.returncode == 1, drv2.stdout + drv2.stderr
        record2 = _parse_record(drv2.stdout)
        assert record2["rolled_back"] and not record2["ok"]
        assert record2["aborted"] == rel_c       # the postmortem sha
        # the parity split reaches the verdict through whichever gate
        # reads it first: the canary_fail counter (a parity-split probe
        # counts as a fail), the parity gauge, or the fired alert
        assert record2["reason"] in ("canary-fail", "canary-parity",
                                     "alert:canary-parity",
                                     "alert:canary-failure"), record2
        # automatic convergence back on B: pointer, leases, provenance
        assert release_mod.current_release(warm["bank"]) == rel_b
        leases_c = _wait_live(root, {"r0", "r1"})
        for rid in ("r0", "r1"):
            assert _replica_release(leases_c[rid]["port"]) == rel_b

        stop_load.set()
        for t in loaders:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in loaders)
        # ZERO dropped requests across BOTH rollouts: every response
        # resolved 200/422, never a 5xx and never a raised socket error
        assert not errors, errors
        assert results and all(c in (200, 422) for c in results), \
            sorted({c for c in results if c not in (200, 422)})

        # ---- teardown: drain the final fleet (driver-spawned pids are
        # not our children), stop the router
        for rid in ("r0", "r1"):
            assert _stop_pid(leases_c[rid]["pid"])
        router_proc.send_signal(signal.SIGTERM)
        assert router_proc.wait(timeout=60) == 0
    finally:
        stop_load.set()
        for rid, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        for rec in FleetLedger(str(root)).live().values():
            _stop_pid(rec.get("pid") or 0, deadline_s=10)

    # ---- event-stream assertions
    events = _read_events(logdir)
    names = [e.get("event") for e in events]
    # surf replacement, not churn: every takeover is ONE same-rid ring
    # update (<= N per rollout), and the seize path never evicted
    ring_updates = [e for e in events
                    if e.get("event") == "router_ring_update"]
    replaced_updates = [e for e in ring_updates if e.get("replaced")]
    # A->B replaced r0+r1; B->C replaced r0, rollback re-replaced r0
    assert len(replaced_updates) == 4, replaced_updates
    assert all(len(e["replaced"]) == 1 for e in replaced_updates)
    assert names.count("replica_takeover") == 4
    assert names.count("replica_evict") == 0
    assert names.count("rollout_start") == 2
    assert names.count("rollout_rollback") == 1
    aborted = [e for e in events if e.get("event") == "rollout_rollback"]
    assert aborted[0]["aborted"] == rel_c
    assert names.count("release_promote") >= 3   # A->B, B->C, C->B
    # the replicas resolved their release at startup
    assert names.count("release_resolve") >= 4

    # ---- the run records name both rollouts
    runs = []
    for name in os.listdir(runs_dir):
        with open(runs_dir / name, encoding="utf-8") as f:
            runs.append(json.load(f))
    rollouts = {r["label"]: r for r in runs if r.get("kind") == "rollout"}
    assert rollouts[rel_b]["extra"]["ok"] is True
    assert rollouts[rel_c]["extra"]["aborted"] == rel_c

    # ---- the canary alert fired during, and only during, the bad
    # window (phase 1/2 steady+rollout state must be alert-free)
    from raft_tpu_torch.obs.alerts import read_sink

    records, bad = read_sink(str(alert_sink))
    assert bad == 0
    fires = [r for r in records if r["kind"] == "fire"]
    assert fires, "the poisoned candidate never tripped an alert"
    # the skew trips BOTH canary rules (a parity-split probe also
    # counts against the golden-failure counter) and nothing else;
    # canary-parity — the version-aware rule — must be among them
    assert {r["rule"] for r in fires} <= {"canary-parity",
                                          "canary-failure"}, fires
    assert "canary-parity" in {r["rule"] for r in fires}, fires
    assert min(r["t_unix"] for r in fires) >= t_bad - 0.5, \
        ("an alert fired before the poisoned rollout", t_bad, fires)

    # ---- one merged timeline: the rollout driver's span tree adopts
    # every spawned replica via traceparent propagation — 0 orphans,
    # every span balanced (all processes exited cleanly)
    merged = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs", "trace", "--merge",
         str(logdir), "-o", str(tmp_path / "merged.json"), "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert merged.returncode == 0, merged.stdout + merged.stderr
    meta = json.loads((tmp_path / "merged.json").read_text())["otherData"]
    assert meta["spans_orphaned"] == 0, meta
    rollout_spans = [e for e in events if e.get("event") == "span_begin"
                     and e.get("name") == "rollout"]
    assert len(rollout_spans) == 2


@pytest.mark.slow
def test_stale_bank_fails_fast_with_diagnosis(release_bank, tmp_path):
    """Fail fast on stale banks: a require-mode replica whose ladder
    outgrew the bank must exit 3 naming the unwarmed programs, the
    mismatch class, and the exact warmup command — and `release
    verify --against-designs` gives the same diagnosis standalone."""
    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    # ladder max 8: rows=8 was never warmed under release A/B
    env = _drill_env(release_bank, logdir, max_batch="8")
    out = tmp_path / "stale.out"
    proc = _spawn_replica(root, "rX", env, out)
    rc = proc.wait(timeout=600)
    assert rc == 3, (rc, out.read_text()[-2000:])
    text = out.read_text()
    assert "UNWARMED" in text
    assert "why [ladder]" in text or "why [avals]" in text
    assert "python -m raft_tpu_torch.aot warmup --kinds serve" in text
    assert "release cut --promote" in text
    # no half-joined lease left behind
    from raft_tpu_torch.serve.fleet import FleetLedger

    assert "rX" not in FleetLedger(str(root)).replicas()
    # the standalone preflight agrees, exit 1
    verify = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.aot", "release", "verify",
         "--against-designs", f"spar={SPAR}", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert verify.returncode == 1, verify.stdout + verify.stderr
    assert "UNWARMED" in verify.stderr


@pytest.mark.slow
def test_autoscaler_actuators_against_real_fleet(release_bank, tmp_path):
    """The autoscaler's REAL actuators (policy hysteresis is unit-
    tested in test_autoscale): a scripted hot signal spawns a replica
    that joins from the warm bank with zero compiles; a scripted cold
    signal drains the newest joiner back out.  On this 1-core host
    this proves the control loop, not a throughput win."""
    from raft_tpu_torch.serve.autoscale import Autoscaler, FleetBackend
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.fleet import FleetLedger

    logdir = tmp_path / "logs"
    logdir.mkdir()
    root = tmp_path / "deploy"
    env = _drill_env(release_bank, logdir, max_batch="2")
    procs = {}
    try:
        procs["r0"] = _spawn_replica(root, "r0", env,
                                     tmp_path / "r0.out")
        _wait_live(root, {"r0"})

        class ScriptedBackend(FleetBackend):
            press_now = 0.0
            occ_now = 1.0

            def pressure(self):
                return self.press_now

            def occupancy(self):
                return self.occ_now

        # the spawned replica must inherit the fleet env (bank, ladder,
        # require-mode) — the backend spawn path merges os.environ
        old_env = dict(os.environ)
        os.environ.update({k: v for k, v in env.items()
                           if k.startswith("RAFT_TPU_")})
        try:
            backend = ScriptedBackend(str(root), [f"spar={SPAR}"],
                                      device="cpu")
            clock = [0.0]
            scaler = Autoscaler(backend=backend, clock=lambda: clock[0],
                                interval_s=1.0, minimum=1, maximum=2,
                                cooldown_s=0.0)
            monkey_env = {"RAFT_TPU_AUTOSCALE_OUT_FOR_S": "1",
                          "RAFT_TPU_AUTOSCALE_IN_FOR_S": "1"}
            # rebuild the private engine under short windows
            os.environ.update(monkey_env)
            from raft_tpu_torch.obs.alerts import AlertEngine
            from raft_tpu_torch.serve.autoscale import scaling_rules

            scaler.engine = AlertEngine(rules=scaling_rules(),
                                        sink_path=None,
                                        clock=lambda: clock[0])
            # scale OUT on sustained pressure
            ScriptedBackend.press_now = 1.0
            clock[0] = 0.0
            assert scaler.step(now=0.0) is None
            clock[0] = 1.5
            act = scaler.step(now=1.5)
            assert act is not None and act[0] == "out"
            new_rid = act[1]
            live = _wait_live(root, {"r0", new_rid})
            hc = ServeClient("127.0.0.1", live[new_rid]["port"],
                             timeout=60)
            code, health = hc.healthz()
            hc.close()
            assert code == 200
            assert not health["kernel"]["built_here"]
            assert health["aot"]["builds"] == 0
            assert health["aot_programs_compiled"] == 0
            # scale IN on sustained low occupancy: the NEWEST joiner
            # (the autoscaler's own spawn) drains first
            ScriptedBackend.press_now = 0.0
            ScriptedBackend.occ_now = 0.0
            clock[0] = 10.0
            assert scaler.step(now=10.0) is None
            clock[0] = 11.5
            act = scaler.step(now=11.5)
            assert act == ("in", new_rid)
            t0 = time.monotonic()
            while time.monotonic() - t0 < 120:
                if sorted(FleetLedger(str(root)).live()) == ["r0"]:
                    break
                time.sleep(0.3)
            assert sorted(FleetLedger(str(root)).live()) == ["r0"]
            for p in backend._procs:
                assert p.wait(timeout=60) == 0  # drained clean exit
        finally:
            os.environ.clear()
            os.environ.update(old_env)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()

    events = _read_events(logdir)
    names = [e.get("event") for e in events]
    assert names.count("autoscale_out") == 1
    assert names.count("autoscale_in") == 1


# ------------------------------------------------- equal to the reference


def _seeded_alerts_payloads(n, seed):
    """``n`` /alerts payload snapshots from a numpy seed: missing and
    present canaries, fail and pass counts, parity flags, probe runs at
    old and new endpoints, active alerts."""
    rng = np.random.default_rng(seed)
    eps = ["127.0.0.1:1000", "127.0.0.1:2000", "127.0.0.1:2001"]
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None if rng.random() < 0.5 else {"canary": None})
            continue
        probes = {f"r{i}": {"endpoint": str(rng.choice(eps)),
                            "n": int(rng.integers(0, 5))}
                  for i in range(int(rng.integers(0, 3)))}
        can = {"passes": int(rng.integers(0, 30)),
               "fails": int(rng.integers(0, 3)) * int(rng.random() < 0.3),
               "parity_ok": bool(rng.random() < 0.85), "probes": probes}
        active = ([{"rule": str(rng.choice(["slo-breach",
                                            "canary-parity"]))}]
                  if rng.random() < 0.15 else [])
        out.append({"canary": can, "active": active})
    return out


@pytest.mark.parametrize("seed", range(3))
def test_gate_decision_equals_the_references(seed):
    from raft_tpu.serve import rollout as jr
    from raft_tpu_torch.serve import rollout as tr

    rng = np.random.default_rng(1000 + seed)
    for payload in _seeded_alerts_payloads(300, seed):
        base = {"passes": int(rng.integers(0, 20)), "fails": 0}
        need = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            kw = {"replica": f"r{int(rng.integers(3))}",
                  "endpoint": str(rng.choice(["127.0.0.1:2000",
                                              "127.0.0.1:1000"]))}
        else:
            kw = {}
        assert tr.gate_decision(payload, base, need, **kw) == \
            jr.gate_decision(payload, base, need, **kw)


@pytest.mark.parametrize("seed", range(3))
def test_rollout_records_equal_the_references(seed):
    from raft_tpu.serve import rollout as jr
    from raft_tpu_torch.serve import rollout as tr

    rng = np.random.default_rng(seed)
    for _ in range(50):
        ok = bool(rng.random() < 0.6)
        steps = [{"replica": f"r{i}", "phase": "upgrade",
                  "ok": bool(rng.random() < 0.8), "reason": "x",
                  "wall_s": float(rng.uniform(0, 30))}
                 for i in range(int(rng.integers(0, 4)))]
        args = (f"{int(rng.integers(16 ** 12)):012x}",
                (f"{int(rng.integers(16 ** 12)):012x}"
                 if rng.random() < 0.8 else None),
                ok, [s["replica"] for s in steps], not ok,
                None if ok else str(rng.choice(["canary-fail",
                                                "join-timeout"])),
                steps, float(rng.uniform(0, 300)))
        rec = tr.build_record(*args)
        assert rec == jr.build_record(*args)
        assert tr.summarize_record(rec) == jr.summarize_record(rec)

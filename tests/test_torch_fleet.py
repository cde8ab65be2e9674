"""The port's serving fleet end to end (``raft_tpu_torch/serve/{fleet,
router}.py`` and the replica join of ``python -m raft_tpu_torch.serve``):

* two real CPU replica processes (``--device cpu``, the spar demo,
  ladder 1) behind an in-process router: 12 routed requests, every
  answer within 1e-10 x max of the JAX serving engine's
  ``golden_serve_spar.npz`` with ``status`` equal; a ``replica_kill``
  armed on one replica through ``RAFT_TPU_FLEET_FAULT_REPLICA`` drops
  no request (the router fails it over), the dead lease expires and is
  evicted; the replicas serve with a ``jax`` package that raises on
  import first on their ``PYTHONPATH``;
* (the same on the card, two replicas on ``cuda:0`` with answers
  bit-equal to each other, is ``tests/test_torch_cuda.py::
  test_two_replicas_on_card_behind_a_router_are_bit_equal``);
* the 26 fleet flags (``CANARY_*``, ``FLEET_*``, ``ROUTER_*``,
  ``ROLLOUT_*``, ``AUTOSCALE_*``) under the JAX registry's names, kinds,
  choices and defaults;
* ``spawn_replica``'s fault forwarding and device pinning, the
  ``fleet --status`` CLI, the ``RAFT_TPU_*`` environment guard the
  port's in-process fleet tests use;
* ``test_fleet_trace_merge_e2e`` (slow), the reference's
  ``tests/test_obs.py`` drill: a two-worker fabric sweep plus one
  served request merge into one trace with no orphan span.
"""

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

from _torch_env_guard import env_diff, raft_env, raft_env_unchanged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "torch_port")
SPAR = os.path.join(FIX, "design_spar.json")

FLEET_FLAGS = (
    "CANARY_S", "CANARY_OUT_KEYS", "CANARY_RTOL", "CANARY_ATOL",
    "FLEET_DIR", "FLEET_TTL_S", "FLEET_FAULT_REPLICA",
    "ROUTER_PROBE_S", "ROUTER_VNODES", "ROUTER_RETRIES",
    "ROUTER_BACKOFF_MS", "ROUTER_BACKOFF_CAP_MS", "ROUTER_TIMEOUT_S",
    "ROUTER_BREAKER_FAILS", "ROUTER_BREAKER_COOLDOWN_S", "ROUTER_HEDGE_MS",
    "ROLLOUT_HEALTH_TIMEOUT_S", "ROLLOUT_CANARY_PROBES", "ROLLOUT_POLL_S",
    "AUTOSCALE_EVAL_S", "AUTOSCALE_MIN", "AUTOSCALE_MAX",
    "AUTOSCALE_OUT_FOR_S", "AUTOSCALE_IN_FOR_S", "AUTOSCALE_COOLDOWN_S",
    "AUTOSCALE_LOW_OCC")


@pytest.fixture(autouse=True)
def _raft_env_guard():
    """Fail a test that leaves a RAFT_TPU_* variable behind (replicas
    and routers are built from this process)."""
    with raft_env_unchanged():
        yield


# ------------------------------------------------------------ flags


@pytest.mark.parametrize("name", FLEET_FLAGS)
def test_fleet_flags_mirror_the_jax_registry(monkeypatch, name):
    """Every fleet flag of the reference, under the same name, kind,
    choices and default."""
    from raft_tpu.utils import config as jcfg
    from raft_tpu_torch.utils import config as tcfg

    monkeypatch.delenv("RAFT_TPU_" + name, raising=False)
    assert tcfg.FLAGS[name].env == jcfg.FLAGS[name].env
    assert tcfg.FLAGS[name].kind == jcfg.FLAGS[name].kind
    assert tcfg.FLAGS[name].choices == jcfg.FLAGS[name].choices
    assert tcfg.get(name) == jcfg.get(name)
    assert {f for f in jcfg.FLAGS if f.startswith(
        ("CANARY_", "FLEET_", "ROUTER_", "ROLLOUT_", "AUTOSCALE_"))} \
        == set(FLEET_FLAGS)


# ------------------------------------------------------------ the guard


def test_env_guard_fails_a_leaking_block():
    """The guard fails a block that leaves a RAFT_TPU_* variable set,
    changed or removed, and passes one that restores what it found."""
    name = "RAFT_TPU_ENV_GUARD_PROBE"
    assert name not in os.environ
    try:
        with pytest.raises(pytest.fail.Exception, match=name):
            with raft_env_unchanged():
                os.environ[name] = "leak"
        before = raft_env()
        with pytest.raises(pytest.fail.Exception, match=name):
            with raft_env_unchanged():
                os.environ[name] = "changed"
        assert env_diff(before, raft_env()) == {name: ("leak", "changed")}
        with raft_env_unchanged():
            os.environ[name] = "x"
            os.environ[name] = "changed"
        with pytest.raises(pytest.fail.Exception, match=name):
            with raft_env_unchanged():
                del os.environ[name]
    finally:
        os.environ.pop(name, None)


# ------------------------------------------------- spawn and the ledger


def test_strip_replica_faults_and_device_pinning(monkeypatch):
    from raft_tpu_torch.serve import fleet

    spec = "replica_kill:serve_evaluate:1,transient:shard_eval:2"
    monkeypatch.setenv("RAFT_TPU_FLEET_FAULT_REPLICA", "1")
    env = fleet._strip_replica_faults({"RAFT_TPU_FAULTS": spec}, 0)
    assert env["RAFT_TPU_FAULTS"] == "transient:shard_eval:2"
    env = fleet._strip_replica_faults({"RAFT_TPU_FAULTS": spec}, 1)
    assert env["RAFT_TPU_FAULTS"] == spec
    # several visible cards: replica i of n is pinned as fabric worker i
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    from raft_tpu_torch.parallel import fabric

    assert fabric._worker_device_env(1, 2) == {"CUDA_VISIBLE_DEVICES":
                                               "1,3"}
    assert fleet.design_paths(["a=x.json,b=y.json", "z.json"]) == \
        ["x.json", "y.json", "z.json"]


def test_fleet_status_cli(tmp_path, monkeypatch, capsys):
    from raft_tpu_torch.serve import fleet
    from raft_tpu_torch.serve.__main__ import main

    monkeypatch.setenv("RAFT_TPU_FLEET_TTL_S", "30")
    assert fleet.FleetLedger(str(tmp_path), replica_id="r0").claim(
        9000, designs={"spar": {"sig": "s", "fingerprint": "f"}})
    assert main(["fleet", "--status", "--fleet-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_live"] == 1 and out["replicas"]["r0"]["port"] == 9000
    # RAFT_TPU_FLEET_DIR stands in for --fleet-dir
    monkeypatch.setenv("RAFT_TPU_FLEET_DIR", str(tmp_path))
    assert main(["fleet", "--status"]) == 0
    assert json.loads(capsys.readouterr().out)["n_live"] == 1


# ------------------------------------------------------- end to end


def _start_router(root):
    """An in-process Router on a loopback port, its event loop in a
    thread; returns (router, thread, loop)."""
    from raft_tpu_torch.serve.router import Router

    box, up = {}, threading.Event()
    loop = asyncio.new_event_loop()

    def serve():
        asyncio.set_event_loop(loop)

        async def run():
            box["router"] = await Router(root, port=0).start()
            up.set()
            await box["router"].serve_until_stopped()

        try:
            loop.run_until_complete(run())
        except BaseException as e:  # noqa: BLE001 — reported below
            box["error"] = e
            up.set()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert up.wait(60) and "router" in box, box.get("error")
    return box["router"], th, loop


def _stop_router(router, th, loop):
    loop.call_soon_threadsafe(router._stop.set)
    th.join(timeout=60)
    assert not th.is_alive()


def _victim_id(survivor, key, prefix):
    """A replica id that owns ``key`` on a ring of {survivor, id}."""
    from raft_tpu_torch.serve.router import HashRing

    for i in range(256):
        ring = HashRing()
        ring.add(survivor)
        ring.add(f"{prefix}{i}")
        if ring.owners(key)[0] == f"{prefix}{i}":
            return f"{prefix}{i}"
    raise AssertionError("no replica id owns the key")


def _spar_key():
    from raft_tpu_torch.serve import engine
    from raft_tpu_torch.serve.router import routing_key
    from raft_tpu_torch.structure.bucketing import signature_fingerprint

    e = engine.Registry().register("spar", SPAR)
    return routing_key({"design": "spar"}, {"spar": {
        "sig": signature_fingerprint(e.sig), "fingerprint": e.fingerprint}})


def _wait_live(root, rids, procs, deadline_s):
    from raft_tpu_torch.serve.fleet import FleetLedger

    ledger = FleetLedger(str(root))
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        live = ledger.live()
        if set(rids) <= set(live):
            return live
        for p, rid in procs:
            log = os.path.join(str(root), "_fleet", "replicas",
                               f"{rid}.log")
            assert p.poll() is None, open(log).read()[-3000:]
        time.sleep(0.1)
    raise AssertionError(f"replicas {rids} never joined")


def _golden_cases():
    g = np.load(os.path.join(FIX, "golden_serve_spar.npz"))
    rows = []
    for rung in (1, 4, 16):
        for i in range(len(g[f"r{rung}_Hs"])):
            rows.append({k: g[f"r{rung}_{k}"][i] for k in (
                "Hs", "Tp", "beta", "X0", "PSD", "status")})
    return rows


def test_two_cpu_replicas_behind_a_router_kill_one_zero_dropped(
        tmp_path, monkeypatch):
    """Two ``--device cpu`` replicas of the spar demo (ladder 1) behind an
    in-process router; the one armed with ``replica_kill`` (through
    ``RAFT_TPU_FLEET_FAULT_REPLICA``) owns the spar key, so the first
    routed request kills it mid-request: the router fails it over, all
    12 requests answer within 1e-10 x max of the JAX serving engine's
    goldens with ``status`` equal, the dead lease expires and is
    evicted.  The replicas run with a ``jax`` that raises on import."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.serve import fleet
    from raft_tpu_torch.serve.client import ServeClient

    t_start = time.monotonic()
    blocker = tmp_path / "blocker"
    (blocker / "jax").mkdir(parents=True)
    (blocker / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is blocked for the port')\n")
    blocked = subprocess.run(
        [sys.executable, "-c", "import jax"], capture_output=True,
        env=dict(os.environ, PYTHONPATH=str(blocker)), timeout=60)
    assert blocked.returncode != 0 and b"blocked" in blocked.stderr
    root = tmp_path / "deploy"
    env = {"PYTHONPATH": str(blocker),
           "RAFT_TPU_SERVE_LADDER": "1", "RAFT_TPU_SERVE_TICK_MS": "10",
           "RAFT_TPU_FLEET_TTL_S": "1.5", "RAFT_TPU_AOT": "off",
           "RAFT_TPU_FAULTS": "replica_kill:serve_evaluate:1",
           "OMP_NUM_THREADS": "2"}
    for drop in ("RAFT_TPU_LOG", "RAFT_TPU_RUNS_DIR", "RAFT_TPU_METRICS"):
        monkeypatch.delenv(drop, raising=False)
    monkeypatch.setenv("RAFT_TPU_FLEET_FAULT_REPLICA", "1")
    monkeypatch.setenv("RAFT_TPU_ROUTER_PROBE_S", "0.3")
    monkeypatch.setenv("RAFT_TPU_ROUTER_BACKOFF_MS", "10")
    monkeypatch.setenv("RAFT_TPU_ROUTER_BREAKER_FAILS", "1")
    spec = [f"spar={SPAR}"]
    procs = [fleet.spawn_replica(str(root), spec, index=0, replica_id="r0",
                                 env=env, device="cpu")]
    victim = _victim_id("r0", _spar_key(), "rk")
    procs.append(fleet.spawn_replica(str(root), spec, index=1,
                                     replica_id=victim, env=env,
                                     device="cpu"))
    router = None
    try:
        _wait_live(root, {"r0", victim}, procs, 120)
        router, th, loop = _start_router(str(root))
        assert router.state.snapshot()["n_replicas"] == 2
        assert router.state.ring_view()["spar"][0] == victim
        retries0 = metrics.counter("router_retries").value
        cases = _golden_cases()[:12]
        results, errors = [], []

        def client(i):
            c = ServeClient("127.0.0.1", router.port, client_id=f"c{i}",
                            timeout=120)
            try:
                for row in cases[i::3]:
                    code, body = c.evaluate("spar", float(row["Hs"]),
                                            float(row["Tp"]),
                                            float(row["beta"]))
                    results.append((row, code, body,
                                    c.last_headers.get("x-raft-replica")))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, errors
        assert len(results) == 12
        for row, code, body, rid in results:
            assert code == 200 and rid == "r0", (code, rid)
            assert body["status"] == int(row["status"])
            for k in ("X0", "PSD"):
                ref = row[k]
                err = np.max(np.abs(np.asarray(body["outputs"][k]) - ref))
                assert err <= 1e-10 * np.max(np.abs(ref)), k
        assert metrics.counter("router_retries").value - retries0 >= 1
        assert procs[1][0].wait(timeout=30) == -signal.SIGKILL
        # the dead lease expires (TTL 1.5 s) and the prober evicts it
        t0 = time.monotonic()
        while router.state.snapshot()["n_replicas"] != 1:
            assert time.monotonic() - t0 < 30
            time.sleep(0.1)
        assert victim not in fleet.FleetLedger(str(root)).replicas()
        _stop_router(router, th, loop)
        router = None
        procs[0][0].send_signal(signal.SIGTERM)
        assert procs[0][0].wait(timeout=60) == 0
        assert fleet.FleetLedger(str(root)).replicas() == {}
    finally:
        if router is not None:
            _stop_router(router, th, loop)
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert time.monotonic() - t_start <= 45.0


# ------------------------------------------------- merged trace (slow)


@pytest.mark.slow
def test_fleet_trace_merge_e2e(tmp_path, monkeypatch):
    """The acceptance drill of the reference's ``tests/test_obs.py``: a
    2-worker fabric sweep plus one served request, captured as
    per-process shards, merge into a SINGLE trace — the serve dispatch
    span resolves to its tick, both workers' shard spans resolve to the
    coordinator's sweep span, no orphan spans, one run_id."""
    from raft_tpu_torch.obs import report as obs_report
    from raft_tpu_torch.obs.spans import current_ids, span
    from raft_tpu_torch.parallel import fabric
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.engine import Registry

    capture = str(tmp_path / "capture") + os.sep
    monkeypatch.setenv("RAFT_TPU_LOG", capture)
    monkeypatch.setenv("RAFT_TPU_FABRIC_TTL_S", "2.0")
    monkeypatch.setenv("RAFT_TPU_FABRIC_POLL_S", "0.1")
    entry = os.path.join(ROOT, "tests", "_torch_fleet_entry.py")
    rng = np.random.default_rng(9)
    cases = dict(Hs=2.0 + 6.0 * rng.random(16), Tp=8.0 + 8.0 * rng.random(16))
    fabric.run_fabric(
        str(tmp_path / "fab"), workers=2, entry=f"{entry}:slow_toy_entry",
        entry_kwargs={"delay_s": 0.2}, cases=cases,
        out_keys=("PSD", "X0"), shard_size=4, device="cpu")

    # one served request through the batcher, client-traced: the
    # request span is open at submit (as the HTTP layer does), the tick
    # runs afterwards on its own root (as the dispatcher thread does)
    registry = Registry()
    registry.register("spar", SPAR)
    batcher = Batcher(registry, device="cpu", tick_ms=5, max_batch=2)
    with span("serve_request", endpoint="/evaluate") as req:
        fut = batcher.submit("spar", 6.0, 11.0, 0.125,
                             trace_ctx=current_ids())
    batcher.run_tick()
    fut.result(timeout=120)

    events, bad, info = obs_report.merge_captures([capture])
    assert bad == 0
    assert info["files"] == 3          # pytest process + 2 workers
    assert not info["unanchored_files"]
    assert len({e["run_id"] for e in events}) == 1
    trace = obs_report.chrome_trace(events, merged=True)
    meta = trace["otherData"]
    assert meta["pids"] == 3
    assert meta["spans_unmatched"] == 0
    assert meta["spans_orphaned"] == 0     # every parent id resolves
    spans, _ = obs_report.collect_spans(events)
    by_id = {s["span_id"]: s for s in spans}
    sweep = [s for s in spans if s["name"] == "sweep"][-1]
    shards = [s for s in spans if s["name"] == "shard"]
    assert {s["pid"] for s in shards} and all(
        s["pid"] != os.getpid() for s in shards)
    assert len({s["pid"] for s in shards}) == 2    # both workers spoke
    for s in shards:
        assert s["trace_id"] == sweep["trace_id"]
        assert by_id[s["parent_id"]] is sweep
    # the serve side: dispatch -> tick (tree), tick -> request (link)
    tick = [s for s in spans if s["name"] == "serve_tick"][-1]
    dispatch = [s for s in spans if s["name"] == "sweep_dispatch"
                and s["trace_id"] == tick["trace_id"]][-1]
    assert by_id[dispatch["parent_id"]] is tick
    assert {(lk["trace_id"], lk["span_id"])
            for lk in tick["attrs"]["links"]} == \
        {(req.trace_id, req.span_id)}

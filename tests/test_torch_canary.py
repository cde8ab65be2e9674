"""The port's golden-answer canary (``raft_tpu_torch/serve/canary.py``)
and its ``/alerts`` summaries, ported from the canary tests of
``tests/test_alerts.py`` (the ones the port's ``tests/test_torch_alerts.py``
left for the fleet) under the same names: golden capture and tolerance
comparison, the bit-exact status contract, the provenance split and its
alert context, pruning departed replicas, the sink reader, the router
canary's out_keys intersection and its probe pass.

Beyond the reference: ``CanaryState.compare``, ``observe`` and
``summary`` held against the JAX package's on the same seeded rows and
provenance stamps; a replica's ``capture_goldens`` on the CPU device,
its golden row bit-equal to a direct dispatch of the canary case and
reported at the server's ``GET /alerts``.

Socket-free: probes are injected functions and the server route is
called in-process.
"""

import json
import os

import numpy as np
import pytest

from _torch_env_guard import raft_env_unchanged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "torch_port")


@pytest.fixture(autouse=True)
def _raft_env_guard():
    """Fail a test that leaves a RAFT_TPU_* variable behind (router
    state and canaries are built in this process)."""
    with raft_env_unchanged():
        yield




def _mk_canary(rtol=1e-5, atol=1e-8):
    from raft_tpu_torch.serve.canary import CanaryState

    return CanaryState(rtol=rtol, atol=atol)


def _row(x0=(1.0, 2.0, 3.0), status=0):
    return {"X0": np.asarray(x0, dtype=float),
            "status": np.int32(status)}


def test_canary_golden_capture_and_tolerance_compare(monkeypatch):
    from raft_tpu_torch.obs import metrics

    metrics.reset()
    c = _mk_canary(rtol=1e-6, atol=1e-9)
    keys = ("X0", "status")
    row = _row()
    prov = {"bank_sha": "aa", "code": "cc", "flags": "ff", "replica": "rA"}
    v = c.observe("spar", "rA", "fp-spar", (4.0, 9.0, 0.0), keys,
                  row, row["status"], provenance=prov)
    assert v["ok"] and v["golden_created"] and v["reason"] == "golden"
    # bit-identical repeat from another replica (same provenance modulo
    # replica id): pass
    v = c.observe("spar", "rB", "fp-spar", (4.0, 9.0, 0.0), keys,
                  _row(), np.int32(0),
                  provenance={**prov, "replica": "rB"})
    assert v["ok"] and not v["golden_created"]
    # inside tolerance: pass; outside: fail with a named delta
    v = c.observe("spar", "rB", "fp-spar", (4.0, 9.0, 0.0), keys,
                  _row((1.0 + 1e-9, 2.0, 3.0)), 0,
                  provenance={**prov, "replica": "rB"})
    assert v["ok"]
    v = c.observe("spar", "rB", "fp-spar", (4.0, 9.0, 0.0), keys,
                  _row((1.1, 2.0, 3.0)), 0,
                  provenance={**prov, "replica": "rB"})
    assert not v["ok"] and "delta" in v["reason"]
    assert metrics.gauge("canary_parity_ok").value == 0.0
    assert metrics.counter("canary_fail").value == 1
    # a clean follow-up clears the failing key and parity recovers
    v = c.observe("spar", "rB", "fp-spar", (4.0, 9.0, 0.0), keys,
                  _row(), 0, provenance={**prov, "replica": "rB"})
    assert v["ok"] and metrics.gauge("canary_parity_ok").value == 1.0
    metrics.reset()


def test_canary_status_is_bit_exact():
    c = _mk_canary(rtol=1.0, atol=1.0)  # floats effectively ignored
    keys = ("X0", "status")
    c.observe("spar", "rA", "fp", (4.0, 9.0, 0.0), keys, _row(), 4)
    v = c.observe("spar", "rB", "fp", (4.0, 9.0, 0.0), keys, _row(), 6)
    assert not v["ok"] and "bit-exact" in v["reason"]
    # same bits pass even when SEVERE: determinism, not health, is the
    # canary's contract
    v = c.observe("spar", "rB", "fp", (4.0, 9.0, 0.0), keys, _row(), 4)
    assert v["ok"]


def test_canary_provenance_split_sets_context(monkeypatch):
    from raft_tpu_torch.obs import alerts, metrics

    metrics.reset()
    c = _mk_canary()
    keys = ("X0", "status")
    good = {"bank_key": "k1", "bank_sha": "aaaa", "code": "c1",
            "flags": "f1", "replica": "rA"}
    skew = {"bank_key": "skew-k1", "bank_sha": "skewaaaa", "code": "c1",
            "flags": "f1", "replica": "rB"}
    c.observe("spar", "rA", "fp", (4.0, 9.0, 0.0), keys, _row(), 0,
              provenance=good)
    v = c.observe("spar", "rB", "fp", (4.0, 9.0, 0.0), keys, _row(), 0,
                  provenance=skew)
    # numerically identical, yet the provenance split alarms — the
    # stale-bank/env-skew class health bits cannot see
    assert not v["ok"] and v["provenance_ok"] is False
    assert metrics.gauge("canary_parity_ok").value == 0.0
    ctx = alerts.get_context("canary_parity")
    assert ctx is not None
    splits = ctx["provenance"]["splits"]
    fields = {s["field"] for s in splits}
    assert {"bank_sha", "bank_key"} <= fields
    by_field = {s["field"]: s for s in splits}
    assert by_field["bank_sha"]["values"]["rB"] == "skewaaaa"
    # the canary-parity rule fires on the gauge and carries the context
    from raft_tpu_torch.obs.alerts import AlertEngine, flatten_snapshot

    eng = AlertEngine([r for r in alerts.default_rules()
                       if r.name == "canary-parity"],
                      clock=lambda: 100.0)
    t = eng.evaluate(flatten_snapshot(metrics.snapshot()))
    assert [x["kind"] for x in t] == ["fire"]
    assert t[0]["context"]["provenance"]["splits"]
    summary = c.summary()
    assert summary["parity_ok"] is False
    assert not summary["provenance"]["consistent"]
    alerts.set_context("canary_parity", None)
    metrics.reset()


def test_canary_prune_clears_departed_replica_ghost(monkeypatch):
    """A replaced replica's provenance stamp must not ghost-split
    parity forever: pruning to the current membership recovers the
    gauge and clears the alert context (the rolling-upgrade story)."""
    from raft_tpu_torch.obs import alerts, metrics

    metrics.reset()
    c = _mk_canary()
    keys = ("X0", "status")
    old = {"bank_key": "k", "bank_sha": "aaaa", "code": "OLD",
           "flags": "f", "replica": "rA"}
    new = {"bank_key": "k", "bank_sha": "aaaa", "code": "NEW",
           "flags": "f", "replica": "rC"}
    c.observe("spar", "rA", "fp", (4.0, 9.0, 0.0), keys, _row(), 0,
              provenance=old)
    v = c.observe("spar", "rC", "fp", (4.0, 9.0, 0.0), keys, _row(), 0,
                  provenance=new)
    assert not v["provenance_ok"]            # genuine split while both live
    assert metrics.gauge("canary_parity_ok").value == 0.0
    # rA drains and leaves the fleet: prune to the surviving membership
    assert c.prune({"rC"}) is True
    assert metrics.gauge("canary_parity_ok").value == 1.0
    assert alerts.get_context("canary_parity") is None
    assert c.summary()["parity_ok"] is True
    assert c.prune({"rC"}) is False          # idempotent no-op
    metrics.reset()


def test_read_sink_requires_kind(tmp_path):
    from raft_tpu_torch.obs.alerts import read_sink, render_sink_summary

    sink = tmp_path / "s.jsonl"
    sink.write_text(json.dumps({"rule": "x"}) + "\n"
                    + json.dumps({"kind": "fire", "rule": "y",
                                  "severity": "info", "metric": "m",
                                  "value": 1}) + "\n")
    records, bad = read_sink(str(sink))
    assert bad == 1 and [r["rule"] for r in records] == ["y"]
    assert len(render_sink_summary(records)) == 1  # no KeyError


def test_router_canary_probe_intersects_lease_out_keys(monkeypatch):
    """A replica whose lease declares a narrower served out_keys set
    is probed with the intersection (status-only at minimum) — a probe
    asking for an unserved key would 400 and the canary would be
    silently inert."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.serve.canary import RouterCanary
    from raft_tpu_torch.serve.router import RouterState

    metrics.reset()
    monkeypatch.setenv("RAFT_TPU_CANARY_S", "30")
    monkeypatch.delenv("RAFT_TPU_CANARY_OUT_KEYS", raising=False)
    state = RouterState(vnodes=8)
    state.apply_membership({
        "narrow": {"addr": "h", "port": 1, "out_keys": ["PSD", "status"],
                   "designs": {"spar": {"sig": "s", "fingerprint": "fp"}}},
        "legacy": {"addr": "h", "port": 2,   # pre-out_keys lease
                   "designs": {"spar": {"sig": "s", "fingerprint": "fp"}}},
    })
    assert state.served_out_keys("narrow") == ("PSD", "status")
    assert state.served_out_keys("legacy") == ()
    asked = {}

    def probe(addr, port, design, case, out_keys):
        asked[port] = out_keys
        return 200, {"ok": True, "status": 0,
                     "outputs": {"status": 0}}, None

    rc = RouterCanary(state, probe=probe)
    rc.probe_once()
    # narrow lease: X0 is unserved -> probe asks status only; the
    # legacy lease declares nothing -> configured default
    assert asked[1] == ("status",)
    assert asked[2] == ("X0", "status")
    metrics.reset()


def test_decode_outputs_complex_round_trip():
    from raft_tpu_torch.serve.canary import decode_outputs
    from raft_tpu_torch.serve.http import _json_value

    z = np.asarray([1.0 + 2.0j, -0.5 - 1.0j])
    x = np.asarray([1.5, 2.5])
    decoded = decode_outputs({"Z": _json_value(z), "X": _json_value(x)})
    np.testing.assert_array_equal(decoded["Z"], z)
    np.testing.assert_array_equal(decoded["X"], x)


def test_canary_out_keys_served_intersection(monkeypatch):
    from raft_tpu_torch.serve.canary import canary_out_keys

    monkeypatch.delenv("RAFT_TPU_CANARY_OUT_KEYS", raising=False)
    assert canary_out_keys() == ("X0", "status")
    assert canary_out_keys(served=("PSD", "status")) == ("status",)
    monkeypatch.setenv("RAFT_TPU_CANARY_OUT_KEYS", "PSD,X0")
    assert canary_out_keys(served=("PSD", "X0", "status")) \
        == ("PSD", "X0", "status")


def test_router_canary_probe_once_with_injected_probe(monkeypatch):
    """Socket-free router-canary pass: injected probe fn, RouterState
    membership — verdicts flow per (replica, design) and a skewed
    replica is named."""
    from raft_tpu_torch.obs import alerts, metrics
    from raft_tpu_torch.serve.canary import RouterCanary
    from raft_tpu_torch.serve.router import RouterState

    metrics.reset()
    monkeypatch.setenv("RAFT_TPU_CANARY_S", "30")
    state = RouterState(vnodes=8)
    state.apply_membership({
        "rA": {"addr": "127.0.0.1", "port": 1,
               "designs": {"spar": {"sig": "s", "fingerprint": "fp"}}},
        "rB": {"addr": "127.0.0.1", "port": 2,
               "designs": {"spar": {"sig": "s", "fingerprint": "fp"}}},
    })
    provs = {1: {"bank_sha": "aaaa", "bank_key": "k", "code": "c",
                 "flags": "f", "replica": "rA"},
             2: {"bank_sha": "bbbb", "bank_key": "skew-k", "code": "c",
                 "flags": "f", "replica": "rB"}}

    def probe(addr, port, design, case, out_keys):
        body = {"ok": True, "status": 0, "cache_hit": False,
                "outputs": {"X0": [1.0, 2.0], "status": 0}}
        return 200, body, provs[port]

    rc = RouterCanary(state, probe=probe)
    assert rc.daemon and rc.name == "raft-router-canary"
    verdicts = rc.probe_once()
    assert len(verdicts) == 2
    assert verdicts[0]["ok"]              # first probe mints the golden
    assert not verdicts[1]["provenance_ok"]
    assert metrics.counter("canary_fail").value == 1
    summary = rc.canary.summary()
    assert summary["goldens"] == 1 and not summary["parity_ok"]
    split_values = summary["provenance"]["splits"][0]["values"]
    assert set(split_values) == {"rA", "rB"}
    alerts.set_context("canary_parity", None)
    metrics.reset()


# ------------------------------------------------------ provenance codec


# ------------------------------------------------- equal to the reference


def _seeded_observations(n, seed):
    """``n`` canary observations from a numpy seed: two designs, three
    replicas, rows that match, drift inside and outside tolerance or
    flip status bits, and provenance stamps that agree or split."""
    rng = np.random.default_rng(seed)
    base = {"spar": rng.normal(size=6), "semi": rng.normal(size=6)}
    out = []
    for _ in range(n):
        design = str(rng.choice(["spar", "semi"]))
        rid = f"r{int(rng.integers(3))}"
        x0 = base[design].copy()
        u = rng.random()
        if u < 0.15:
            x0 = x0 * (1 + 1e-3)           # outside tolerance
        elif u < 0.3:
            x0 = x0 * (1 + 1e-9)           # inside
        status = int(rng.random() < 0.1) * 4
        prov = {"bank_key": "k", "bank_sha": "aaaa", "code": "c",
                "flags": "f", "replica": rid}
        if rng.random() < 0.1:
            prov["bank_sha"] = "bbbb"
        out.append((design, rid, f"fp-{design}", (4.0, 9.0, 0.0),
                    ("X0", "status"), {"X0": x0, "status": status},
                    status, prov, f"127.0.0.1:{1000 + int(rid[1])}"))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_canary_verdicts_equal_the_references(seed, monkeypatch):
    """The same seeded observations through both packages' CanaryState:
    the same verdicts (ok, reason, golden_created, provenance_ok, key),
    the same compare() answers and the same summaries (counters from
    each package's own registry), with a prune between halves."""
    from raft_tpu.obs import alerts as ja, metrics as jm
    from raft_tpu.serve.canary import CanaryState as JC
    from raft_tpu_torch.obs import alerts as ta, metrics as tm
    from raft_tpu_torch.serve.canary import CanaryState as TC

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", os.path.join(ROOT, "nope"))
    jm.reset()
    tm.reset()
    t, j = TC(rtol=1e-6, atol=1e-9), JC(rtol=1e-6, atol=1e-9)
    obs = _seeded_observations(120, seed)
    for i, (design, rid, fp, case, keys, row, status, prov, ep) in \
            enumerate(obs):
        vt = t.observe(design, rid, fp, case, keys, row, status,
                       provenance=prov, endpoint=ep)
        vj = j.observe(design, rid, fp, case, keys, row, status,
                       provenance=prov, endpoint=ep)
        assert vt == vj
        gold_t = next(iter(t._goldens.values()))
        gold_j = next(iter(j._goldens.values()))
        assert t.compare(gold_t, row, status) == \
            j.compare(gold_j, row, status)
        if i == len(obs) // 2:
            assert t.prune({"r0", "r1"}) == j.prune({"r0", "r1"})
    st, sj = t.summary(), j.summary()
    assert st == sj
    assert tm.counter("canary_fail").value == jm.counter("canary_fail").value
    ta.set_context("canary_parity", None)
    ja.set_context("canary_parity", None)
    jm.reset()
    tm.reset()


def test_replica_capture_goldens_and_alerts_summary(monkeypatch):
    """A replica's warm-up capture on the CPU: one dispatch per design at
    the canary case, the golden row bit-equal to a direct dispatch of
    the same row, and the server's ``GET /alerts`` reports the
    replica's golden store."""
    import asyncio

    from raft_tpu_torch.obs import alerts, metrics
    from raft_tpu_torch.serve import canary, engine
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.http import Server

    metrics.reset()
    monkeypatch.delenv("RAFT_TPU_CANARY_OUT_KEYS", raising=False)
    monkeypatch.setattr(canary, "_REPLICA_CANARY", [])
    registry = engine.Registry()
    registry.register("spar", os.path.join(FIX, "design_spar.json"))
    entries = [registry.get("spar")]
    state = canary.capture_goldens(entries, device="cpu")
    summ = state.summary()
    assert summ["goldens"] == 1 and summ["parity_ok"]
    (gold,) = state._goldens.values()
    assert gold["out_keys"] == ("X0", "status")
    direct = engine.dispatch(entries, [4.0], [9.0], [0.0], device="cpu",
                             padded=1, record_metrics=False)
    np.testing.assert_array_equal(gold["outputs"]["X0"], direct["X0"][0])
    assert gold["status"] == int(direct["status"][0])
    server = Server(Batcher(registry, device="cpu"))
    code, payload = asyncio.run(server._route("GET", "/alerts", b"",
                                              "c", {}))
    assert code == 200 and payload["canary"]["goldens"] == 1
    assert canary.replica_summary()["goldens"] == 1
    alerts.set_context("canary_parity", None)
    metrics.reset()

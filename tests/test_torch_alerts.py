"""The port's alert engine (``raft_tpu_torch.obs.alerts``), ported from
``tests/test_alerts.py`` less its golden-canary tests (those are in
``tests/test_torch_canary.py``): rule parsing, predicates,
for-duration and resolve hysteresis, rule-file loading, the default
pack, record replay (``alerts eval --record``), the provenance codec
and cross-replica consistency, and the obs-report alerts/provenance
sections.  The CLI verbs, the replay and the engine's transitions are
also held equal to the JAX package's on the same rule files, records
and metric views.

Socket-free and evaluator-free: the engine runs on an injected clock
and the CLI verbs are called in-process.
"""

import json
import os

import numpy as np
import pytest

from tests._obs_helpers import read_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "runs")


# ---------------------------------------------------------- rule parsing


def test_parse_rule_good_and_bad():
    from raft_tpu_torch.obs.alerts import parse_rule

    r = parse_rule({"name": "x", "metric": "counter:serve_errors",
                    "predicate": "rate_above", "threshold": 2,
                    "for_s": 1, "clear_s": 3, "severity": "critical",
                    "context": "canary_parity", "help": "h"})
    assert r.name == "x" and r.threshold == 2.0 and r.clear_s == 3.0
    assert r.context == "canary_parity"
    with pytest.raises(ValueError, match="name"):
        parse_rule({"metric": "counter:x", "predicate": "above"})
    with pytest.raises(ValueError, match="selector"):
        parse_rule({"name": "x", "metric": "serve_errors",
                    "predicate": "above"})
    with pytest.raises(ValueError, match="predicate"):
        parse_rule({"name": "x", "metric": "counter:x",
                    "predicate": "gte"})
    with pytest.raises(ValueError, match="severity"):
        parse_rule({"name": "x", "metric": "counter:x",
                    "predicate": "above", "severity": "page"})
    with pytest.raises(ValueError, match="for_s"):
        parse_rule({"name": "x", "metric": "counter:x",
                    "predicate": "above", "for_s": -1})
    with pytest.raises(ValueError, match="unknown field"):
        parse_rule({"name": "x", "metric": "counter:x",
                    "predicate": "above", "threshhold": 3})


def test_load_rules_json_yaml_override_disable(tmp_path):
    from raft_tpu_torch.obs.alerts import default_rules, load_rules

    names = {r.name for r in default_rules()}
    assert {"slo-breach", "breaker-storm", "lease-churn",
            "cache-hit-collapse", "compile-budget-burn",
            "canary-failure", "canary-parity"} == names
    # default pack when no file
    assert {r.name for r in load_rules(None)} == names
    # JSON: override one (same name replaces), add one, disable one
    jf = tmp_path / "rules.json"
    jf.write_text(json.dumps({"rules": [
        {"name": "slo-breach", "metric": "counter:serve_slo_breaches",
         "predicate": "rate_above", "threshold": 9.0},
        {"name": "my-rule", "metric": "hist:serve_request_s:p95",
         "predicate": "above", "threshold": 2.0},
        {"name": "lease-churn", "disabled": True},
    ]}))
    rules = {r.name: r for r in load_rules(str(jf))}
    assert rules["slo-breach"].threshold == 9.0
    assert "my-rule" in rules and "lease-churn" not in rules
    # YAML: default_pack false starts empty
    yf = tmp_path / "rules.yaml"
    yf.write_text("default_pack: false\n"
                  "rules:\n"
                  "  - name: only\n"
                  "    metric: gauge:router_replicas:value\n"
                  "    predicate: below\n"
                  "    threshold: 2\n")
    only = load_rules(str(yf))
    assert [r.name for r in only] == ["only"]
    # a bad file is a loud ValueError (the `alerts check` exit-1 path)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rules": [{"name": "x"}]}))
    with pytest.raises(ValueError):
        load_rules(str(bad))


def test_rate_rule_fires_on_mid_life_minted_counter():
    """Counters are created on their FIRST increment (breaker opens,
    evictions, canary failures) — a counter appearing after the
    engine's first pass must register as a rate from 0, not silently
    become the baseline; totals pre-existing the engine (warmup
    compiles) must baseline without firing."""
    from raft_tpu_torch.obs.alerts import Rule

    eng, _ = _engine([
        Rule("storm", "counter:router_breaker_opens", "rate_above",
             threshold=0.0, clear_s=0.0),
        Rule("burn", "counter:xla_real_compiles", "rate_above",
             threshold=0.0, clear_s=0.0)])
    # first pass: warmup compiles already at 5 — baseline, NO fire
    assert eng.evaluate({"counter:xla_real_compiles": 5.0}, now=0.0) == []
    # breaker counter minted mid-life (SIGKILL just landed): fires on
    # the very next pass — "within one eval interval"
    t = eng.evaluate({"counter:xla_real_compiles": 5.0,
                      "counter:router_breaker_opens": 1.0}, now=1.0)
    assert [(x["rule"], x["kind"]) for x in t] == [("storm", "fire")]
    # storm over: opens flat -> resolve
    t = eng.evaluate({"counter:xla_real_compiles": 5.0,
                      "counter:router_breaker_opens": 1.0}, now=2.0)
    assert [(x["rule"], x["kind"]) for x in t] == [("storm", "resolve")]


# ------------------------------------------------------------ predicates


def _engine(rules, sink=None):
    from raft_tpu_torch.obs.alerts import AlertEngine

    clock = [0.0]
    eng = AlertEngine(rules, sink_path=sink, clock=lambda: clock[0])
    return eng, clock


def test_predicates_above_below_rate_absent():
    from raft_tpu_torch.obs.alerts import Rule

    eng, _clock = _engine([
        Rule("a", "gauge:g:value", "above", threshold=5.0),
        Rule("b", "gauge:g:value", "below", threshold=1.0),
        Rule("r", "counter:c", "rate_above", threshold=2.0),
        Rule("m", "counter:gone", "absent"),
    ])
    # t=0: establishes the rate baseline; gauge mid-range; counter
    # present -> only the absence rule can fire (metric 'gone' missing)
    t1 = eng.evaluate({"gauge:g:value": 3.0, "counter:c": 0.0}, now=0.0)
    assert [t["rule"] for t in t1] == ["m"]
    # t=10: counter +30 in 10s = 3/s > 2 -> rate fires; gauge 6 > 5
    t2 = eng.evaluate({"gauge:g:value": 6.0, "counter:c": 30.0,
                       "counter:gone": 1.0}, now=10.0)
    assert sorted(t["rule"] for t in t2 if t["kind"] == "fire") \
        == ["a", "r"]
    assert [t["rule"] for t in t2 if t["kind"] == "resolve"] == ["m"]
    # t=20: counter flat -> rate 0 -> resolve; gauge 0.5 < 1 -> below
    t3 = eng.evaluate({"gauge:g:value": 0.5, "counter:c": 30.0},
                      now=20.0)
    kinds = {(t["rule"], t["kind"]) for t in t3}
    assert ("b", "fire") in kinds and ("r", "resolve") in kinds
    assert ("a", "resolve") in kinds
    # counter RESET (process restart): a drop must re-baseline, never
    # fire as a negative-or-huge rate
    t4 = eng.evaluate({"gauge:g:value": 0.5, "counter:c": 1.0}, now=30.0)
    assert not any(t["rule"] == "r" for t in t4)


def test_for_duration_and_resolve_hysteresis():
    from raft_tpu_torch.obs.alerts import Rule

    eng, _ = _engine([Rule("slow", "gauge:g:value", "above",
                           threshold=1.0, for_s=10.0, clear_s=5.0)])
    # condition true but younger than for_s: pending, no fire
    assert eng.evaluate({"gauge:g:value": 2.0}, now=0.0) == []
    assert eng.evaluate({"gauge:g:value": 2.0}, now=9.0) == []
    t = eng.evaluate({"gauge:g:value": 2.0}, now=10.0)
    assert [x["kind"] for x in t] == ["fire"]
    assert eng.active() and eng.active()[0]["rule"] == "slow"
    # a blip below the threshold RESETS the pending clock next time,
    # but a firing alert needs clear_s of clean before resolving
    assert eng.evaluate({"gauge:g:value": 0.0}, now=12.0) == []  # clean 0s
    # condition returns inside the clear window: still firing, no
    # re-fire event (hysteresis absorbs the flap)
    assert eng.evaluate({"gauge:g:value": 2.0}, now=14.0) == []
    assert eng.evaluate({"gauge:g:value": 0.0}, now=20.0) == []
    t = eng.evaluate({"gauge:g:value": 0.0}, now=25.0)
    assert [x["kind"] for x in t] == ["resolve"]
    assert t[0]["duration_s"] == pytest.approx(15.0)
    assert eng.active() == []
    # pending was reset by the earlier dip: a fresh fire needs a fresh
    # uninterrupted for_s window
    assert eng.evaluate({"gauge:g:value": 2.0}, now=26.0) == []
    assert [x["kind"] for x in
            eng.evaluate({"gauge:g:value": 2.0}, now=36.0)] == ["fire"]


def test_fire_emits_events_sink_gauge_and_context(tmp_path, monkeypatch):
    from raft_tpu_torch.obs import alerts, metrics
    from raft_tpu_torch.obs.alerts import Rule, read_sink

    metrics.reset()
    log = tmp_path / "events.jsonl"
    sink = tmp_path / "alerts.jsonl"
    monkeypatch.setenv("RAFT_TPU_LOG", str(log))
    eng, _ = _engine([Rule("boom", "counter:c", "above", threshold=0.0,
                           severity="critical", context="canary_parity")],
                     sink=str(sink))
    alerts.set_context("canary_parity", {"offending": "rB"})
    try:
        eng.evaluate({"counter:c": 3.0}, now=1.0)
        assert metrics.gauge("alerts_active").value == 1.0
        assert metrics.counter("alerts_fired").value == 1
        eng.evaluate({"counter:c": 0.0}, now=2.0)
        assert metrics.gauge("alerts_active").value == 0.0
        assert metrics.counter("alerts_resolved").value == 1
    finally:
        alerts.set_context("canary_parity", None)
    fires = read_events(log, name="alert_fire")
    resolves = read_events(log, name="alert_resolve")
    assert len(fires) == 1 and len(resolves) == 1
    assert fires[0]["rule"] == "boom" and fires[0]["severity"] == "critical"
    assert fires[0]["context"] == {"offending": "rB"}
    assert resolves[0]["duration_s"] == pytest.approx(1.0)
    # the JSONL sink holds the same two transition records
    records, bad = read_sink(str(sink))
    assert bad == 0 and [r["kind"] for r in records] == ["fire", "resolve"]
    assert records[0]["rule"] == "boom"
    assert records[0]["context"] == {"offending": "rB"}
    assert records[1]["duration_s"] == pytest.approx(1.0)
    from raft_tpu_torch.obs.alerts import render_sink_summary

    lines = render_sink_summary(records)
    assert len(lines) == 2 and "boom" in lines[0]


def test_flatten_snapshot_gauge_value_and_derived(monkeypatch):
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.obs.alerts import flatten_snapshot

    metrics.reset()
    metrics.counter("serve_cache_hits").inc(3)
    metrics.counter("serve_cache_misses").inc(1)
    metrics.gauge("canary_parity_ok").set(0.0)
    metrics.histogram("serve_request_s").observe(0.1)
    flat = flatten_snapshot(metrics.snapshot())
    assert flat["derived:serve_cache_hit_rate"] == pytest.approx(0.75)
    assert flat["gauge:canary_parity_ok:value"] == 0.0
    assert flat["counter:serve_cache_hits"] == 3.0
    assert "hist:serve_request_s:p95" in flat
    metrics.reset()


def test_maybe_start_zero_overhead(monkeypatch):
    from raft_tpu_torch.obs import alerts

    monkeypatch.delenv("RAFT_TPU_ALERT_EVAL_S", raising=False)
    assert alerts.maybe_start() is None
    assert alerts.installed_engine() is None
    payload = alerts.endpoint_payload()
    assert payload["enabled"] is False and payload["active"] == []
    alerts.stop()  # idempotent no-op


def test_maybe_start_and_stop_lifecycle(monkeypatch, tmp_path):
    from raft_tpu_torch.obs import alerts

    monkeypatch.setenv("RAFT_TPU_ALERT_EVAL_S", "30")
    try:
        daemon = alerts.maybe_start()
        assert daemon is not None and daemon.is_alive()
        assert daemon.daemon and daemon.name == "raft-alert-eval"
        assert alerts.maybe_start() is daemon  # idempotent
        payload = alerts.endpoint_payload()
        assert payload["enabled"] and len(payload["rules"]) == 7
    finally:
        alerts.stop()
    assert alerts.installed_engine() is None
    assert not daemon.is_alive()


# ---------------------------------------------------------------- replay


def test_alerts_eval_cli_clean_and_seeded(capsys):
    from raft_tpu_torch.obs.__main__ import main

    assert main(["alerts", "check"]) == 0
    assert main(["alerts", "eval", "--record",
                 os.path.join(FIXTURES, "clean.json")]) == 0
    rc = main(["alerts", "eval", "--record",
               os.path.join(FIXTURES, "alerting.json")])
    assert rc == 1
    out = capsys.readouterr().out
    assert "breaker-storm" in out and "canary-parity" in out
    assert "slo-breach" in out


def test_alerts_check_cli_rejects_bad_file(tmp_path, capsys):
    from raft_tpu_torch.obs.__main__ import main

    bad = tmp_path / "r.json"
    bad.write_text(json.dumps({"rules": [
        {"name": "x", "metric": "nope", "predicate": "above"}]}))
    assert main(["alerts", "check", "--rules", str(bad)]) == 1
    assert main(["alerts", "list"]) == 0
    assert "breaker-storm" in capsys.readouterr().out


def test_compile_budget_burn_sees_sentinel_counts():
    """The recompile sentinel's counts live OUTSIDE the metrics
    snapshot (record['compiles'], /healthz) — flatten must fold them
    into the counter: namespace or the compile-budget-burn rule can
    never fire, live or in replay."""
    from raft_tpu_torch.obs.alerts import (default_rules, flatten_record,
                                     replay_rules)

    record = {"snapshot": {}, "compiles": {"xla_compiles": 12,
                                           "xla_real_compiles": 3}}
    flat = flatten_record(record)
    assert flat["counter:xla_real_compiles"] == 3.0
    assert flat["counter:xla_compiles"] == 12.0
    fired, _checked = replay_rules(default_rules(), record)
    assert [f["rule"] for f in fired] == ["compile-budget-burn"]
    # a genuinely-in-snapshot counter of the same name wins (setdefault)
    flat2 = flatten_record({"snapshot": {"counters":
                                         {"xla_real_compiles": 7}},
                            "compiles": {"xla_real_compiles": 3}})
    assert flat2["counter:xla_real_compiles"] == 7.0


def test_replay_rate_rules_use_replay_threshold():
    from raft_tpu_torch.obs.alerts import Rule, replay_rules

    record = {"snapshot": {"counters": {"shard_retries": 2}}}
    # cumulative 2 > replay_above 0 -> fires; raising replay_above
    # above the total silences it; absent metric does not apply
    fired, checked = replay_rules(
        [Rule("r", "counter:shard_retries", "rate_above", threshold=5.0),
         Rule("quiet", "counter:shard_retries", "rate_above",
              threshold=5.0, replay_above=10.0),
         Rule("gone", "counter:never_minted", "rate_above")], record)
    assert checked == 2
    assert [f["rule"] for f in fired] == ["r"]


# ------------------------------------------------------ provenance codec


def test_provenance_format_parse_round_trip():
    from raft_tpu_torch.obs.alerts import format_provenance, parse_provenance

    prov = {"bank_key": "abc123", "bank_sha": "deadbeef",
            "code": "c0ffee", "flags": "f00", "replica": "rA-1"}
    s = format_provenance(prov)
    assert s == ("bank_key=abc123;bank_sha=deadbeef;code=c0ffee;"
                 "flags=f00;replica=rA-1")
    assert parse_provenance(s) == prov
    # header-hostile characters are sanitized, never smuggled
    s2 = format_provenance({"bank_key": "a;b=c d", "replica": "r"})
    assert ";b" not in s2.split(";", 1)[1] if ";" in s2 else True
    assert parse_provenance(s2)["bank_key"] == "a_b_c_d"
    # garbled/empty values parse to None, never crash
    assert parse_provenance(None) is None
    assert parse_provenance("") is None
    assert parse_provenance("no-equals-signs") is None


def test_provenance_consistency_verdicts():
    from raft_tpu_torch.obs.alerts import provenance_consistency

    a = {"bank_sha": "x", "bank_key": "k", "code": "c", "flags": "f",
         "replica": "rA"}
    b = {**a, "replica": "rB"}
    ok = provenance_consistency({"spar": {"rA": a, "rB": b}})
    assert ok["consistent"] and ok["splits"] == []
    # replica id differing is NOT a split; bank_sha differing is
    bad = provenance_consistency(
        {"spar": {"rA": a, "rB": {**b, "bank_sha": "y"}}})
    assert not bad["consistent"]
    assert bad["splits"][0]["field"] == "bank_sha"
    assert bad["splits"][0]["values"] == {"rA": "x", "rB": "y"}
    # one replica per design: nothing to compare
    assert provenance_consistency({"spar": {"rA": a}})["consistent"]


# ------------------------------------------------------- report sections


def _anchor():
    return {"t": 0.0, "event": "proc_start", "unix_t": 0.0,
            "argv0": "x", "pid": 1}


def test_report_alerts_and_canary_section():
    from raft_tpu_torch.obs.report import render_report, report_data

    events = [_anchor()]
    events.append({"t": 1.0, "pid": 1, "event": "alert_fire",
                   "rule": "breaker-storm", "severity": "critical",
                   "metric": "counter:router_breaker_opens",
                   "value": 1.0, "threshold": 0.0, "context": None})
    events.append({"t": 2.0, "pid": 1, "event": "alert_resolve",
                   "rule": "breaker-storm", "severity": "critical",
                   "metric": "counter:router_breaker_opens",
                   "duration_s": 1.0, "value": 0.0})
    events.append({"t": 3.0, "pid": 1, "event": "alert_fire",
                   "rule": "canary-parity", "severity": "critical",
                   "metric": "gauge:canary_parity_ok:value",
                   "value": 0.0, "threshold": 1.0,
                   "context": {"failing": {}}})
    events.append({"t": 0.5, "pid": 1, "event": "canary_golden",
                   "design": "spar", "key": "k", "status": 0,
                   "replica": "rA"})
    for i, ok in enumerate((True, True, False)):
        events.append({"t": 1.0 + i, "pid": 1, "event": "canary_check",
                       "design": "spar", "replica": "rB", "ok": ok,
                       "reason": "match" if ok else "status 4 != 0",
                       "provenance_ok": ok, "key": "k"})
    data = report_data(events)
    a = data["alerts"]
    assert a["rules"]["breaker-storm"] == {"severity": "critical",
                                           "fires": 1, "resolves": 1}
    assert a["active_at_end"] == ["canary-parity"]
    assert a["canary"] == {"goldens": 1, "checks": 3, "failed": 1,
                           "provenance_failures": 1}
    text = render_report(events)
    assert "alerts & canaries" in text
    assert "STILL FIRING at capture end: canary-parity" in text
    assert "1 failed (1 provenance split(s))" in text
    # no alert/canary events -> no section
    assert report_data([_anchor()])["alerts"] is None


def test_report_router_provenance_consistency_line():
    from raft_tpu_torch.obs.alerts import format_provenance
    from raft_tpu_torch.obs.report import render_report, report_data

    good = format_provenance({"bank_key": "k", "bank_sha": "aaaa",
                              "code": "c", "flags": "f", "replica": "rA"})
    skew = format_provenance({"bank_key": "k", "bank_sha": "bbbb",
                              "code": "c", "flags": "f", "replica": "rB"})
    events = [_anchor()]
    for i, (rid, prov) in enumerate((("rA", good), ("rB", good))):
        events.append({"t": 0.1 * i, "pid": 1, "event": "router_request",
                       "replica": rid, "code": 200, "attempts": 1,
                       "hedged": False, "design": "spar",
                       "wall_s": 0.01, "provenance": prov})
    data = report_data(events)
    prov = data["router"]["provenance"]
    assert prov["consistent"] and prov["replicas"] == ["rA", "rB"]
    assert "provenance: consistent" in render_report(events)
    # divergent bank sha on rB: the section names the split
    events[-1]["provenance"] = skew
    data = report_data(events)
    prov = data["router"]["provenance"]
    assert not prov["consistent"]
    assert prov["splits"][0]["values"]["rB"] == "bbbb"
    text = render_report(events)
    assert "INCONSISTENT" in text and "rB=bbbb" in text


# ------------------------------------------------- equal to the reference


def _cli(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _rule_files(tmp_path):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"rules": [
        {"name": "slo-breach", "metric": "counter:serve_slo_breaches",
         "predicate": "rate_above", "threshold": 9.0},
        {"name": "my-rule", "metric": "hist:serve_request_s:p95",
         "predicate": "above", "threshold": 2.0},
        {"name": "lease-churn", "disabled": True}]}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rules": [
        {"name": "x", "metric": "nope", "predicate": "above"}]}))
    empty = tmp_path / "only.json"
    empty.write_text(json.dumps({"default_pack": False, "rules": [
        {"name": "only", "metric": "counter:serve_errors",
         "predicate": "above", "threshold": 0}]}))
    return {"good": str(good), "bad": str(bad), "only": str(empty)}


@pytest.mark.parametrize("argv", [
    ["alerts", "check"],
    ["alerts", "list"],
    ["alerts", "check", "--rules", "{good}"],
    ["alerts", "check", "--rules", "{bad}"],
    ["alerts", "list", "--rules", "{only}"],
    ["alerts", "eval", "--record", "clean.json"],
    ["alerts", "eval", "--record", "alerting.json"],
    ["alerts", "eval", "--record", "regressed.json"],
    ["alerts", "eval", "--record", "baseline.json"],
    ["alerts", "eval", "--record", "alerting.json", "--rules", "{only}"],
    ["alerts", "eval", "--record", "missing.json"],
], ids=lambda a: "-".join(x.strip("{}").replace(".json", "")
                          for x in a[1:]))
def test_alerts_verbs_exit_and_print_as_the_references(argv, tmp_path,
                                                       capsys):
    """Same rule files and records: the same exit code, and the same
    lines where they carry no rule help text (the port's help strings
    drop the reference's change-history references)."""
    from raft_tpu.obs.__main__ import main as jmain
    from raft_tpu_torch.obs.__main__ import main as tmain

    files = _rule_files(tmp_path)
    argv = [a.format(**files) for a in argv]
    if "--record" in argv:
        i = argv.index("--record") + 1
        argv[i] = os.path.join(FIXTURES, argv[i])
    jrc, jout, _ = _cli(jmain, list(argv), capsys)
    trc, tout, _ = _cli(tmain, list(argv), capsys)
    assert trc == jrc

    def strip(text):
        return [ln.split(" — ")[0] for ln in text.splitlines()]

    assert strip(tout) == strip(jout)


def test_alerts_list_sink_equals_the_references(tmp_path, capsys):
    from raft_tpu.obs.__main__ import main as jmain
    from raft_tpu_torch.obs.__main__ import main as tmain

    sink = tmp_path / "sink.jsonl"
    sink.write_text(
        json.dumps({"t_unix": 1.0, "kind": "fire", "rule": "slo-breach",
                    "severity": "warning", "metric": "counter:x",
                    "value": 2.0, "context": {"a": 1}}) + "\n"
        + "{not json\n"
        + json.dumps({"t_unix": 3.0, "kind": "resolve", "rule":
                      "slo-breach", "duration_s": 2.0}) + "\n")
    argv = ["alerts", "list", "--sink", str(sink)]
    jrc, jout, _ = _cli(jmain, argv, capsys)
    trc, tout, _ = _cli(tmain, argv, capsys)
    assert (trc, tout) == (jrc, jout)


@pytest.mark.parametrize("record", ["clean.json", "alerting.json",
                                    "regressed.json", "baseline.json"])
def test_replay_and_flatten_equal_the_references(record):
    from raft_tpu.obs import alerts as jalerts
    from raft_tpu_torch.obs import alerts as talerts
    from raft_tpu_torch.obs import runs

    rec = runs.load_record(os.path.join(FIXTURES, record))
    assert talerts.flatten_record(rec) == jalerts.flatten_record(rec)
    tf, tc = talerts.replay_rules(talerts.default_rules(), rec)
    jf, jc = jalerts.replay_rules(jalerts.default_rules(), rec)
    assert tc == jc
    assert [{k: v for k, v in f.items() if k != "help"} for f in tf] == \
        [{k: v for k, v in f.items() if k != "help"} for f in jf]


def test_default_pack_equals_the_references():
    import dataclasses

    from raft_tpu.obs import alerts as jalerts
    from raft_tpu_torch.obs import alerts as talerts

    def fields(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k != "help"}

    assert [fields(r) for r in talerts.default_rules()] == \
        [fields(r) for r in jalerts.default_rules()]


@pytest.mark.parametrize("seed", range(3))
def test_engine_transitions_equal_the_references(seed):
    """The same metric views at the same instants fire and resolve the
    same rules with the same records (but for the wall-clock stamp and
    the process id)."""
    from raft_tpu.obs import alerts as jalerts
    from raft_tpu_torch.obs import alerts as talerts

    rng = np.random.default_rng(seed)
    specs = [dict(name="a", metric="gauge:g:value", predicate="above",
                  threshold=5.0, for_s=2.0, clear_s=3.0),
             dict(name="b", metric="gauge:g:value", predicate="below",
                  threshold=1.0),
             dict(name="r", metric="counter:c", predicate="rate_above",
                  threshold=2.0, clear_s=1.0),
             dict(name="m", metric="counter:gone", predicate="absent")]
    engines = [mod.AlertEngine([mod.parse_rule(s) for s in specs],
                               clock=lambda: 0.0)
               for mod in (talerts, jalerts)]
    c = 0.0
    for step in range(30):
        c += float(rng.uniform(0.0, 40.0))
        flat = {"gauge:g:value": float(rng.uniform(0.0, 7.0)),
                "counter:c": c}
        if rng.uniform() < 0.3:
            flat["counter:gone"] = 1.0
        got = [[{k: v for k, v in t.items() if k not in ("t_unix", "pid")}
                for t in eng.evaluate(flat, now=float(step * 1.5))]
               for eng in engines]
        assert got[0] == got[1]
    assert engines[0].summary() == engines[1].summary()


def test_provenance_codec_equals_the_references():
    from raft_tpu.obs import alerts as jalerts
    from raft_tpu_torch.obs import alerts as talerts

    provs = [{"bank_key": "a;b=c d", "replica": "r"},
             {"bank_key": "k", "bank_sha": "s", "code": "c", "flags": "f",
              "replica": "r1", "release": "rel-1", "other": "x"}]
    for p in provs:
        assert talerts.format_provenance(p) == jalerts.format_provenance(p)
    for v in (None, "", "no-equals", "a=1;b=2;=3;c", 5):
        assert talerts.parse_provenance(v) == jalerts.parse_provenance(v)
    view = {"spar": {"rA": {"bank_sha": "x", "code": "c", "release": "r1"},
                     "rB": {"bank_sha": "y", "code": "c", "release": "r2"}}}
    for rel in (None, {"allowed": ["r1"], "entries": {"r1": ["x"]}}):
        assert talerts.provenance_consistency(view, rel) == \
            jalerts.provenance_consistency(view, rel)


def test_report_imports_the_alert_codec():
    """obs report uses the alert module's codec (no second copy)."""
    from raft_tpu_torch.obs import alerts, report

    assert report.parse_provenance is alerts.parse_provenance
    assert report.provenance_consistency is alerts.provenance_consistency

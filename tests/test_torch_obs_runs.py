"""The port's run-record store and regression sentinel
(``raft_tpu_torch/obs/runs.py``) and the ``runs`` / ``alerts`` verbs of
its CLI, against the JAX package's.

* ``flatten``, ``watch_rule``, ``compare_records`` and
  ``regress_records`` give the JAX package's results on the same record
  dicts (``tests/fixtures/runs/*.json`` and records the port writes);
  ``ingest_bench`` on small artifacts this test writes;
* a record is written at the serial and at the fabric ``sweep_done``
  only when ``RAFT_TPU_RUNS_DIR`` is set, with the port's environment
  fingerprint (torch, not jax) and the reference's schema;
* the CLI's ``runs record|list|compare|regress|ingest|pin`` and their
  exit codes; the ``alerts`` verbs exit as the reference's (their
  outputs are held in ``tests/test_torch_alerts.py``).
"""

import copy
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from raft_tpu.obs import runs as jruns
from raft_tpu_torch.obs import __main__ as cli
from raft_tpu_torch.obs import metrics, runs
from raft_tpu_torch.parallel import fabric
from raft_tpu_torch.parallel.sweep import (full_compute, make_mesh,
                                           run_sweep_checkpointed_full)
from raft_tpu_torch.utils import faults

HERE = os.path.abspath(__file__)
FIXTURES = os.path.join(os.path.dirname(HERE), "fixtures", "runs")
RECORDS = ("baseline", "clean", "regressed", "alerting")


def _toy_full(Hs, Tp):
    return {"PSD": torch.stack([Hs, Tp, Hs * Tp], -1), "X0": Hs - Tp}


def toy_entry(out_keys=("PSD", "X0"), **_):
    """Fabric entry of the toy evaluator (loaded by the workers by path)."""
    return full_compute(_toy_full, out_keys=tuple(out_keys))


def _cases(n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(Hs=2.0 + 6.0 * rng.random(n), Tp=8.0 + 8.0 * rng.random(n))


def _sweep(tmp_path, name, seed=0):
    return run_sweep_checkpointed_full(
        _toy_full, _cases(8, seed), str(tmp_path / name), shard_size=4,
        mesh=make_mesh(2, device="cpu"))


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture
def store(tmp_path, monkeypatch):
    d = str(tmp_path / "runs")
    os.makedirs(d)
    monkeypatch.setenv("RAFT_TPU_RUNS_DIR", d)
    return d


# ------------------------------------------------------- parity with JAX


def test_flatten_compare_regress_equal_the_jax_package():
    recs = {n: _fixture(n) for n in RECORDS}
    for n, r in recs.items():
        assert runs.flatten(r) == jruns.flatten(r), n
    for a in RECORDS:
        for b in RECORDS:
            new, base = recs[a], recs[b]
            assert runs.compare_records(new, base) == \
                jruns.compare_records(new, base)
            for kw in ({}, {"rel_tol": 0.1}, {"floor_scale": 3.0}):
                assert runs.regress_records(new, base, **kw) == \
                    jruns.regress_records(new, base, **kw), (a, b, kw)
            assert runs.env_mismatch(new, base) == \
                jruns.env_mismatch(new, base)
    verdict = runs.regress_records(recs["regressed"], recs["baseline"])
    assert not verdict["ok"]
    names = set(runs.flatten(recs["regressed"])) | {
        "hist:program_gflops_s:p50", "extra:design_evals_per_s",
        "waste:strips", "counter:rows_evaluated", "hist:serve_tick_s:p95",
        "stage:solve:p95", "window:serve_request_s:p50", "wall_s"}
    for name in sorted(names):
        assert runs.watch_rule(name) == jruns.watch_rule(name), name
    assert runs.WATCH_RULES == jruns.WATCH_RULES
    assert runs.SCHEMA_VERSION == jruns.SCHEMA_VERSION


def test_env_flag_overrides_match(monkeypatch):
    base, new = _fixture("baseline"), _fixture("regressed")
    monkeypatch.setenv("RAFT_TPU_RUNS_REL_TOL", "100")
    monkeypatch.setenv("RAFT_TPU_RUNS_ABS_FLOOR", "2.5")
    assert runs.regress_records(new, base) == \
        jruns.regress_records(new, base)
    assert runs.regress_records(new, base)["ok"]


def test_ingest_bench_equals_the_jax_package(tmp_path):
    arts = {
        "BENCH_r11.json": {"metric": "design_evals_per_s", "unit":
                           "evals/s", "value": 812.5, "vs_baseline": 3.1,
                           "breakdown": {"serve": {"p95_ms": 12.0,
                                                   "ok": True},
                                         "rows": 512}},
        "BENCH_r12.json": {"n": 12, "cmd": "bench", "rc": 0,
                           "parsed": {"metric": "m", "unit": "x",
                                      "value": 1.5}},
        "BENCH_r13.json": {"n": 13, "cmd": "bench", "rc": 124,
                           "parsed": None, "tail": "..."},
    }
    for name, art in arts.items():
        path = tmp_path / name
        path.write_text(json.dumps(art))
        os.utime(path, (1.7e9, 1.7e9))
        assert runs.ingest_bench(str(path)) == \
            jruns.ingest_bench(str(path)), name
    r11 = runs.ingest_bench(str(tmp_path / "BENCH_r11.json"))
    assert r11["label"] == "r11" and r11["extra"]["evals_per_s"] == 812.5
    assert r11["extra"]["breakdown.serve.p95_ms"] == 12.0
    assert runs.ingest_bench(str(tmp_path / "BENCH_r13.json"))[
        "headline"]["failed"]
    bad = tmp_path / "BENCH_r14.json"
    bad.write_text(json.dumps({"nothing": 1}))
    with pytest.raises(ValueError, match="not a bench artifact"):
        runs.ingest_bench(str(bad))


# --------------------------------------------------------------- records


def test_serial_sweep_records_only_with_a_store(tmp_path, monkeypatch):
    monkeypatch.delenv("RAFT_TPU_RUNS_DIR", raising=False)
    _sweep(tmp_path, "off")
    assert runs.maybe_record("sweep") is None
    d = str(tmp_path / "runs")
    monkeypatch.setenv("RAFT_TPU_RUNS_DIR", d)
    monkeypatch.setenv("RAFT_TPU_RUN_ID", "portstore01")
    metrics.reset()
    _sweep(tmp_path, "s1", seed=1)
    ((path, rec),) = runs.list_records(d)
    assert rec["schema"] == jruns.SCHEMA_VERSION
    assert rec["kind"] == "sweep" and rec["label"] == "s1"
    assert rec["run_id"] == "portstore01" and rec["wall_s"] > 0
    assert rec["compiles"] == {} and "cost_ledger" not in rec
    env = rec["env"]
    for k in runs.ENV_COMPARE_KEYS:
        assert k in env, k
    assert env["torch"] == torch.__version__ and "jax" not in env
    assert env["platform"] == "cpu" and env["dtype"] == "float64"
    assert re.fullmatch(r"[0-9a-f]{16}", env["code"])
    assert rec["git_sha"] is None or re.fullmatch(r"[0-9a-f]{40}",
                                                  rec["git_sha"])
    flat = runs.flatten(rec)
    assert flat == jruns.flatten(rec)
    assert flat["counter:shards_done"] == 2
    assert flat["extra:n_cases"] == 8 and flat["hist:shard_wall_s:p95"] > 0
    # a deliberately slowed dispatch (0.25 s a shard) is caught
    metrics.reset()
    with faults.inject("delay:shard_eval:8"):
        _sweep(tmp_path, "slow", seed=1)
    (_, a), (_, c) = runs.list_records(d)
    verdict = runs.regress_records(c, a)
    assert not verdict["ok"] and verdict == jruns.regress_records(c, a)
    assert "hist:shard_wall_s:p95" in {r["metric"]
                                       for r in verdict["regressions"]}
    # an unwritable store never fails the run
    monkeypatch.setenv("RAFT_TPU_RUNS_DIR", os.path.join(path, "x"))
    assert runs.maybe_record("sweep") is None


def test_fabric_sweep_records_only_with_a_store(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FABRIC_POLL_S", "0.1")
    monkeypatch.delenv("RAFT_TPU_RUNS_DIR", raising=False)
    cases = _cases(8, seed=3)
    fabric.run_fabric(str(tmp_path / "f0"), 1, f"{HERE}:toy_entry",
                      cases=cases, out_keys=("PSD", "X0"), shard_size=4,
                      device="cpu")
    d = str(tmp_path / "runs")
    assert not os.path.exists(d)
    monkeypatch.setenv("RAFT_TPU_RUNS_DIR", d)
    metrics.reset()
    out = fabric.run_fabric(str(tmp_path / "f1"), 1, f"{HERE}:toy_entry",
                            cases=_cases(8, seed=4), out_keys=("PSD", "X0"),
                            shard_size=4, device="cpu")
    assert out["X0"].shape == (8,)
    ((_, rec),) = runs.list_records(d)
    assert rec["kind"] == "sweep" and rec["label"] == "f1"
    assert rec["extra"] == {"n_cases": 8, "n_shards": 2, "n_workers": 1,
                            "n_quarantined": 0, "n_flagged": 0}
    # the worker's counters were folded into the coordinator's registry
    assert runs.flatten(rec)["counter:shards_done"] == 2


# ------------------------------------------------------------------- CLI


def _copy_fixtures(store):
    for day, name in enumerate(("baseline", "clean", "regressed"), 1):
        shutil.copy(os.path.join(FIXTURES, f"{name}.json"),
                    os.path.join(store,
                                 f"run-2025010{day}T000000-1-{name[:6]}.json"))
    return [p for p, _ in runs.list_records(store)]


def test_cli_runs_verbs_and_regress_exit_codes(store, tmp_path, capsys):
    p_base, p_clean, p_regr = _copy_fixtures(store)
    # no baseline pinned yet: a usage error
    assert cli.main(["runs", "regress", "--dir", store]) == 2
    assert "no baseline pinned" in capsys.readouterr().err
    assert cli.main(["runs", "pin", p_base, "--dir", store]) == 0
    assert os.path.samefile(runs.pinned_baseline(store), p_base)
    capsys.readouterr()
    # default resolution: the newest record (regressed) vs the pin
    assert cli.main(["runs", "regress", "--dir", store]) == 1
    out = capsys.readouterr()
    assert "REGRESSION" in out.out and "hist:shard_wall_s:p95" in out.out
    assert "FAILED" in out.err
    assert cli.main(["runs", "regress", p_clean, "--baseline", p_base,
                     "--check"]) == 0
    assert "no regressions" in capsys.readouterr().out
    assert cli.main(["runs", "regress", p_regr, "--baseline", p_base,
                     "--rel-tol", "1000"]) == 0
    capsys.readouterr()
    assert cli.main(["runs", "regress", str(tmp_path / "nope.json"),
                     "--baseline", p_base]) == 2
    capsys.readouterr()
    assert cli.main(["runs", "list", "--dir", store]) == 0
    out = capsys.readouterr().out
    assert "baseline:" in out and out.count("run-2025") == 4
    assert cli.main(["runs", "compare", p_regr, p_base,
                     "--changed-only"]) == 0
    assert "hist:shard_wall_s:p95" in capsys.readouterr().out
    art = tmp_path / "BENCH_r21.json"
    art.write_text(json.dumps({"metric": "m", "unit": "evals/s",
                               "value": 2.0}))
    assert cli.main(["runs", "ingest", str(art), "--dir", store]) == 0
    assert cli.main(["runs", "ingest", str(tmp_path / "missing.json"),
                     "--dir", store]) == 2
    capsys.readouterr()
    assert cli.main(["runs", "record", "--kind", "manual", "--label", "t",
                     "--events", os.path.join(os.path.dirname(HERE),
                                              "fixtures", "obs"),
                     "--extra-json", '{"evals_per_s": 5.0}',
                     "--dir", store]) == 0
    rec = runs.list_records(store)[-1][1]
    assert rec["kind"] == "manual" and rec["report"]["workers"]
    assert runs.flatten(rec)["extra:evals_per_s"] == 5.0
    assert cli.main(["runs", "record", "--extra-json", "[1]",
                     "--dir", store]) == 2
    assert len(runs.list_records(store)) == 5


@pytest.mark.parametrize("verb", [["list"], ["check"],
                                  ["eval", "--record", "x.json"]])
def test_cli_alerts_verbs_refuse(verb, capsys):
    """The alert verbs are ported (``obs/alerts.py``): they exit as the
    reference's do — ``list`` and ``check`` of the default pack 0, an
    ``eval`` of a record that does not exist refused with 2 — and no
    longer name a ROADMAP item."""
    from raft_tpu.obs.__main__ import main as jmain

    want = {"list": 0, "check": 0, "eval": 2}[verb[0]]
    assert cli.main(["alerts"] + verb) == want
    err = capsys.readouterr().err
    assert "A15(d)" not in err and "not ported" not in err
    assert jmain(["alerts"] + verb) == want


def test_build_record_is_the_reference_schema(monkeypatch):
    metrics.counter("shards_done").inc(3)
    rec = runs.build_record("manual", label="x", wall_s=1.25,
                            extra={"a": {"b": 2}})
    jrec = jruns.build_record("manual", label="x", wall_s=1.25,
                              extra={"a": {"b": 2}})
    assert set(rec) == set(jrec) - {"cost_ledger"}
    assert rec["snapshot"]["counters"] == {"shards_done": 3}
    assert runs.flatten(rec)["extra:a.b"] == 2.0
    assert runs.flatten(copy.deepcopy(rec)) == jruns.flatten(rec)

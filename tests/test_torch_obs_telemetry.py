"""The telemetry hook-ups of the port's ``Model.analyze_cases`` and
``ResultCache`` against the JAX package's.

* ``analyze_cases`` on the spar demo's one-case table: the port's
  ``solve_statics`` / ``solve_dynamics`` spans, its ``cases_done`` and
  ``cases_flagged`` counters, its ``drag_iterations`` histogram and its
  ``drag_linearisation`` events equal what the JAX package's
  ``analyze_cases`` records for the same case.  The JAX solves take
  about 50 s of compilation on this CPU, so the JAX model's
  ``solve_statics`` / ``solve_dynamics`` hand its telemetry loop the
  diagnostics they returned when the JAX package wrote
  ``golden_orch_spar.npz`` (``tests/make_torch_port_fixtures.py
  --orchestrated``); the loop itself, its metric names and its event
  fields, is the JAX package's own code.  The port's drag residual is
  held at the orchestrated gate (1e-10 x its value), every other field
  bit-equal;
* on a two-case table ``cases_done`` is 2 (the reference's loop
  rebinds ``metrics`` at its first case's outputs, so its second case
  raises: ROADMAP §C);
* the port's ``ResultCache`` and the reference's give equal
  ``<prefix>_hits`` / ``_misses`` / ``_evictions`` counters and
  ``<prefix>_bytes`` gauge after the same gets and puts.
"""

import json
import os

import numpy as np
import pytest

from raft_tpu.obs import metrics as jmetrics
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.obs import metrics

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
TOL = 1e-10


def _design():
    with open(os.path.join(FIX, "design_spar.json")) as f:
        return json.load(f)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _telemetry(snap, evs):
    """The comparable part of one run: counters, the drag-iteration
    histogram, the drag_linearisation payloads and the span sequence."""
    spans = [(e["name"], e.get("case")) for e in evs
             if e["event"] == "span_begin"]
    lin = [{k: e[k] for k in ("case", "fowt", "resid", "converged",
                              "n_iter", "status", "reason")}
           for e in evs if e["event"] == "drag_linearisation"]
    return (snap["counters"], snap["histograms"].get("drag_iterations"),
            lin, spans)


def _jax_recorded_run(tmp_path, monkeypatch):
    """The JAX package's analyze_cases loop over its recorded solves."""
    import raft_tpu
    import raft_tpu.models.outputs as jout

    g = np.load(os.path.join(FIX, "golden_orch_spar.npz"))
    model = raft_tpu.Model(_design())
    nw = len(model.w)

    def statics(case=None, extra_force=None):
        model.statics_status = int(g["statics_status"][0])
        return g["mean_offsets"][0]

    def dynamics(case, X0=None):
        dd = {"status": g["dyn_status"][0, 0],
              "n_iter_drag": g["n_iter_drag"][0, 0],
              "drag_converged": g["drag_converged"][0, 0],
              "drag_resid": g["drag_resid"][0, 0]}
        tc = {"A00": np.zeros((6, 6, nw)), "B00": np.zeros((6, 6, nw)),
              "f_aero0": np.zeros(6)}
        return np.zeros((1, 6, nw)), {"infos": [
            {"tc": tc, "S": None, "zeta": None, "dyn_diag": dd}]}

    monkeypatch.setattr(model, "solve_statics", statics)
    monkeypatch.setattr(model, "solve_dynamics", dynamics)
    monkeypatch.setattr(jout, "turbine_outputs", lambda *a, **k: {})
    log = str(tmp_path / "jax.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    jmetrics.reset()
    model.analyze_cases()
    monkeypatch.delenv("RAFT_TPU_LOG")
    return _telemetry(jmetrics.snapshot(), _events(log))


def test_analyze_cases_telemetry_equals_the_jax_package(tmp_path,
                                                        monkeypatch):
    ref = _jax_recorded_run(tmp_path, monkeypatch)
    log = str(tmp_path / "port.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    metrics.reset()
    Model(_design()).analyze_cases(device="cpu")
    got = _telemetry(metrics.snapshot(), _events(log))
    assert got[0] == ref[0] == {"cases_done": 1}
    assert got[1] == ref[1] and got[1]["count"] == 1
    assert got[3] == ref[3] == [("solve_statics", 0), ("solve_dynamics", 0)]
    (lin,), (jlin,) = got[2], ref[2]
    assert abs(lin.pop("resid") - jlin["resid"]) <= TOL * abs(jlin["resid"])
    jlin.pop("resid")
    assert lin == jlin


def test_analyze_cases_counts_every_case(tmp_path, monkeypatch):
    d = _design()
    d["cases"]["data"] = [d["cases"]["data"][0],
                          d["cases"]["data"][0][:6] + [10, 4] +
                          d["cases"]["data"][0][8:]]
    log = str(tmp_path / "port.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    metrics.reset()
    m = Model(d)
    assert len(m.cases) == 2
    m.analyze_cases(device="cpu")
    counters, hist, lin, spans = _telemetry(metrics.snapshot(),
                                            _events(log))
    assert counters["cases_done"] == 2 and hist["count"] == 2
    assert [e["case"] for e in lin] == [0, 1]
    assert [e["n_iter"] for e in lin] == [
        dd[0]["n_iter_drag"] for dd in m.results["dyn_diag"]]
    assert spans == [("solve_statics", 0), ("solve_dynamics", 0),
                     ("solve_statics", 1), ("solve_dynamics", 1)]
    assert metrics.snapshot()["histograms"]["span_solve_dynamics_s"][
        "count"] == 2


@pytest.mark.parametrize("prefix", ["serve_cache", "omdao_cache"])
def test_result_cache_metrics_equal_the_jax_package(prefix):
    from raft_tpu.serve.cache import ResultCache as JCache
    from raft_tpu_torch.serve.cache import ResultCache

    metrics.reset()
    jmetrics.reset()
    row = {"X0": np.arange(6.0), "status": np.zeros(1, np.int32)}
    nbytes = 6 * 8 + 4
    caches = [ResultCache(2 * nbytes + 1, metrics_prefix=prefix),
              JCache(2 * nbytes + 1, metrics_prefix=prefix)]
    for c in caches:
        assert c.get("a") is None
        assert c.put("a", row) and c.put("b", row)
        assert c.get("a")["X0"][5] == 5.0
        assert c.put("c", row)            # evicts b (least recent)
        assert c.get("b") is None and c.get("c") is not None
        assert not c.put("huge", {"X0": np.zeros(64)})
        assert c.put("a", row)            # re-insert: no eviction
    snaps = [metrics.snapshot(), jmetrics.snapshot()]
    want = {f"{prefix}_hits": 2, f"{prefix}_misses": 2,
            f"{prefix}_evictions": 1}
    for s in snaps:
        assert {k: v for k, v in s["counters"].items()
                if k.startswith(prefix)} == want
    assert snaps[0]["gauges"][f"{prefix}_bytes"] == \
        snaps[1]["gauges"][f"{prefix}_bytes"]
    assert snaps[0]["gauges"][f"{prefix}_bytes"]["value"] == 2 * nbytes
    assert caches[0].stats() == caches[1].stats()

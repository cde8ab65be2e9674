"""The port's fault-tolerant sweep runtime (``raft_tpu_torch/parallel/
resilience.py``), the counterpart of ``tests/test_resilience.py``.

Every failure path is triggered through ``raft_tpu_torch.utils.faults``
with cheap torch toy evaluators (batched: (R,) tensors in, a dict of
(R, ...) tensors out) on CPU meshes of one and two entries, no model
build:

* a crash mid-write (injected truncation) then a resume that is
  bit-identical to an uninterrupted run, recomputing only that shard;
* a corrupt middle shard and a stale shard (missing key) re-queued;
* manifest mismatches and an unreadable manifest refused;
* transient faults retried (with doubling backoff) or exhausted; an
  injected OOM and a ``torch.OutOfMemoryError`` halve the shard;
* NaN rows quarantined with their case parameters, healed by the solo
  CPU re-evaluation, or kept without it; a recomputed clean shard
  clears its stale quarantine entries;
* dp autopad of a ragged batch, a ragged case dict refused;
* the legacy (Hs, Tp, beta) driver sharing the runtime;
* an unhealthy device probe, or no CUDA without a mesh, RAISES (the
  port never falls back to the CPU), with ``backend_fallback_failed``;
* the fabric branch: serial with ``fabric_unavailable``, or the
  worker fabric for a compute that carries a fabric entry;
* ``log_event`` surviving payloads it cannot serialise; fault-spec
  parsing and arming from the environment.

Event names and ``metrics.json`` counters are the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.parallel import resilience
from raft_tpu_torch.parallel.sweep import (
    full_compute, make_mesh, run_sweep_checkpointed,
    run_sweep_checkpointed_full, sweep_cases, sweep_cases_full)
from raft_tpu_torch.utils import faults
from raft_tpu_torch.utils.structlog import log_event


def toy_full(Hs, Tp):
    """Cheap full-evaluator stand-in: case rows -> dict of outputs."""
    return {"PSD": torch.stack([Hs, Tp, Hs * Tp], -1), "X0": Hs - Tp}


def toy_nan_full(Hs, Tp):
    """Toy evaluator with a deterministic pathology: NaN for Hs < 0."""
    bad = (Hs < 0)[:, None]
    out = toy_full(Hs, Tp)
    return {"PSD": torch.where(bad, torch.nan, out["PSD"]),
            "X0": torch.where(bad[:, 0], torch.nan, out["X0"])}


def toy_case(Hs, Tp, beta):
    return {"PSD": torch.stack([Hs, Tp, beta], -1), "X0": Hs + Tp + beta}


def _cases(n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(Hs=2.0 + 6.0 * rng.random(n), Tp=8.0 + 8.0 * rng.random(n))


def _events(path, name=None):
    with open(path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    return [e for e in evs if name is None or e["event"] == name]


@pytest.fixture
def log_path(tmp_path, monkeypatch):
    p = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)
    return p


def mesh2():
    return make_mesh(2, device="cpu")


def run_full(ev, cases, out_dir, **kw):
    kw.setdefault("shard_size", 4)
    kw.setdefault("mesh", mesh2())
    return run_sweep_checkpointed_full(ev, cases, str(out_dir), **kw)


# ------------------------------------------------------------ atomic writes


def test_checkpoint_roundtrip_manifest_and_no_tmp_left(tmp_path, log_path):
    cases = _cases(10)
    out_dir = str(tmp_path / "sweep")
    out1 = run_full(toy_full, cases, out_dir)
    assert out1["PSD"].shape == (10, 3)
    np.testing.assert_allclose(out1["X0"], cases["Hs"] - cases["Tp"])

    files = sorted(os.listdir(out_dir))
    assert not [f for f in files if f.endswith(".tmp")]
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    fp = manifest["fingerprint"]
    assert fp["n_cases"] == 10 and fp["shard_size"] == 4
    assert fp["out_keys"] == ["PSD", "X0"]
    assert set(fp["case_hashes"]) == {"Hs", "Tp"}
    assert fp["mesh_shape"] == [2] and fp["mesh_axes"] == ["dp"]
    assert all(manifest["shards"][str(s)]["status"] == "done"
               for s in range(3))
    with open(os.path.join(out_dir, "metrics.json")) as f:
        snap = json.load(f)
    assert snap["counters"]["shards_done"] == 3
    assert snap["counters"]["rows_evaluated"] == 10
    assert snap["histograms"]["shard_wall_s"]["count"] >= 3

    # resume: all three shards load from disk, bit-identical
    out2 = run_full(toy_full, cases, out_dir)
    for k in out1:
        assert np.array_equal(out1[k], out2[k])
    assert len(_events(log_path, "shard_resume")) == 3
    names = {e["event"] for e in _events(log_path)}
    assert {"sweep_start", "shard_start", "shard_done", "sweep_done",
            "span_begin", "span_end", "metrics_snapshot"} <= names


def test_truncation_crash_then_resume_bit_identical(tmp_path, log_path):
    """A sweep killed mid-shard-write resumes to bit-identical results,
    recomputing only the corrupt shard."""
    cases = _cases(10, seed=1)
    clean = run_full(toy_full, cases, tmp_path / "clean")

    out_dir = str(tmp_path / "crashy")
    with faults.inject("truncate:shard_write:1"):
        with pytest.raises(faults.InjectedFault):
            run_full(toy_full, cases, out_dir)
    p0 = os.path.join(out_dir, "shard_0000.npz")
    assert os.path.exists(p0)
    with pytest.raises(resilience.ShardCorruptError):
        resilience.load_shard(p0, ("PSD", "X0"))

    resumed = run_full(toy_full, cases, out_dir)
    for k in clean:
        assert np.array_equal(clean[k], resumed[k]), k
    assert [e["shard"] for e in _events(log_path, "shard_corrupt")] == [0]


def test_corrupt_middle_shard_requeued_not_crashed(tmp_path, log_path):
    cases = _cases(12, seed=2)
    out_dir = str(tmp_path / "sweep")
    out1 = run_full(toy_full, cases, out_dir)
    faults.truncate_file(os.path.join(out_dir, "shard_0001.npz"))
    out2 = run_full(toy_full, cases, out_dir)
    for k in out1:
        assert np.array_equal(out1[k], out2[k])
    assert [e["shard"] for e in _events(log_path, "shard_corrupt")] == [1]
    assert sorted(e["shard"] for e in _events(log_path, "shard_resume")) \
        == [0, 2]


def test_stale_shard_with_missing_keys_recomputed(tmp_path, log_path):
    cases = _cases(8, seed=3)
    out_dir = str(tmp_path / "sweep")
    out1 = run_full(toy_full, cases, out_dir)
    p1 = os.path.join(out_dir, "shard_0001.npz")
    with np.load(p1) as z:
        np.savez(p1, PSD=z["PSD"])
    out2 = run_full(toy_full, cases, out_dir)
    for k in out1:
        assert np.array_equal(out1[k], out2[k])
    assert [e["shard"] for e in _events(log_path, "shard_corrupt")] == [1]


# -------------------------------------------------------- manifest validation


def test_manifest_mismatch_fails_loudly(tmp_path):
    cases = _cases(8, seed=4)
    out_dir = tmp_path / "sweep"
    run_full(toy_full, cases, out_dir)
    changed = dict(cases, Hs=cases["Hs"] + 0.1)
    with pytest.raises(resilience.ManifestMismatchError, match="case_hashes"):
        run_full(toy_full, changed, out_dir)
    with pytest.raises(resilience.ManifestMismatchError, match="out_keys"):
        run_full(toy_full, cases, out_dir, out_keys=("PSD",))
    with pytest.raises(resilience.ManifestMismatchError, match="shard_size"):
        run_full(toy_full, cases, out_dir, shard_size=8)
    # the mesh is advisory: a one-entry mesh resumes the same shards
    out = run_full(toy_full, cases, out_dir, mesh=make_mesh(device="cpu"))
    assert out["PSD"].shape == (8, 3)


def test_unreadable_manifest_rejected(tmp_path):
    cases = _cases(4, seed=5)
    out_dir = str(tmp_path / "sweep")
    run_full(toy_full, cases, out_dir)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        f.write("{ not json")
    with pytest.raises(resilience.ManifestMismatchError, match="unreadable"):
        run_full(toy_full, cases, out_dir)


# ------------------------------------------------------------ retry/backoff


def test_transient_faults_retry_then_succeed(tmp_path, log_path):
    cases = _cases(8, seed=6)
    clean = run_full(toy_full, cases, tmp_path / "clean")
    with faults.inject("transient:shard_eval:2"):
        out = run_full(toy_full, cases, tmp_path / "faulty", backoff_s=0.01)
    for k in clean:
        assert np.array_equal(clean[k], out[k])
    retries = _events(log_path, "shard_retry")
    assert [e["attempt"] for e in retries] == [1, 2]
    assert retries[1]["delay_s"] == pytest.approx(2 * retries[0]["delay_s"])
    # the clean run's two attempts, then the faulty run's shard 0 (two
    # failed attempts and the third) and shard 1
    attempts = [e for e in _events(log_path, "span_end")
                if e.get("name") == "shard_attempt"]
    assert [e.get("ok") for e in attempts] == [True] * 2 + [False, False,
                                                            True, True]


def test_transient_faults_exhaust_retries(tmp_path):
    with faults.inject("transient:shard_eval:5"):
        with pytest.raises(faults.TransientInjectedError):
            run_full(toy_full, _cases(4, seed=7), tmp_path / "sweep",
                     max_retries=2, backoff_s=0.01)


def test_oom_halves_shard_batch(tmp_path, log_path):
    cases = _cases(8, seed=8)
    clean = run_full(toy_full, cases, tmp_path / "clean", shard_size=8)
    with faults.inject("oom:shard_eval:1"):
        out = run_full(toy_full, cases, tmp_path / "oom", shard_size=8)
    for k in clean:
        assert np.array_equal(clean[k], out[k])
    splits = _events(log_path, "shard_oom_split")
    assert splits and splits[0]["rows"] == 8 and splits[0]["split"] == [4, 4]
    with open(tmp_path / "oom" / "metrics.json") as f:
        assert json.load(f)["counters"]["shard_oom_splits"] == 1


def test_torch_oom_is_recognised_by_type(tmp_path, log_path):
    """A ``torch.OutOfMemoryError`` (whatever its words) halves the shard
    down to rows the evaluator can take."""
    def picky(Hs, Tp):
        if Hs.shape[0] > 1:  # a device block of 2+ rows
            raise torch.OutOfMemoryError("allocator gave up")
        return toy_full(Hs, Tp)

    cases = _cases(8, seed=15)
    out = run_full(picky, cases, tmp_path / "sweep", shard_size=8)
    np.testing.assert_array_equal(out["X0"], cases["Hs"] - cases["Tp"])
    assert [e["rows"] for e in _events(log_path, "shard_oom_split")] \
        == [8, 4, 4]
    assert resilience._is_oom(faults.OOMInjectedError())
    assert not resilience._is_oom(ValueError("bad input"))


# ------------------------------------------------------------- quarantine


def test_nan_quarantine_end_to_end(tmp_path, log_path):
    cases = _cases(8, seed=9)
    cases["Hs"][5] = -1.0
    out_dir = str(tmp_path / "sweep")
    out = run_full(toy_nan_full, cases, out_dir)
    assert np.isnan(out["X0"][5]) and np.isnan(out["PSD"][5]).all()
    mask = np.ones(8, bool)
    mask[5] = False
    np.testing.assert_allclose(out["X0"][mask],
                               (cases["Hs"] - cases["Tp"])[mask])

    entries = resilience.load_quarantine(out_dir)
    assert len(entries) == 1
    e = entries[0]
    assert e["shard"] == 1 and e["index"] == 5
    assert e["case"]["Hs"] == pytest.approx(-1.0)
    assert set(e["keys_nonfinite"]) == {"PSD", "X0"}
    assert e["retry_device"] == "cpu" and not e["resolved"]
    evs = _events(log_path, "shard_quarantine")
    assert [(v["shard"], v["index"], v["recovered"]) for v in evs] \
        == [(1, 5, False)]

    out2 = run_full(toy_nan_full, cases, out_dir)
    assert np.isnan(out2["X0"][5])
    assert len(resilience.load_quarantine(out_dir)) == 1


def test_injected_nan_recovered_by_solo_cpu_retry(tmp_path, log_path):
    cases = _cases(8, seed=10)
    clean = run_full(toy_full, cases, tmp_path / "clean")
    out_dir = str(tmp_path / "nanswp")
    with faults.inject("nan:shard_result:1"):
        out = run_full(toy_full, cases, out_dir)
    for k in clean:
        assert np.array_equal(clean[k], out[k]), k
    assert resilience.load_quarantine(out_dir) == []
    evs = _events(log_path, "shard_quarantine")
    assert [(v["shard"], v["index"], v["recovered"], v["retry_device"])
            for v in evs] == [(0, 0, True, "cpu")]


def test_quarantine_without_solo_retry(tmp_path):
    out_dir = str(tmp_path / "sweep")
    with faults.inject("nan:shard_result:1"):
        out = run_full(toy_full, _cases(4, seed=11), out_dir,
                       quarantine_retry=False)
    assert np.isnan(out["X0"][0])
    entries = resilience.load_quarantine(out_dir)
    assert [e["index"] for e in entries] == [0]
    assert "retry_device" not in entries[0]


def test_recomputed_clean_shard_clears_stale_quarantine(tmp_path):
    cases = _cases(8, seed=14)
    out_dir = str(tmp_path / "sweep")
    with faults.inject("nan:shard_result:1"):
        run_full(toy_full, cases, out_dir, quarantine_retry=False)
    assert [e["index"] for e in resilience.load_quarantine(out_dir)] == [0]
    faults.truncate_file(os.path.join(out_dir, "shard_0000.npz"))
    out = run_full(toy_full, cases, out_dir, quarantine_retry=False)
    assert resilience.load_quarantine(out_dir) == []
    assert np.isfinite(out["X0"]).all()


def test_status_escalation_ladder_records_each_rung(tmp_path, monkeypatch,
                                                    log_path):
    """A row whose status word carries DRAG_CAP_HIT climbs the ladder:
    under ``f64_cpu`` the retol rung (4 x the iteration budget) leaves
    it flagged, the f64 rung on the CPU clears it; the entry records
    each rung's device and its cleared and persistent bits, and a
    SEVERE row nothing clears dumps the flight ring."""
    from raft_tpu_torch.utils import config, health

    def capped(Hs, Tp):
        out = toy_full(Hs, Tp)
        scale = int(config.get("ITER_SCALE"))
        f64 = config.get("DTYPE") == "float64"
        hard = (Hs > 5.0).to(torch.int32)
        still = hard * int(not f64) | (Hs > 7.0).to(torch.int32)
        status = health.set_bit(torch.zeros_like(hard),
                                health.DRAG_CAP_HIT,
                                hard if scale == 1 else still)
        return dict(out, status=status)

    monkeypatch.setenv("RAFT_TPU_ESCALATE", "f64_cpu")
    monkeypatch.setenv("RAFT_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    cases = dict(Hs=np.array([2.0, 6.0, 3.0, 7.5]), Tp=np.full(4, 9.0))
    out_dir = str(tmp_path / "sweep")
    out = run_full(capped, cases, out_dir,
                   out_keys=("PSD", "X0", "status"))
    entries = {e["index"]: e for e in resilience.load_quarantine(out_dir)}
    assert sorted(entries) == [1, 3]
    cap = health.DRAG_CAP_HIT
    e1, e3 = entries[1], entries[3]
    assert e1["resolved"] and e1["escalation"]["resolved_by"] == "f64_cpu"
    assert e1["escalation"]["rungs_tried"] == ["retol", "f64_cpu"]
    assert [(r["rung"], r["device"], r["cleared"], r["persistent"])
            for r in e1["escalation"]["rungs"]] == [
        ("retol", "cpu", 0, cap), ("f64_cpu", "cpu", cap, 0)]
    assert not e3["resolved"] and e3["status_after"] == cap
    assert e3["reason_after"] == "DRAG_CAP_HIT"
    assert out["status"].tolist() == [0, 0, 0, cap]
    assert [e["rung"] for e in _events(log_path, "shard_escalate")] \
        == ["retol", "f64_cpu", "retol", "f64_cpu"]
    assert any(f.startswith("flight-") and "quarantine-severe" in f
               for f in os.listdir(tmp_path / "flight"))
    with open(os.path.join(out_dir, "metrics.json")) as f:
        c = json.load(f)["counters"]
    assert c["escalation_rungs"] == 4 and c["escalations_resolved"] == 1
    assert c["rows_flagged"] == 1 and c["rows_quarantined"] == 1


# --------------------------------------------- input validation satellites


def test_batch_not_divisible_by_dp_autopads(log_path):
    h = np.ones(3)
    out = sweep_cases(toy_case, h, h, h, mesh=mesh2())
    assert out["X0"].shape == (3,)
    out = sweep_cases_full(toy_full, dict(Hs=h, Tp=h), mesh=mesh2())
    assert out["X0"].shape == (3,)
    pads = _events(log_path, "dp_autopad")
    assert [(e["rows"], e["pad"], e["dp"]) for e in pads] == [(3, 1, 2)] * 2


def test_ragged_case_dict_rejected(tmp_path):
    ragged = dict(Hs=np.ones(8), Tp=np.ones(6))
    with pytest.raises(ValueError, match="ragged"):
        run_full(toy_full, ragged, tmp_path / "sweep")
    with pytest.raises(ValueError, match="ragged"):
        sweep_cases_full(toy_full, ragged, mesh=mesh2())


def test_legacy_checkpointed_driver_shares_runtime(tmp_path):
    rng = np.random.default_rng(12)
    h, t, b = rng.random(10), rng.random(10) + 8, rng.random(10)
    out_dir = str(tmp_path / "sweep")
    out1 = run_sweep_checkpointed(toy_case, h, t, b, out_dir, shard_size=4,
                                  mesh=mesh2())
    np.testing.assert_allclose(out1["X0"], h + t + b)
    assert os.path.exists(os.path.join(out_dir, "manifest.json"))
    faults.truncate_file(os.path.join(out_dir, "shard_0002.npz"))
    out2 = run_sweep_checkpointed(toy_case, h, t, b, out_dir, shard_size=4,
                                  mesh=mesh2())
    for k in out1:
        assert np.array_equal(out1[k], out2[k])
    with pytest.raises(resilience.ManifestMismatchError):
        run_sweep_checkpointed(toy_case, h + 1, t, b, out_dir, shard_size=4,
                               mesh=mesh2())


# ---------------------------------------------------- no backend fallback


def test_unhealthy_probe_raises_never_falls_back(tmp_path, log_path,
                                                 monkeypatch):
    """The reference pins the CPU when the accelerator probe fails; the
    port raises with the probe's words, with or without a card, and
    runs nothing."""
    from raft_tpu_torch.parallel import sweep as tsweep

    with faults.inject("unhealthy:backend_probe:1"):
        with pytest.raises(RuntimeError, match="health probe") as ei:
            resilience.resolve_mesh(tsweep.make_mesh)
    assert "unhealthy:backend_probe" in str(ei.value)
    assert 'device=\\"cpu\\"' in str(ei.value) or 'device="cpu"' in str(
        ei.value)
    evs = _events(log_path, "backend_fallback_failed")
    assert len(evs) == 1 and "no CPU fallback" in evs[0]["reason"]
    assert not _events(log_path, "backend_fallback")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_full(toy_full, _cases(4, seed=13), tmp_path / "sweep", mesh=None)
    assert not os.path.exists(tmp_path / "sweep")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep_cases_full(toy_full, _cases(4, seed=13))
    # an explicit CPU mesh runs
    assert resilience.resolve_mesh(tsweep.make_mesh, mesh2()) is not None


def test_fabric_branch(tmp_path, log_path, monkeypatch):
    """FABRIC_WORKERS > 1 runs an unstamped sweep serially with a
    ``fabric_unavailable`` event; a stamped compute reaches
    ``fabric.run_fabric`` with its entry spec, the sweep's arguments and
    the device of the caller's mesh (the card when the mesh is left to
    the workers)."""
    from raft_tpu_torch.parallel import fabric

    monkeypatch.setenv("RAFT_TPU_FABRIC_WORKERS", "3")
    cases = _cases(4, seed=16)
    out = run_full(toy_full, cases, tmp_path / "serial")
    np.testing.assert_array_equal(out["X0"], cases["Hs"] - cases["Tp"])
    assert len(_events(log_path, "fabric_unavailable")) == 1

    def stamped(Hs, Tp):
        return toy_full(Hs, Tp)

    stamped._raft_fabric_entry = {"entry": "mod:fn", "kwargs": {"a": 1}}
    compute = full_compute(stamped, out_keys=("X0",), shard_freq=True)
    assert compute._raft_fabric_entry["kwargs"] == {
        "a": 1, "out_keys": ["X0"], "shard_freq": True}
    calls = []

    def fake_run_fabric(out_dir, **kw):
        calls.append(dict(kw, out_dir=out_dir))
        return {"X0": np.zeros(4)}

    monkeypatch.setattr(fabric, "run_fabric", fake_run_fabric)
    got = resilience.run_checkpointed(compute, cases, str(tmp_path / "fab"),
                                      4, mesh2(), ("X0",), max_retries=5)
    np.testing.assert_array_equal(got["X0"], np.zeros(4))
    (call,) = calls
    assert call["workers"] == 3 and call["entry"] == "mod:fn"
    assert call["entry_kwargs"] == {"a": 1, "out_keys": ["X0"],
                                    "shard_freq": True}
    assert call["device"] == "cpu" and call["shard_size"] == 4
    assert call["out_keys"] == ("X0",) and call["max_retries"] == 5
    assert call["cases"] is not cases and set(call["cases"]) == {"Hs", "Tp"}
    assert not os.path.exists(tmp_path / "fab" / "manifest.json")
    assert len(_events(log_path, "fabric_unavailable")) == 1
    # run_full leaves mesh=None to the workers: no probe, the card
    def no_probe(*a, **k):
        raise AssertionError("the coordinator probed the device")

    monkeypatch.setattr(resilience, "resolve_mesh", no_probe)
    stamped._raft_fabric_entry = {"entry": "mod:fn", "kwargs": {}}
    run_full(stamped, cases, tmp_path / "fab2", mesh=None)
    assert calls[-1]["device"] == "cuda"


def test_profile_writes_a_chrome_trace(tmp_path, monkeypatch, log_path):
    monkeypatch.setenv("RAFT_TPU_PROFILE", str(tmp_path / "prof"))
    run_full(toy_full, _cases(4, seed=17), tmp_path / "sweep")
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sweep", "shard", "shard_attempt"} <= names
    assert [e["event"] for e in _events(log_path)
            if e["event"].startswith("profile_")] == [
        "profile_start", "profile_stop"]


# ------------------------------------------------------------- structlog


def test_log_event_survives_non_serializable_payload(tmp_path, monkeypatch):
    p = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)

    class Opaque:
        def __repr__(self):
            return "<opaque>"

    log_event("weird_payload", obj=Opaque(), arr_dtype=np.dtype("f8"),
              exc=ValueError("boom"), t=torch.ones(2))
    (rec,) = _events(p, "weird_payload")
    assert rec["obj"] == "<opaque>"
    assert rec["exc"] == "boom"


# ------------------------------------------------------------ fault specs


def test_fault_spec_parsing_and_counts():
    with faults.inject("transient:somewhere:2"):
        assert faults.take("transient", "somewhere")
        assert faults.take("transient", "somewhere")
        assert not faults.take("transient", "somewhere")
    assert not faults.take("transient", "somewhere")
    with pytest.raises(ValueError):
        faults.inject("justakind")


def test_fault_env_var_arming(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULTS", "nan:envsite:1")
    assert faults.take("nan", "envsite")
    assert not faults.take("nan", "envsite")
    monkeypatch.setenv("RAFT_TPU_FAULTS", "")
    assert not faults.take("nan", "envsite")

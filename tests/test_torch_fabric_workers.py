"""The port's sweep fabric with real worker subprocesses on the CPU
(``raft_tpu_torch/parallel/fabric.py``; the ledger alone is in
``tests/test_torch_fabric.py``).

* ``RAFT_TPU_FABRIC_WORKERS=2`` sends the checkpointed sweep of a
  stamped spar case evaluator (the port's, the demo entry's) to two
  workers on the rows of ``golden_sweep_cases_spar.npz``: bit-identical
  to its serial sweep, within 1e-10 x max of the JAX case evaluator's
  outputs there with ``status`` and ``n_iter_drag`` bit-equal; one run
  id, the workers' shard spans inside the coordinator's sweep trace, the
  per-worker report table; again with worker 0 SIGKILLed at its first
  claim (``worker_kill:worker_shard``): its lease is stolen, the bits
  unchanged;
* a stamped toy compute routed the same way; every worker dead raises
  ``FabricError``;
* a resume after a serial run adopts the done shards; a fabric resume
  keeps the quarantine audit.

The toy entries live in this file and reach the workers by the
``path.py:callable`` form; every subprocess wait has a timeout.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch.parallel import fabric, resilience
from raft_tpu_torch.parallel.sweep import (
    full_compute, make_mesh, run_sweep_checkpointed,
    run_sweep_checkpointed_full)
from raft_tpu_torch.utils import faults

HERE = os.path.abspath(__file__)
FIX = os.path.join(os.path.dirname(HERE), "fixtures", "torch_port")
KEYS = ("PSD", "X0", "status", "n_iter_drag")


def _toy_full(Hs, Tp):
    """Cheap deterministic evaluator: case rows -> dict of outputs."""
    return {"PSD": torch.stack([Hs, Tp, Hs * Tp], -1), "X0": Hs - Tp}


def toy_entry(out_keys=("PSD", "X0"), **_):
    """The toy evaluator through the shared full_compute path."""
    return full_compute(_toy_full, out_keys=tuple(out_keys))


def _wait_ready(gate_dir, n_workers, timeout_s=120.0):
    """Block until ``n_workers`` workers of ``gate_dir``'s ledger are
    past start-up (their status beyond ``starting``)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        states = fabric.Ledger(gate_dir, 0).worker_states().values()
        if sum(st.get("state") not in (None, "starting")
               for st in states) >= n_workers:
            return
        time.sleep(0.05)


def gated_demo_entry(gate_dir, n_workers=2, **kw):
    """The spar demo entry whose shards wait until ``n_workers`` workers
    of ``gate_dir``'s ledger are up: each then scans before any shard
    completes, so each claims one (the kill drill always lands)."""
    res = fabric.demo_entry(**kw)
    inner = res["compute"]

    def compute(chunk, mesh):
        _wait_ready(gate_dir, n_workers)
        return inner(chunk, mesh)

    return dict(res, compute=compute)


def stamped_toy_evaluator():
    """The toy evaluator carrying the fabric entry stamp."""
    def evaluate(Hs, Tp):
        return _toy_full(Hs, Tp)

    evaluate._raft_fabric_entry = {"entry": f"{HERE}:toy_entry",
                                   "kwargs": {}}
    return evaluate


def _cases(n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(Hs=2.0 + 6.0 * rng.random(n), Tp=8.0 + 8.0 * rng.random(n))


def _events(path, name=None):
    evs = []
    paths = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
             if os.path.isdir(path) else [path])
    for p in paths:
        with open(p) as f:
            evs += [json.loads(line) for line in f if line.strip()]
    return [e for e in evs if name is None or e["event"] == name]


@pytest.fixture
def log_path(tmp_path, monkeypatch):
    p = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)
    return p


@pytest.fixture
def fabric_env(monkeypatch):
    """A snappy poll for the workers (the lease TTL stays 30 s: a busy
    host must not expire a live worker's lease)."""
    monkeypatch.setenv("RAFT_TPU_FABRIC_POLL_S", "0.1")


def cpu_mesh():
    return make_mesh(device="cpu")


@pytest.mark.parametrize("killed", [False, True], ids=["clean", "killed"])
def test_stamped_spar_sweep_on_two_workers(killed, tmp_path, fabric_env,
                                           monkeypatch):
    """RAFT_TPU_FABRIC_WORKERS=2 sends the checkpointed sweep of a
    stamped spar case evaluator to two workers: bit-identical to its
    serial sweep, within 1e-10 x max of the JAX case evaluator's
    outputs, status and n_iter_drag bit-equal; with worker 0 killed at
    its first claim the survivor steals its lease, the bits unchanged."""
    from raft_tpu_torch.api import make_case_evaluator
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.obs.report import collect_spans, render_report

    logs = str(tmp_path / "logs") + os.sep
    monkeypatch.setenv("RAFT_TPU_LOG", logs)
    gold = dict(np.load(os.path.join(FIX, "golden_sweep_cases_spar.npz")))
    sea = [gold[k] for k in ("Hs", "Tp", "beta")]
    ev = make_case_evaluator(Model(fabric.DEMO_DESIGN), device="cpu")
    serial = run_sweep_checkpointed(ev, *sea, str(tmp_path / "serial"),
                                    shard_size=2, mesh=cpu_mesh(),
                                    out_keys=KEYS)
    out_dir = str(tmp_path / "fab")
    if killed:
        # worker_kill reaches worker 0 (RAFT_TPU_FABRIC_FAULT_WORKER)
        # only; its lease outlives it by the TTL, then worker 1 steals it
        ev._raft_fabric_entry = {"entry": f"{HERE}:gated_demo_entry",
                                 "kwargs": {"gate_dir": out_dir}}
        monkeypatch.setenv("RAFT_TPU_FAULTS", "worker_kill:worker_shard:1")
        monkeypatch.setenv("RAFT_TPU_FABRIC_TTL_S", "2.0")
    else:
        ev._raft_fabric_entry = {
            "entry": "raft_tpu_torch.parallel.fabric:demo_entry",
            "kwargs": {}}
    monkeypatch.setenv("RAFT_TPU_FABRIC_WORKERS", "2")
    out = run_sweep_checkpointed(ev, *sea, out_dir, shard_size=2,
                                 mesh=cpu_mesh(), out_keys=KEYS)
    for k in KEYS:
        assert np.array_equal(out[k], serial[k]), k
    for k in ("status", "n_iter_drag"):
        np.testing.assert_array_equal(out[k], gold[k])
    for k in ("PSD", "X0"):
        scale = np.max(np.abs(gold[k]))
        assert np.max(np.abs(out[k] - gold[k])) <= 1e-10 * scale, k
    assert fabric.load_spec(out_dir)["device"] == "cpu"

    evs = _events(logs)
    assert len({e["run_id"] for e in evs}) == 1
    starts = [e for e in evs if e["event"] == "fabric_worker_start"]
    assert {e["worker"] for e in starts} == {"w0", "w1"}
    assert all(e["device"] == "cpu" and e["startup_s"] > 0 for e in starts)
    exits = {e["worker"]: e["returncode"] for e in evs
             if e["event"] == "fabric_worker_exit"}
    with open(os.path.join(out_dir, "manifest.json")) as f:
        man = json.load(f)
    assert all(man["shards"][str(s)]["status"] == "done" for s in range(4))
    assert man["metrics"]["programs"] == []     # no kernel on the CPU
    steals = [e for e in evs if e["event"] == "shard_steal"]
    if killed:
        assert exits["w0"] != 0 and exits["w1"] == 0   # the kill hit w0
        assert len(steals) == 1 and steals[0]["from_worker"] == "w0" \
            and steals[0]["worker"] == "w1" and steals[0]["reason"] in (
                "expired", "straggler", "holder_stale")
        stolen = str(steals[0]["shard"])
        assert man["shards"][stolen]["worker"] == "w1"
        assert man["shards"][stolen]["attempt"] == 2
        return
    assert exits == {"w0": 0, "w1": 0} and not steals
    assert man["metrics"]["counters"]["shards_done"] == 4
    # the workers' shard spans join the coordinator's sweep trace
    spans, _ = collect_spans(evs)
    sweep = [s for s in spans if s["name"] == "sweep"
             and s["pid"] == os.getpid()][-1]
    shards = [s for s in spans if s["name"] == "shard"
              and s["pid"] != os.getpid()]
    assert len(shards) == 4
    assert {s["trace_id"] for s in shards} == {sweep["trace_id"]}
    assert {s["parent_id"] for s in shards} == {sweep["span_id"]}
    assert "fabric workers" in render_report(evs)


def test_fabric_workers_env_routes_stamped_compute(tmp_path, log_path,
                                                   fabric_env, monkeypatch):
    cases = _cases(12, seed=4)
    serial = run_sweep_checkpointed_full(
        _toy_full, cases, str(tmp_path / "serial"), shard_size=4,
        mesh=cpu_mesh())
    monkeypatch.setenv("RAFT_TPU_FABRIC_WORKERS", "2")
    out = run_sweep_checkpointed_full(
        stamped_toy_evaluator(), cases, str(tmp_path / "fab"),
        shard_size=4, mesh=cpu_mesh())
    for k in serial:
        assert np.array_equal(serial[k], out[k]), k
    assert len(_events(log_path, "fabric_worker_spawn")) == 2
    spec = fabric.load_spec(str(tmp_path / "fab"))
    assert spec["device"] == "cpu"
    assert spec["entry_kwargs"] == {"out_keys": ["PSD", "X0"],
                                    "shard_freq": False}
    assert not _events(log_path, "fabric_unavailable")


def test_all_workers_dead_raises_fabric_error(tmp_path, fabric_env,
                                              monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULTS", "worker_kill:worker_shard:1")
    with pytest.raises(fabric.FabricError, match="workers exited"):
        fabric.run_fabric(
            str(tmp_path / "fab"), 1, f"{HERE}:toy_entry",
            cases=_cases(8, seed=5), out_keys=("PSD", "X0"), shard_size=4,
            device="cpu")


def test_resume_after_serial_run_skips_done_shards(tmp_path, log_path,
                                                   fabric_env):
    cases = _cases(8, seed=6)
    out_dir = str(tmp_path / "fab")
    serial = run_sweep_checkpointed_full(
        _toy_full, cases, out_dir, shard_size=4, mesh=cpu_mesh())
    out = fabric.run_fabric(
        out_dir, 1, f"{HERE}:toy_entry", cases=cases,
        out_keys=("PSD", "X0"), shard_size=4, device="cpu")
    for k in serial:
        assert np.array_equal(serial[k], out[k])
    resumes = _events(log_path, "shard_resume")
    assert sorted(e["shard"] for e in resumes) == [0, 1]
    assert not _events(log_path, "shard_claim")
    with pytest.raises(resilience.ManifestMismatchError):
        fabric.init_sweep(out_dir, f"{HERE}:toy_entry",
                          dict(cases, Hs=cases["Hs"] + 1.0),
                          ("PSD", "X0"), 4)


def test_fabric_resume_keeps_quarantine_audit(tmp_path, fabric_env):
    cases = _cases(8, seed=7)
    out_dir = str(tmp_path / "fab")
    with faults.inject("nan:shard_result:1"):
        run_sweep_checkpointed_full(
            _toy_full, cases, out_dir, shard_size=4, mesh=cpu_mesh(),
            quarantine_retry=False)
    before = resilience.load_quarantine(out_dir)
    assert [e["index"] for e in before] == [0]
    out = fabric.run_fabric(
        out_dir, 1, f"{HERE}:toy_entry", cases=cases,
        out_keys=("PSD", "X0"), shard_size=4, device="cpu")
    assert np.isnan(out["X0"][0])            # the bad row is still bad
    assert resilience.load_quarantine(out_dir) == before

"""The port's sweep-fabric ledger (``raft_tpu_torch/parallel/fabric.py``),
in-process, no worker subprocess (those are in
``tests/test_torch_fabric_workers.py``).

* claim exclusivity and release; a steal happens exactly once; the
  expired, stale-status and straggler-p95 rules — every expiry driven
  through ``Ledger.stealable(now=...)`` and lease records rewritten with
  old timestamps, never by sleeping against a short TTL;
* the silenced renewer (``lease_expire:lease_renew``);
* ``resolve_entry``'s ``module:callable`` and ``path.py:callable``
  forms; ``init_sweep``'s spec, manifest and case file; a spec with an
  AOT ``warmup`` carried for the workers, a worker under
  ``RAFT_TPU_DIST`` refused (A15(g));
* format parity with the JAX package: a ledger laid out by
  ``raft_tpu.parallel.fabric`` is read by the port's ``Ledger`` with the
  same ``summary()``, and the other way round;
* the kernel ledger (``aot/bank.py`` ``ledger_summary`` /
  ``merge_ledgers``), merged by the reference's rules.
"""

import json
import os
import time

import numpy as np
import pytest

from raft_tpu_torch.aot import bank
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.ops import linsolve
from raft_tpu_torch.parallel import fabric, resilience
from raft_tpu_torch.utils import faults

HERE = os.path.abspath(__file__)


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


def _rewrite_lease(out_dir, shard, **fields):
    path = fabric._lease_path(str(out_dir), shard)
    with open(path) as f:
        rec = json.load(f)
    rec.update(fields)
    with open(path, "w") as f:
        json.dump(rec, f)


# ------------------------------------------------------------- toy entries


def toy_entry(out_keys=("X0",), scale=1.0, **_):
    """A compute closure (resolve_entry wraps it into {'compute': ...})."""
    def compute(chunk, mesh):
        return {"X0": np.asarray(chunk["Hs"]) * float(scale)}

    return compute


def toy_with_cases_entry(n=6, **_):
    return {"compute": toy_entry(), "cases": _cases(int(n), seed=3)}


def not_an_entry(**_):
    return {"nope": 1}


# ------------------------------------------------------------------ ledger


def test_claim_is_exclusive_release_reopens(tmp_path, log_path):
    led_a = fabric.Ledger(str(tmp_path), 4, worker_id="a")
    led_b = fabric.Ledger(str(tmp_path), 4, worker_id="b")
    assert led_a.claim(0)
    assert not led_b.claim(0)          # O_EXCL: one claimant wins
    rec, _ = led_b.read_lease(0)
    assert rec["worker"] == "a" and rec["attempt"] == 1
    assert rec["ttl_s"] == 30.0        # RAFT_TPU_FABRIC_TTL_S default
    assert led_b.claim(1)              # other shards stay claimable
    led_b.release(0)                   # not b's lease: must be a no-op
    assert led_a.read_lease(0)[0]["worker"] == "a"
    led_a.release(0)
    assert led_a.read_lease(0) == (None, None)
    assert led_b.claim(0)              # released -> claimable again
    claims = _events(log_path, "shard_claim")
    assert [(e["shard"], e["worker"]) for e in claims] == [
        (0, "a"), (1, "b"), (0, "b")]


def test_expired_lease_is_stolen_exactly_once(tmp_path, log_path):
    led_a = fabric.Ledger(str(tmp_path), 2, worker_id="a")
    led_b = fabric.Ledger(str(tmp_path), 2, worker_id="b")
    led_c = fabric.Ledger(str(tmp_path), 2, worker_id="c")
    assert led_a.claim(0)
    now = time.time()
    assert led_b.stealable(0, now=now)[0] is None   # fresh lease
    # judged past its TTL: expired, whoever holds it
    reason, age, holder, attempt = led_b.stealable(0, now=now + 31.0)
    assert reason == "expired" and holder == "a" and attempt == 1
    assert age > 30.0
    # a renewal refreshes the clock: the same instant is no longer past it
    _rewrite_lease(tmp_path, 0, renewed_t=now - 40.0)
    assert led_b.stealable(0, now=now)[0] == "expired"
    assert led_a.renew(0)
    assert led_b.stealable(0, now=time.time())[0] is None
    _rewrite_lease(tmp_path, 0, renewed_t=now - 40.0)
    reason, age, holder, attempt = led_b.stealable(0, now=now)
    assert reason == "expired"
    # exactly one stealer wins the rename
    won_b = led_b.steal(0, reason, age, holder)
    won_c = led_c.steal(0, reason, age, holder)
    assert won_b and not won_c
    assert led_c.claim(0, attempt=attempt + 1)
    assert led_c.read_lease(0)[0]["attempt"] == 2
    assert not led_a.renew(0)          # the lease is c's now
    evs = _events(log_path, "shard_steal")
    assert len(evs) == 1 and evs[0]["from_worker"] == "a" \
        and evs[0]["reason"] == "expired" and evs[0]["worker"] == "b"
    assert os.listdir(os.path.dirname(fabric._lease_path(
        str(tmp_path), 0))) == ["shard_0000.json"]   # no grave left


def test_stale_status_and_straggler_p95_stealability(tmp_path, monkeypatch):
    metrics.reset()   # earlier sweeps' shard walls must not arm the rule
    monkeypatch.setenv("RAFT_TPU_FABRIC_STEAL_MULT", "4.0")
    led_a = fabric.Ledger(str(tmp_path), 2, worker_id="a")
    led_b = fabric.Ledger(str(tmp_path), 2, worker_id="b")
    assert led_a.claim(0)
    led_a.write_worker_status("running", held=[0])
    st_path = fabric._worker_path(str(tmp_path), "a")
    now = os.path.getmtime(st_path)
    # the lease is fresh at `now`, but the holder's status file is judged
    # 40 s later with no update: stale, within the lease's own TTL
    _rewrite_lease(tmp_path, 0, renewed_t=now + 39.0)
    reason, age, holder, _ = led_b.stealable(0, now=now + 40.0)
    assert reason == "holder_stale" and holder == "a" and age >= 40.0

    # straggler: renewed and heartbeating, but claimed long ago
    _rewrite_lease(tmp_path, 0, claimed_t=now - 5.0, renewed_t=now)
    assert led_b.stealable(0, now=now)[0] is None   # < MIN_WALL_SAMPLES
    h = metrics.Histogram("shard_wall_s")
    for _ in range(fabric.MIN_WALL_SAMPLES):
        h.observe(0.05)                     # a typical shard: 50 ms
    with open(fabric._worker_path(str(tmp_path), "b"), "w") as f:
        json.dump({"worker": "b", "shard_wall_s": h.state()}, f)
    os.utime(st_path, (now, now))
    reason, age, holder, _ = led_b.stealable(0, now=now)
    assert reason == "straggler" and holder == "a"
    assert abs(age - 5.0) < 1e-6
    # the pooled p95 x the multiplier is the line: below it, no steal
    monkeypatch.setenv("RAFT_TPU_FABRIC_STEAL_MULT", "1000.0")
    assert led_b.stealable(0, now=now)[0] is None
    # a pooled histogram passed in is used as is (one read per pass)
    assert led_b.stealable(0, now=now, pooled=metrics.Histogram("e"))[0] \
        is None


def test_lease_expire_fault_silences_renewer(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FABRIC_TTL_S", "0.3")
    led = fabric.Ledger(str(tmp_path), 1, worker_id="a")
    led.write_worker_status("running")
    assert led.claim(0)
    silenced = [False]
    renewer = fabric._Renewer(led, 0, silenced)
    with faults.inject("lease_expire:lease_renew:1"):
        renewer.start()
        deadline = time.time() + 30.0
        while not silenced[0] and time.time() < deadline:
            time.sleep(0.02)
        renewer.stop()
    assert silenced[0]
    rec, _ = led.read_lease(0)
    # renewals stopped: judged past the TTL, the held lease is stealable
    reason = fabric.Ledger(str(tmp_path), 1, worker_id="b").stealable(
        0, now=float(rec["renewed_t"]) + 1.0)[0]
    assert reason in ("expired", "holder_stale")


# ------------------------------------------------------------- entry specs


def test_resolve_entry_module_and_file_forms():
    res = fabric.resolve_entry(f"{HERE}:toy_with_cases_entry", {"n": 6})
    assert callable(res["compute"]) and len(res["cases"]["Hs"]) == 6
    res2 = fabric.resolve_entry(f"{HERE}:toy_entry", {"scale": 2.0})
    out = res2["compute"]({"Hs": np.array([1.0, 2.0])}, None)
    np.testing.assert_array_equal(out["X0"], [2.0, 4.0])
    # the module form, through the package's own default entry
    res3 = fabric.resolve_entry(
        "raft_tpu_torch.parallel.fabric:demo_entry",
        {"n": 5, "seed": 1, "device": "cpu"})
    assert callable(res3["compute"])
    assert sorted(res3["cases"]) == ["Hs", "Tp", "beta"]
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(res3["cases"]["Hs"],
                                  rng.uniform(2.0, 8.0, 5))
    with pytest.raises(ValueError, match="module:callable"):
        fabric.resolve_entry("no_colon_here")
    with pytest.raises(ValueError, match="compute"):
        fabric.resolve_entry(f"{HERE}:not_an_entry")


def test_init_sweep_spec_manifest_and_refusals(tmp_path, log_path,
                                               monkeypatch):
    cases = _cases(10, seed=1)
    out_dir = str(tmp_path / "fab")
    monkeypatch.setenv("RAFT_TPU_DTYPE", "f64")
    spec = fabric.init_sweep(out_dir, f"{HERE}:toy_entry", cases, ("X0",),
                             4, entry_kwargs={"scale": 3.0}, device="cpu")
    assert spec == fabric.load_spec(out_dir)
    assert spec["n_shards"] == 3 and spec["n_cases"] == 10
    assert spec["device"] == "cpu" and spec["dtype"] == "float64"
    assert spec["entry_kwargs"] == {"scale": 3.0} and spec["warmup"] is None
    assert spec["out_keys"] == ["X0"] and spec["shard_size"] == 4
    loaded = fabric.load_cases(out_dir)
    for k in cases:
        np.testing.assert_array_equal(loaded[k], cases[k])
    with open(os.path.join(out_dir, "manifest.json")) as f:
        man = json.load(f)
    assert man["n_shards"] == 3
    assert man["fingerprint"] == resilience.compute_fingerprint(
        cases, ("X0",), 4, mesh=None)
    assert sorted(os.listdir(fabric.fabric_dir(out_dir))) == [
        "cases.npz", "done", "fabric.json", "leases", "workers"]
    (ev,) = _events(log_path, "fabric_init")
    assert ev["n_shards"] == 3 and ev["entry"].endswith(":toy_entry")
    # re-initialising with the same inputs resumes; changed inputs refuse
    fabric.init_sweep(out_dir, f"{HERE}:toy_entry", cases, ("X0",), 4)
    with pytest.raises(resilience.ManifestMismatchError):
        fabric.init_sweep(out_dir, f"{HERE}:toy_entry",
                          dict(cases, Hs=cases["Hs"] + 1.0), ("X0",), 4)
    # an AOT warmup spec is carried in the spec for the workers, as the
    # reference's init_sweep carries it
    wspec = fabric.init_sweep(str(tmp_path / "w"), f"{HERE}:toy_entry",
                              cases, ("X0",), 4, warmup={"sizes": [4]},
                              device="cpu")
    assert wspec["warmup"] == {"sizes": [4]}
    assert fabric.load_spec(str(tmp_path / "w"))["warmup"] == {"sizes": [4]}
    with pytest.raises(ValueError, match="device"):
        fabric.init_sweep(str(tmp_path / "d"), f"{HERE}:toy_entry", cases,
                          ("X0",), 4, device="tpu")
    # a worker under the reference's multi-host variables refuses (A15(g))
    monkeypatch.setenv("RAFT_TPU_DIST", "1")
    with pytest.raises(NotImplementedError, match=r"A15\(g\)"):
        fabric.Worker(out_dir, worker_id="x")._setup_runtime(spec)
    monkeypatch.delenv("RAFT_TPU_DIST")
    mesh = fabric.Worker(out_dir, worker_id="x")._setup_runtime(spec)
    assert [str(d) for d in mesh.devices.flat] == ["cpu"]


def test_worker_device_env_and_fault_forwarding(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert fabric._worker_device_env(1, 2) == {"CUDA_VISIBLE_DEVICES": "1,3"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert fabric._worker_device_env(1, 2) == {}   # one card: both on it


def test_status_cli_prints_the_summary(tmp_path, capsys):
    out_dir = str(tmp_path / "fab")
    fabric.init_sweep(out_dir, f"{HERE}:toy_entry", _cases(8), ("X0",), 4,
                      device="cpu")
    fabric.Ledger(out_dir, 2, worker_id="w0").claim(1)
    assert fabric.main(["status", "--out-dir", out_dir]) == 0
    summ = json.loads(capsys.readouterr().out)
    assert summ["n_shards"] == 2 and summ["remaining"] == 2
    assert summ["leased"]["1"]["worker"] == "w0"


# ------------------------------------------------ format parity with JAX


def _lay_out(fab, out_dir, cases):
    """init_sweep, one claimed lease, one done record and one worker
    status through ``fab`` (either package's fabric module)."""
    fab.init_sweep(out_dir, "mod:fn", cases, ("PSD", "X0"), 4)
    w0 = fab.Ledger(out_dir, 3, worker_id="w0")
    w1 = fab.Ledger(out_dir, 3, worker_id="w1")
    assert w0.claim(0) and w1.claim(2, attempt=2)
    w0.write_done(1, wall_s=0.5, rows=4, attempt=1, quarantined=0,
                  flagged=0, entries=[])
    w0.write_worker_status("running", held=[0], shards_done=1)
    return w0


def _no_ages(summ):
    return dict(summ, leased={s: {k: v for k, v in r.items()
                                  if k != "age_s"}
                              for s, r in summ["leased"].items()})


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ledger_format_parity_with_jax(tmp_path, writer):
    from raft_tpu.parallel import fabric as jfabric

    out_dir = str(tmp_path / writer)
    lay = jfabric if writer == "jax" else fabric
    _lay_out(lay, out_dir, _cases(12, seed=9))
    port = fabric.Ledger(out_dir, 3).summary()
    ref = jfabric.Ledger(out_dir, 3).summary()
    assert _no_ages(port) == _no_ages(ref)
    assert port["done"] == 1 and port["remaining"] == 2
    assert sorted(port["leased"]) == [0, 2]
    assert port["leased"][2] == {"worker": "w1", "attempt": 2,
                                 "age_s": port["leased"][2]["age_s"]}
    assert port["workers"]["w0"] == {"state": "running", "held": [0],
                                     "shards_done": 1, "pid": os.getpid()}
    for s in (0, 2):
        assert abs(port["leased"][s]["age_s"]
                   - ref["leased"][s]["age_s"]) < 5.0
    # each package reads the other's done record and lease verbatim
    assert fabric.Ledger(out_dir, 3).read_done(1) == \
        jfabric.Ledger(out_dir, 3).read_done(1)
    assert fabric.Ledger(out_dir, 3).read_lease(0)[0] == \
        jfabric.Ledger(out_dir, 3).read_lease(0)[0]
    # the steal rules judge the other package's lease the same way
    now = time.time() + 100.0
    assert fabric.Ledger(out_dir, 3, worker_id="x").stealable(
        0, now=now)[:1] == ("expired",)
    # the manifest's strict fingerprint is the same in both packages
    fp = resilience.compute_fingerprint(fabric.load_cases(out_dir),
                                        ["PSD", "X0"], 4, mesh=None)
    resilience.validate_manifest(out_dir, fp)


# ------------------------------------------------------------ kernel ledger


def test_kernel_ledger_rows_and_fleet_merge(monkeypatch):
    from raft_tpu.aot import bank as jbank

    for name, n in (("KERNEL_LAUNCHES", 7), ("ADJ_KERNEL_LAUNCHES", 3),
                    ("ROW_KERNEL_LAUNCHES", 4),
                    ("ROW_ADJ_KERNEL_LAUNCHES", 1)):
        monkeypatch.setattr(linsolve, name, n)
    rows = bank.ledger_summary()
    assert rows == [
        {"key": "ge_solve", "kind": "cuda", "dispatches": 4},
        {"key": "ge_solve_adj", "kind": "cuda", "dispatches": 2},
        {"key": "ge_solve_rows", "kind": "cuda", "dispatches": 3},
        {"key": "ge_solve_rows_adj", "kind": "cuda", "dispatches": 1}]
    monkeypatch.setattr(linsolve, "ROW_ADJ_KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(linsolve, "ADJ_KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(linsolve, "ROW_KERNEL_LAUNCHES", 0)
    assert [r["key"] for r in bank.ledger_summary()] == ["ge_solve"]
    other = [{"key": "ge_solve", "kind": "cuda", "dispatches": 5},
             {"key": "x", "kind": "xla", "dispatches": 2, "wall_s": 0.5,
              "flops": 1e9}, {"bad": 1}, None]
    lists = [rows, other, None, [{"key": "ge_solve", "dispatches": "nan"}]]
    assert bank.merge_ledgers(lists) == jbank.merge_ledgers(lists)
    merged = {r["key"]: r for r in bank.merge_ledgers([rows, other])}
    assert merged["ge_solve"]["dispatches"] == 9
    assert merged["x"]["gflops_s_mean"] == 4.0
    linsolve.reset_launches()
    assert bank.ledger_summary() == []
    assert len(bank.code_fingerprint()) == 16

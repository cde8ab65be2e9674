"""Multi-process meshes of the port (``raft_tpu_torch/parallel/sweep.py``
``ensure_distributed``, meshes across ranks, the checkpointed runner's
and the fabric worker's rank 0) on the CPU: two processes of a
``torch.distributed`` job under ``gloo`` on ``tcp://127.0.0.1:<free
port>``, each a subprocess with a timeout of its own.

* ``ensure_distributed(dryrun=True)`` as the reference's
  ``tests/test_fabric.py::test_distributed_dryrun_config``: off by
  default, the parsed config and the ``distributed_init`` event, the
  reference's validation errors;
* the spar demo's sea states over dp = 2 across the ranks give the
  single-process sweep's bits on both ranks; over (dp, sp) = (1, 2)
  across the ranks, the frequency grid split between them, within
  1e-10 x max of it and identical on both ranks; the checkpointed sweep
  over dp = 2 across the ranks returns the single-process bits on both
  ranks, its shards and manifest written once, by rank 0
  (``tests/_torch_dist_child.py``);
* a (dp, sp) = (2, 2) mesh whose every sp group spans both ranks (each
  rank an entry of each dp block) holds ``golden_mesh_full_spar.npz``
  within 1e-10 x max, identical on both ranks; its checkpointed sweep,
  with an OOM and a NaN row injected where rank 0 judges, halves and
  re-solves on rank 0's orders and holds the same goldens on both
  ranks;
* a rank that dies after the join fails its peer's sweep instead of
  hanging it;
* a two-rank fabric worker (``python -m raft_tpu_torch.parallel.fabric
  worker`` under ``RAFT_TPU_DIST``) finishes the spar ``demo_entry``
  sweep with the serial sweep's bits and one claim per shard, rank 0
  alone claiming; beside another worker that holds a lease for longer
  than the ranks' collectives wait, it waits the lease out.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from raft_tpu_torch.parallel import fabric, resilience
from raft_tpu_torch.parallel import sweep as tsweep

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_dist_child.py")
TOL = 1e-10
EXACT = ("status", "n_iter_drag")
#: seconds a test waits for its ranks
WAIT_S = 240


def _events(path, name=None):
    with open(path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    return [e for e in evs if name is None or e["event"] == name]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank, port, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAFT_TPU_")}
    env.update(RAFT_TPU_DIST="1",
               RAFT_TPU_DIST_COORDINATOR=f"127.0.0.1:{port}",
               RAFT_TPU_DIST_PROCESS_ID=str(rank),
               RAFT_TPU_DIST_NUM_PROCESSES="2",
               PYTHONPATH=ROOT, **extra)
    return env


def _run_ranks(argv, envs, timeout=WAIT_S):
    """Start one process per env, wait for all (killing every one on a
    timeout) and return their (returncode, stdout, stderr)."""
    procs = [subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for env in envs]
    try:
        res = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            res.append((p.returncode, out, err))
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_distributed_dryrun_config(monkeypatch, tmp_path):
    log = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    assert tsweep.ensure_distributed(dryrun=True) is None  # off by default
    monkeypatch.setenv("RAFT_TPU_DIST", "1")
    monkeypatch.setenv("RAFT_TPU_DIST_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("RAFT_TPU_DIST_NUM_PROCESSES", "4")
    monkeypatch.setenv("RAFT_TPU_DIST_PROCESS_ID", "2")
    cfg = tsweep.ensure_distributed(dryrun=True)
    assert cfg == {"coordinator": "10.0.0.1:8476", "process_id": 2,
                   "num_processes": 4}
    (ev,) = _events(log, "distributed_init")
    assert ev["dryrun"] is True and ev["num_processes"] == 4
    assert not tsweep.dist_ready()  # a dry run touches no process group
    monkeypatch.setenv("RAFT_TPU_DIST_PROCESS_ID", "4")
    with pytest.raises(ValueError, match="out of range"):
        tsweep.ensure_distributed(dryrun=True)
    monkeypatch.setenv("RAFT_TPU_DIST_PROCESS_ID", "0")
    monkeypatch.setenv("RAFT_TPU_DIST_COORDINATOR", "noport")
    with pytest.raises(ValueError, match="host:port"):
        tsweep.ensure_distributed(dryrun=True)


def test_backend_rule():
    """gloo on the CPU; on cards nccl only where no two ranks share a
    card (NCCL refuses two ranks on one card)."""
    assert tsweep.dist_backend("cpu") == "gloo"
    a, b = ("h0", "uuid-a"), ("h0", "uuid-b")
    assert tsweep._card_backend([[a], [b]]) == "nccl"
    assert tsweep._card_backend([[a], [a]]) == "gloo"
    assert tsweep._card_backend([[a, b], [b]]) == "gloo"
    assert tsweep._card_backend([[a], []]) == "gloo"


def test_two_ranks_hold_the_single_process_sweep(tmp_path):
    sys.path.insert(0, HERE)
    import _torch_dist_child as child

    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model

    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    sweep_dir = str(tmp_path / "sweep")
    res = _run_ranks([sys.executable, CHILD],
                     [_rank_env(r, port, DIST_CHILD_OUT=outs[r],
                                DIST_CHILD_SWEEP_DIR=sweep_dir,
                                RAFT_TPU_LOG=str(tmp_path / f"{r}.jsonl"))
                      for r in (0, 1)])
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    recs = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in res]
    assert [r["rank"] for r in recs] == [0, 1]
    # each rank ran its own entry: its dp block, then its frequency slice
    assert [(e["dp"], e["rows"]) for r in recs
            for e in r["dp_entries"]] == [(0, [0, 4]), (1, [4, 8])]
    assert [(e["sp"], e["freq"]) for r in recs
            for e in r["sp_entries"]] == [(0, [0, 20]), (1, [20, 40])]
    got = [dict(np.load(p)) for p in outs]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    ev = api.make_case_evaluator(Model(child.SPAR), device="cpu")
    cases = child.demo_cases(8)
    one = tsweep.sweep_cases(ev, cases["Hs"], cases["Tp"], cases["beta"],
                             mesh=tsweep.make_mesh(device="cpu"),
                             out_keys=child.KEYS)
    for k in child.KEYS:
        np.testing.assert_array_equal(got[0]["dp_" + k], one[k], err_msg=k)
        np.testing.assert_array_equal(got[0]["ck_" + k], one[k], err_msg=k)
        a, b = got[0]["sp_" + k], one[k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            scale = float(np.max(np.abs(b)))
            assert float(np.max(np.abs(a - b))) <= TOL * scale, k
    assert sorted(os.listdir(sweep_dir)) == [
        "manifest.json", "metrics.json", "shard_0000.npz", "shard_0001.npz"]
    starts = [len(_events(str(tmp_path / f"{r}.jsonl"), "shard_start"))
              for r in (0, 1)]
    assert starts == [2, 0]  # rank 0 alone judges and writes the shards


def test_sp_groups_across_ranks_hold_the_goldens_and_rank_0s_recovery(
        tmp_path):
    sys.path.insert(0, HERE)
    import _torch_dist_child as child

    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    logs = [str(tmp_path / f"rank{r}.jsonl") for r in (0, 1)]
    faults = {"RAFT_TPU_FAULTS": "oom:shard_eval:1,nan:shard_result:1"}
    res = _run_ranks([sys.executable, CHILD],
                     [_rank_env(r, port, DIST_CHILD_MODE="grid",
                                DIST_CHILD_OUT=outs[r], RAFT_TPU_LOG=logs[r],
                                DIST_CHILD_SWEEP_DIR=str(tmp_path / "ck"),
                                **(faults if r == 0 else {}))
                      for r in (0, 1)])
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    recs = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in res]
    # each rank ran one entry of each dp block: its frequency half
    assert [[(e["dp"], e["sp"], e["rows"], e["freq"])
             for e in r["grid_entries"]] for r in recs] == [
        [(0, 0, [0, 4], [0, 20]), (1, 0, [4, 8], [0, 20])],
        [(0, 1, [0, 4], [20, 40]), (1, 1, [4, 8], [20, 40])]]
    got = [dict(np.load(p)) for p in outs]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    g = dict(np.load(child.GRID_GOLDEN))
    for k in child.KEYS:
        for pfx, n in (("grid_", 8), ("ck_", 4)):
            a, b = got[0][pfx + k], g[k][:n]
            if k in EXACT:
                np.testing.assert_array_equal(a, b, err_msg=pfx + k)
            else:
                scale = float(np.max(np.abs(b)))
                assert float(np.max(np.abs(a - b))) <= TOL * scale, pfx + k
    # rank 0 halved the first shard and re-solved its poisoned row; the
    # other rank ran the halves at its orders and judged nothing
    assert len(_events(logs[0], "shard_oom_split")) == 1
    (q,) = _events(logs[0], "shard_quarantine")
    assert q["recovered"] is True
    assert not _events(logs[1], "shard_start")
    assert not _events(logs[1], "shard_quarantine")


def test_a_dead_rank_fails_its_peer():
    port = _free_port()
    res = _run_ranks([sys.executable, CHILD],
                     [_rank_env(r, port, DIST_CHILD_MODE="dead",
                                DIST_CHILD_TIMEOUT_S="15")
                      for r in (0, 1)], timeout=120)
    (rc0, out0, err0), (rc1, _, _) = res
    assert rc1 == 0
    assert rc0 != 0 and "survived" not in out0, err0[-2000:]


def test_two_rank_fabric_worker_holds_the_serial_sweep(tmp_path):
    keys = ("PSD", "X0", "status", "n_iter_drag")
    demo = fabric.demo_entry(out_keys=keys, n=12, device="cpu")
    serial = resilience.run_checkpointed(
        demo["compute"], demo["cases"], str(tmp_path / "serial"), 4,
        tsweep.make_mesh(device="cpu"), keys)
    out_dir = str(tmp_path / "fab")
    fabric.init_sweep(out_dir, "raft_tpu_torch.parallel.fabric:demo_entry",
                      demo["cases"], keys, 4,
                      entry_kwargs={"n": 12, "out_keys": list(keys)},
                      device="cpu")
    port = _free_port()
    logs = [str(tmp_path / f"rank{r}.jsonl") for r in (0, 1)]
    res = _run_ranks(
        [sys.executable, "-m", "raft_tpu_torch.parallel.fabric", "worker",
         "--out-dir", out_dir, "--worker-id", "pair"],
        [_rank_env(r, port, RAFT_TPU_LOG=logs[r]) for r in (0, 1)])
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    got = fabric.assemble(out_dir)
    for k in keys:
        np.testing.assert_array_equal(got[k], serial[k], err_msg=k)
    claims = _events(logs[0], "shard_claim")
    assert sorted(e["shard"] for e in claims) == [0, 1, 2]
    assert not _events(logs[1], "shard_claim")
    # rank 1 ran every shard on the global mesh and wrote nothing
    assert not _events(logs[1], "shard_done")
    assert len(_events(logs[0], "shard_done")) == 3


def test_two_rank_worker_waits_out_another_workers_lease(tmp_path):
    """Another worker holds shard 0's lease for twice the ranks'
    collectives timeout after the pair has finished every other shard:
    rank 0's keep-alives hold rank 1 through the wait."""
    keys = ("PSD", "X0", "status", "n_iter_drag")
    demo = fabric.demo_entry(out_keys=keys, n=12, device="cpu")
    serial = resilience.run_checkpointed(
        demo["compute"], demo["cases"], str(tmp_path / "serial"), 4,
        tsweep.make_mesh(device="cpu"), keys)
    out_dir = str(tmp_path / "fab")
    fabric.init_sweep(out_dir, "raft_tpu_torch.parallel.fabric:demo_entry",
                      demo["cases"], keys, 4,
                      entry_kwargs={"n": 12, "out_keys": list(keys)},
                      device="cpu")
    other = fabric.Ledger(out_dir, 3, worker_id="other")
    other.write_worker_status("running", held=[0])
    assert other.claim(0)
    timeout_s = 5.0
    stop = threading.Event()

    def hold():
        deadline = None
        while not stop.wait(0.3):
            other.renew(0)
            other.touch_worker()
            if deadline is None and other.has_done(1) and other.has_done(2):
                deadline = time.monotonic() + 2 * timeout_s
            if deadline is not None and time.monotonic() > deadline:
                other.release(0)
                return

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    port = _free_port()
    logs = [str(tmp_path / f"rank{r}.jsonl") for r in (0, 1)]
    try:
        res = _run_ranks(
            [sys.executable, CHILD],
            [_rank_env(r, port, DIST_CHILD_MODE="worker",
                       DIST_CHILD_SWEEP_DIR=out_dir,
                       DIST_CHILD_ORDERS_TIMEOUT_S=str(timeout_s),
                       RAFT_TPU_FABRIC_STEAL_MULT="1000000",
                       RAFT_TPU_LOG=logs[r]) for r in (0, 1)])
    finally:
        stop.set()
        holder.join(5)
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    got = fabric.assemble(out_dir)
    for k in keys:
        np.testing.assert_array_equal(got[k], serial[k], err_msg=k)
    claims = [e["shard"] for e in _events(logs[0], "shard_claim")]
    assert sorted(claims) == [0, 1, 2] and claims[-1] == 0
    assert not _events(logs[0], "shard_steal")

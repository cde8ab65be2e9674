"""Subprocess body of the port's multi-process mesh tests
(``tests/test_torch_dist.py``) and of the ``mesh`` phase of
``chip_smoke.py``: one rank of a ``torch.distributed`` job over the
spar demo's case evaluator.

The rank joins the job of its ``RAFT_TPU_DIST*`` variables
(:func:`raft_tpu_torch.parallel.sweep.ensure_distributed`) and, with
``DIST_CHILD_MODE``:

``sweeps`` (default)
    runs the demo's sea states over dp = 2 across the ranks
    (``make_mesh``: one entry per rank) through ``sweep_cases``, then
    over (dp, sp) = (1, 2) across the ranks through
    ``sweep_cases_full(..., shard_freq=True)``, then, with
    ``DIST_CHILD_SWEEP_DIR`` set, through ``run_sweep_checkpointed`` in
    shards of 4 rows on the dp = 2 mesh into that directory (rank 0
    writes it), and saves the results to ``DIST_CHILD_OUT``
    (``dp_<key>``, ``sp_<key>`` and ``ck_<key>``);
``dead``
    rank 1 exits at once after the join; rank 0 runs the (1, 2) sweep,
    which must fail (its exit code is 1) within the job's timeout;
``grid``
    runs the spar full evaluator on the rows of
    ``golden_mesh_full_spar.npz`` over a (dp, sp) = (2, 2) mesh whose
    every sp group spans both ranks (each rank an entry of each dp
    block) through ``sweep_cases_full(..., shard_freq=True)``, then
    the first 4 rows through ``run_sweep_checkpointed_full`` in shards
    of 2 rows on the same mesh into ``DIST_CHILD_SWEEP_DIR`` (faults
    armed by ``RAFT_TPU_FAULTS`` fire where rank 0 judges), and saves
    ``grid_<key>`` and ``ck_<key>`` to ``DIST_CHILD_OUT``;
``worker``
    sets the collectives' timeout to ``DIST_CHILD_ORDERS_TIMEOUT_S``
    after the join and runs a fabric worker on ``DIST_CHILD_SWEEP_DIR``
    (worker id ``pair``).

Other variables: ``DIST_CHILD_DEVICE`` ("cpu", default, or "cuda"),
``DIST_CHILD_ROWS`` (default 8), ``DIST_CHILD_TIMEOUT_S`` (the
collectives' timeout, default the module's), ``DIST_CHILD_BANK``: when
"1", first run the demo's case program of the bank's warm-up (``n``
rows on a one-entry mesh, under the ambient ``RAFT_TPU_AOT``), then run
the sweeps with the bank off.  One JSON line on stdout reports the
rank, the card backend, the bank's loads and builds, the kernel's nvcc
runs and each sweep's local entries.

Not a pytest module (underscore name): run as a script.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SPAR = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                    "design_spar.json")
KEYS = ("PSD", "Xi", "X0", "status", "n_iter_drag")
GRID_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                           "golden_mesh_full_spar.npz")


def demo_cases(n, seed=0):
    """The demo's sea states (``fabric.demo_entry``'s draws)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"Hs": rng.uniform(2.0, 8.0, int(n)),
            "Tp": rng.uniform(6.0, 14.0, int(n)),
            "beta": rng.uniform(-0.5, 0.5, int(n))}


def main():
    import numpy as np

    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel import sweep as ts
    from raft_tpu_torch.utils import budget

    mode = os.environ.get("DIST_CHILD_MODE", "sweeps")
    device = os.environ.get("DIST_CHILD_DEVICE", "cpu")
    n = int(os.environ.get("DIST_CHILD_ROWS", "8"))
    if os.environ.get("DIST_CHILD_TIMEOUT_S"):
        ts.DIST_TIMEOUT_S = float(os.environ["DIST_CHILD_TIMEOUT_S"])
    cfg = ts.ensure_distributed()
    rank = cfg["process_id"]
    if mode == "dead" and rank == 1:
        os._exit(0)
    if mode == "worker":
        from raft_tpu_torch.parallel import fabric

        ts.DIST_TIMEOUT_S = float(os.environ["DIST_CHILD_ORDERS_TIMEOUT_S"])
        return fabric.main(["worker", "--out-dir",
                            os.environ["DIST_CHILD_SWEEP_DIR"],
                            "--worker-id", "pair"])
    if mode == "grid":
        return grid(rank, device)
    model = Model(SPAR)
    ev = api.make_case_evaluator(model, device=device)
    cases = demo_cases(n)
    rec = {"rank": rank, "card_backend": ts.dist_backend("cuda")}
    if os.environ.get("DIST_CHILD_BANK") == "1":
        ts.sweep_cases(ev, cases["Hs"], cases["Tp"], cases["beta"],
                       mesh=ts.Mesh(ts.device_array([device]), ("dp",)),
                       out_keys=("PSD", "X0", "status"))
        cnt = metrics.snapshot()["counters"]
        rec.update(bank_loaded=cnt.get("aot_programs_loaded", 0),
                   bank_compiled=cnt.get("aot_programs_compiled", 0))
        os.environ["RAFT_TPU_AOT"] = "off"
    both = ts.Mesh(ts.device_array([device, device], (1, 2)), ("dp", "sp"),
                   ranks=[0, 1])
    if mode == "dead":
        ts.sweep_cases_full(ev, cases, mesh=both, out_keys=KEYS,
                            shard_freq=True)
        print(json.dumps(dict(rec, survived=True)), flush=True)
        return 0
    dp = ts.sweep_cases(ev, cases["Hs"], cases["Tp"], cases["beta"],
                        mesh=ts.make_mesh(device=device), out_keys=KEYS)
    rec["dp_entries"] = ts.last_entries()
    sp = ts.sweep_cases_full(ev, cases, mesh=both, out_keys=KEYS,
                             shard_freq=True)
    rec["sp_entries"] = ts.last_entries()
    ck = {}
    if os.environ.get("DIST_CHILD_SWEEP_DIR"):
        ck = ts.run_sweep_checkpointed(
            ev, cases["Hs"], cases["Tp"], cases["beta"],
            os.environ["DIST_CHILD_SWEEP_DIR"], shard_size=4,
            mesh=ts.make_mesh(device=device), out_keys=KEYS)
    np.savez(os.environ["DIST_CHILD_OUT"],
             **{f"dp_{k}": v for k, v in dp.items()},
             **{f"sp_{k}": v for k, v in sp.items()},
             **{f"ck_{k}": v for k, v in ck.items()})
    rec.update(nvcc_runs=linsolve.NVCC_RUNS, builds=budget.builds())
    print(json.dumps(rec), flush=True)
    return 0


def grid(rank, device):
    """The ``grid`` mode (module docstring)."""
    import numpy as np

    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.parallel import sweep as ts

    g = dict(np.load(GRID_GOLDEN))
    rows = {k: g[k] for k in api.ENV_KEYS + api.SEA_KEYS}
    ev = api.make_full_evaluator(Model(SPAR), nWaves=2, device=device)
    mesh = ts.Mesh(ts.device_array([device] * 4, (2, 2)), ("dp", "sp"),
                   ranks=[[0, 1], [0, 1]])
    out = ts.sweep_cases_full(ev, rows, mesh=mesh, out_keys=KEYS,
                              shard_freq=True)
    entries = ts.last_entries()
    ck = ts.run_sweep_checkpointed_full(
        ev, {k: v[:4] for k, v in rows.items()},
        os.environ["DIST_CHILD_SWEEP_DIR"], shard_size=2, mesh=mesh,
        out_keys=KEYS, shard_freq=True)
    np.savez(os.environ["DIST_CHILD_OUT"],
             **{f"grid_{k}": v for k, v in out.items()},
             **{f"ck_{k}": v for k, v in ck.items()})
    print(json.dumps({"rank": rank, "grid_entries": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Subprocess body of the port's program-bank tests
(``tests/test_torch_aot.py``) and of the card's bank test
(``tests/test_torch_cuda.py``).

Runs the spar demo's case sweep and one serving dispatch in a fresh
process and reports a JSON line on stdout.  Everything is driven by
environment variables:

    RAFT_TPU_AOT / RAFT_TPU_AOT_DIR / RAFT_TPU_COMPILE_BUDGET /
    RAFT_TPU_SERVE_LADDER       — the flags under test
    AOT_CHILD_DEVICE            — "cpu" (default) or "cuda"
    AOT_CHILD_N                 — rows of the case sweep (default 4: the
                                  rows ``aot warmup --n 4`` warms)
    AOT_CHILD_OUT               — where to savez the outputs
    AOT_CHILD_FAKE_CODE         — pretend the port's sources have another
                                  content hash (stored entries must MISS)
    AOT_CHILD_MANIFEST          — first, before anything imports torch,
                                  run ``release verify --manifest`` on
                                  this file and report its exit code and
                                  whether torch or numpy got imported
    AOT_CHILD_GO                — after the start-up (imports, the
                                  device's context, the model and its
                                  evaluator), wait until this file
                                  exists before the first program runs:
                                  a process started while the bank is
                                  still being warmed

Not a pytest module (underscore name): run as a script by the tests.
"""

import json
import os
import sys
import time

t_proc = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SPAR = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                    "design_spar.json")


def verify_manifest(path):
    from raft_tpu_torch.aot.__main__ import main

    rc = main(["release", "verify", "--manifest", path])
    return rc, sorted(m for m in ("torch", "numpy") if m in sys.modules)


def main():
    report = {}
    if os.environ.get("AOT_CHILD_MANIFEST"):
        report["verify_rc"], report["imported"] = verify_manifest(
            os.environ["AOT_CHILD_MANIFEST"])

    import numpy as np

    from raft_tpu_torch import api
    from raft_tpu_torch.aot import bank
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel.sweep import make_mesh, sweep_cases
    from raft_tpu_torch.serve import engine

    if os.environ.get("AOT_CHILD_FAKE_CODE"):
        bank._CODE_FP_CACHE.clear()
        bank.code_fingerprint = lambda: os.environ["AOT_CHILD_FAKE_CODE"]
    device = os.environ.get("AOT_CHILD_DEVICE", "cpu")
    n = int(os.environ.get("AOT_CHILD_N", "4"))

    model = Model(SPAR, base_dir=os.path.dirname(SPAR))
    evaluate = api.make_case_evaluator(model, device=device)
    rng = np.random.default_rng(0)          # warmup_model's rows
    Hs = rng.uniform(2.0, 8.0, n)
    Tp = rng.uniform(6.0, 14.0, n)
    beta = rng.uniform(-0.5, 0.5, n)
    entry = engine.DesignEntry("spar", model)
    rung = engine.batch_ladder()[0]
    t_wait = time.perf_counter()
    go = os.environ.get("AOT_CHILD_GO")
    while go and not os.path.exists(go):
        if time.perf_counter() - t_wait > 600:
            raise TimeoutError(f"{go} never appeared")
        time.sleep(0.02)
    wait_s = time.perf_counter() - t_wait
    t_run = time.perf_counter()
    out = sweep_cases(evaluate, Hs, Tp, beta, mesh=make_mesh(device=device),
                      out_keys=("PSD", "X0", "status"))
    served = engine.dispatch([entry] * rung, Hs[:rung], Tp[:rung],
                             beta[:rung], device=device, padded=rung)
    run_s = time.perf_counter() - t_run
    cold_start_s = time.perf_counter() - t_proc - wait_s

    if os.environ.get("AOT_CHILD_OUT"):
        np.savez(os.environ["AOT_CHILD_OUT"],
                 **{f"cases_{k}": v for k, v in out.items()},
                 **{f"serve_{k}": v for k, v in served.items()})
    c = metrics.snapshot()["counters"]
    report.update(
        cold_start_s=round(cold_start_s, 2), wait_s=round(wait_s, 2),
        run_s=round(run_s, 2),
        loaded=c.get("aot_programs_loaded", 0),
        compiled=c.get("aot_programs_compiled", 0),
        misses=c.get("aot_bank_misses", 0),
        errors=c.get("aot_bank_errors", 0),
        builds=bank.builds(), nvcc_runs=linsolve.NVCC_RUNS,
        built_here=linsolve.BUILT_HERE,
        library=linsolve.loaded_library(),
        launches=linsolve.forward_launches(), rung=rung)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

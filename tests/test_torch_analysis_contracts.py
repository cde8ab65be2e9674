"""The op contracts of the port's hot-path entries (``python -m
raft_tpu_torch.analysis contracts``): recorded on the spar demo on the
CPU, clean on the tree and within op_baseline.json's budgets, and each
seeded negative of tests/fixtures/torch_contracts/ (a geometry gather
re-done inside drag_lin_iter, a float64 op inside the float32 trips)
caught."""

import math
import os
import subprocess
import sys

import pytest

from raft_tpu_torch.analysis import contracts
from raft_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_contracts")


@pytest.fixture(scope="module")
def runner():
    return contracts.EntryRunner(device="cpu")


@pytest.fixture(scope="module")
def report(runner):
    """Every entry in both dtype modes (and both FUSED modes for the
    evaluators), the repeat call once per entry (about 30 s)."""
    return contracts.run_checks(runner=runner)


def test_contracts_clean_and_within_budget(report):
    assert report["violations"] == []
    base = contracts.load_baseline()
    assert set(report["counts"]) == set(base["entries"])
    for entry, variants in report["counts"].items():
        assert set(variants) == set(base["entries"][entry])


def test_drag_lin_iter_gathers_the_response_once(report):
    for s in report["counts"]["drag_lin_iter"].values():
        assert s["gathers"] == 1 and s["syncs"] == 0


def test_one_host_sync_per_scan_chunk_trips(report):
    chunk = config.get("SCAN_CHUNK")
    for entry, variants in report["counts"].items():
        for s in variants.values():
            stops = sum(math.ceil(t / chunk) for t in s["trips"])
            assert s["trip_syncs"] == stops, (entry, s)
            if entry in ("drag_lin_iter", "system_response",
                         "health_status"):
                assert s["syncs"] == 0
    s = report["counts"]["solve_dynamics_fowt"]["float32"]
    assert s["trips"] == [4] and s["syncs"] == 1


def test_no_64bit_op_under_float32(report):
    """Not in the trips, and on the spar not anywhere in any entry."""
    for entry, variants in report["counts"].items():
        for variant, s in variants.items():
            if variant.startswith("float32"):
                assert s["trip_wide"] == 0 and s["wide"] == 0, (entry, s)


def test_repeat_call_builds_nothing_and_runs_the_same_ops(report):
    for entry, variants in report["counts"].items():
        first = next(iter(variants.values()))
        r = first["repeat"]
        assert (r["builds"], r["nvcc"]) == (0, 0), entry
        assert r["ops"] == first["ops"], entry


def test_fused_response_runs_fewer_ops_than_staged(report):
    """FUSED=on takes the response from the fixed point's final solve:
    one solve and the drag-excitation chain fewer than FUSED=off."""
    for entry in ("design_evaluator", "bucket_evaluator", "fused_case"):
        for dt in ("float64", "float32"):
            on = report["counts"][entry][dt + "+fused"]
            off = report["counts"][entry][dt + "+staged"]
            assert on["total"] < off["total"]
            assert on["ops"][contracts.SOLVE_OP] + 1 == \
                off["ops"][contracts.SOLVE_OP]
            # each trip one solve, plus the final update
            assert on["ops"][contracts.SOLVE_OP] == sum(on["trips"]) + 1


def test_solve_is_one_op(runner):
    """linsolve.solve is recorded as raft.solve and the ops of its plain
    version are not: system_response is two transposes and one solve."""
    s = runner.record("system_response", "float64")
    assert s["ops"] == {"raft.solve": 1, "transpose.int": 2}


def test_negative_geometry_gather_in_the_trips_is_caught(runner):
    got = contracts.run_fixture(os.path.join(FIXTURES, "regather.py"),
                                runner)
    assert len(got) == 2
    assert got[0].startswith("drag_lin_iter[float64]: 2 gather-class op(s)")
    assert "8 gather-class op(s) in 4 trip(s)" in got[1]


def test_negative_float64_op_in_the_float32_trips_is_caught(runner):
    got = contracts.run_fixture(os.path.join(FIXTURES, "float64_trip.py"),
                                runner)
    assert got == ["solve_dynamics_fowt[float32]: 4 op(s) produce 64-bit "
                   "values under RAFT_TPU_DTYPE=float32 inside the trips "
                   "(_to_copy.default->float64)"]
    assert contracts.check_structure(
        "solve_dynamics_fowt", "float32",
        runner.record("solve_dynamics_fowt", "float32")) == []


def test_cli_fixture_exits_1():
    p = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "contracts",
         "--fixture", os.path.join(FIXTURES, "float64_trip.py")],
        capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "produce 64-bit values" in p.stdout

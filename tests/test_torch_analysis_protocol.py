"""The port's protocol checker (``python -m raft_tpu_torch.analysis
protocol``): its mutation sites and their actions per function are the
reference's (``raft_tpu/analysis/protocol_baseline.json``), the explorer
runs the port's real protocol functions clean, over the reference's
state space, and catches each seeded race under
tests/fixtures/torch_protocol/."""

import json
import os
import subprocess
import sys

import pytest

from raft_tpu_torch.analysis import mcheck, protocol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_protocol")
REFERENCE = os.path.join(ROOT, "raft_tpu", "analysis",
                         "protocol_baseline.json")

#: runs and states the reference's explorer visits on its own protocol
#: functions (raft_tpu/analysis/mcheck.py on this repository's CPU)
REFERENCE_STATS = {
    "lease-ledger": {"runs": 1684, "states": 1059},
    "release-pointer": {"runs": 21, "states": 17},
    "rollout-takeover": {"runs": 155, "states": 116},
    "rollout-gate": {"runs": 2546, "states": 1741},
    "breaker": {"runs": 3478, "states": 1496},
}


@pytest.fixture(scope="module")
def checked():
    """One full check: extraction diff + the explorer over all five
    scenarios (about 30 s)."""
    return protocol.check()


def test_explorer_clean_over_the_reference_state_space(checked):
    findings, stats = checked
    assert findings == []
    assert stats == REFERENCE_STATS


def test_actions_per_function_equal_the_reference():
    with open(REFERENCE, encoding="utf-8") as f:
        ref = json.load(f)
    sites, unmodeled = protocol.extract_all()
    assert unmodeled == []
    assert protocol.sites_to_model(sites) == ref["sites"]
    assert protocol.load_baseline() == ref
    assert tuple(ref["invariants"]) == mcheck.INVARIANTS


def test_static_check_flags_drift():
    sites, unmodeled = protocol.extract_all()
    base = protocol.load_baseline()
    base["sites"]["fabric::Ledger.claim::lease_claim"]["action"] = "renew"
    del base["sites"]["release::promote::fsops.write_atomic"]
    found = protocol.diff_against_baseline(sites, unmodeled, base)
    assert sorted(f.message.split()[0] for f in found) == [
        "mutation", "new"]


@pytest.mark.parametrize("name,rule", [
    ("claim_hijack", "protocol-single-holder"),
    ("gate_fleetwide", "protocol-gate-candidate-probed"),
    ("unmodeled_site", "protocol-unmodeled"),
])
def test_fixture_is_caught(name, rule):
    findings, _ = protocol.run_fixture(os.path.join(FIXTURES, name + ".py"))
    assert findings and {f.rule for f in findings} == {rule}


def test_cli_fixture_exits_1():
    p = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "protocol",
         "check", "--json", "--fixture",
         os.path.join(FIXTURES, "unmodeled_site.py")],
        capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 1, p.stdout + p.stderr
    doc = json.loads(p.stdout)
    assert not doc["clean"]
    assert {r["rule"] for r in doc["findings"]} == {"protocol-unmodeled"}

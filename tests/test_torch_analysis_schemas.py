"""The port's schema contracts (``python -m raft_tpu_torch.analysis
schemas``): its record families and their written and read keys are the
reference's (``raft_tpu/analysis/schema_baseline.json``) but for the
differences named here, each by design and recorded in ROADMAP.md §C."""

import json
import os
import subprocess
import sys

from raft_tpu_torch.analysis import schemas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "raft_tpu", "analysis", "schema_baseline.json")

#: (family, side, key) -> (port, reference) classification where the
#: port's record differs from the reference's:
#: * the bank's sidecar describes a torch program (its input signature,
#:   output structure, the kernel library as payload, its launches),
#:   the reference's a serialized XLA executable;
#: * fabric.json carries the port's device and dtype policy where the
#:   reference carries JAX's x64 switch;
#: * a quarantine entry of a solo CPU re-solve names its device.
KNOWN_DIFFERENCES = {
    ("aot-sidecar", "written", "avals"): (None, "always"),
    ("aot-sidecar", "written", "treedef"): (None, "always"),
    ("aot-sidecar", "written", "stablehlo_sha256"): (None, "conditional"),
    ("aot-sidecar", "written", "cost_analysis"): (None, "conditional"),
    ("aot-sidecar", "read", "cost_analysis"): (None, "optional"),
    ("aot-sidecar", "written", "inputs"): ("always", None),
    ("aot-sidecar", "written", "structure"): ("always", None),
    ("aot-sidecar", "written", "payload"): ("conditional", None),
    ("aot-sidecar", "read", "payload"): ("optional", None),
    ("aot-sidecar", "written", "launches"): ("conditional", None),
    ("fabric-spec", "written", "x64"): (None, "always"),
    ("fabric-spec", "read", "x64"): (None, "optional"),
    ("fabric-spec", "written", "device"): ("always", None),
    ("fabric-spec", "read", "device"): ("optional", None),
    ("fabric-spec", "written", "dtype"): ("always", None),
    ("fabric-spec", "read", "dtype"): ("optional", None),
    ("quarantine-entry", "written", "retry_device"): ("conditional", None),
}


def test_port_contracts_clean_against_its_baseline():
    violations, contracts = schemas.run_checks()
    assert violations == []
    assert len(contracts) == 16


def test_families_and_keys_equal_the_reference():
    with open(REFERENCE, encoding="utf-8") as f:
        ref = json.load(f)["families"]
    port = schemas.load_baseline()["families"]
    assert sorted(port) == sorted(ref)
    diff = {}
    for name in ref:
        for side in ("written", "read"):
            a, b = port[name][side], ref[name][side]
            for k in set(a) | set(b):
                if a.get(k) != b.get(k):
                    diff[(name, side, k)] = (a.get(k), b.get(k))
    assert diff == KNOWN_DIFFERENCES


def test_fixture_drift_is_caught():
    violations, _ = schemas.run_fixture_checks()
    assert any("read-never-written" in v and "renewed_t" in v
               for v in violations)
    assert any("required-but-conditional" in v and "ttl_s" in v
               for v in violations)


def test_baseline_roundtrip_and_drift(tmp_path):
    contracts = schemas.extract_all()
    path = schemas.write_baseline(contracts, str(tmp_path / "b.json"))
    base = schemas.load_baseline(path)
    assert schemas.baseline_violations(contracts, base) == []
    base["families"]["lease"]["written"]["renewed_t"] = "conditional"
    got = schemas.baseline_violations(contracts, base)
    assert len(got) == 1 and "'renewed_t'" in got[0]


def test_cli_fixture_exits_1():
    p = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "schemas",
         "--fixture"], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "renewed_t" in p.stdout

"""The root spans of the port's drivers.

``drivers.run`` and ``drivers.run_farm`` open ``driver.run`` /
``driver.run_farm`` around the model build, ``analyze_cases`` and the
CSV, as ``raft_tpu/drivers.py`` does: the driver span is the root of
the capture's tree and every case's ``solve_statics`` /
``solve_dynamics`` span is its child.  Both names are registered in the
port's span registry, as in the reference's.  One spar design on the
CPU per driver.
"""

import os

import pytest

from raft_tpu_torch import drivers
from raft_tpu_torch.obs import report

HERE = os.path.dirname(os.path.abspath(__file__))
SPAR = os.path.join(HERE, "fixtures", "torch_port", "design_spar.json")


def test_driver_span_names_are_registered_as_in_the_reference():
    from raft_tpu.obs import events as jevents
    from raft_tpu_torch.obs import events

    for name in ("driver.run", "driver.run_farm"):
        assert events.is_registered_span(name)
        assert jevents.is_registered_span(name)


@pytest.mark.parametrize("driver,root", [("run", "driver.run"),
                                         ("run_farm", "driver.run_farm")])
def test_driver_is_the_root_of_the_case_spans(driver, root, tmp_path,
                                              monkeypatch):
    log = tmp_path / "events.jsonl"
    csv = tmp_path / "spar.csv"
    monkeypatch.setenv("RAFT_TPU_LOG", str(log))
    model = getattr(drivers, driver)(SPAR, save_csv=str(csv), device="cpu")
    assert csv.exists()
    events, bad = report.read_events(str(log))
    assert bad == 0
    spans, open_begins = report.collect_spans(events)
    assert not open_begins
    roots = [s for s in spans if s["parent_id"] is None]
    assert [s["name"] for s in roots] == [root]
    top = roots[0]
    assert top["attrs"]["input"] == SPAR
    n_cases = len(model.results["case_metrics"])
    assert n_cases >= 1
    children = [s for s in spans if s is not top]
    assert sorted(s["name"] for s in children) == sorted(
        ["solve_statics", "solve_dynamics"] * n_cases)
    for s in children:
        assert s["parent_id"] == top["span_id"]
        assert s["trace_id"] == top["trace_id"]
        assert top["t0"] <= s["t0"] <= s["t1"] <= top["t1"]

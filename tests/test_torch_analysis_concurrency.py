"""The port's concurrency analyzer (``python -m raft_tpu_torch.analysis
concurrency``): each rule fires on its seeded fixture under
tests/fixtures/torch_lint/, and the port's shared-state and serve
modules are clean, their log_event calls cleared by the port's own
structlog allowlist (with the reference's allowlist they are the ten
async-blocking findings the reference's analyzer reports on the port)."""

import os
import re
import subprocess
import sys

import pytest

from raft_tpu_torch.analysis import concurrency

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_lint")


def _analyze(name):
    return concurrency.analyze_paths([os.path.join(FIXTURES, name)])


@pytest.mark.parametrize("name,rule,lines", [
    ("bad_atomic.py", "atomic-write", [9, 14, 18]),
    ("bad_async.py", "async-blocking", [10, 11, 12, 13, 14, 15, 23]),
    ("bad_lock.py", "lock-discipline", [15, 16, 35, 36]),
    ("bad_thread.py", "thread-hygiene", [7, 7, 7, 12, 14, 14]),
])
def test_rule_fires_on_its_fixture(name, rule, lines):
    found = _analyze(name)
    assert {f.rule for f in found} == {rule}, found
    assert [f.line for f in found] == lines


def test_sanctioned_idioms_are_clean():
    assert _analyze("good_atomic.py") == []


def test_port_runtime_is_clean():
    assert concurrency.analyze_paths() == []


def test_structlog_allowlist_clears_exactly_the_log_event_calls(
        monkeypatch):
    """The ten async-blocking findings the reference's allowlist leaves
    on the port: each an async handler's log_event, all cleared by
    NONBLOCKING_MODULES naming the port's structlog."""
    assert concurrency.NONBLOCKING_MODULES == (
        "raft_tpu_torch/utils/structlog.py",)
    monkeypatch.setattr(concurrency, "NONBLOCKING_MODULES", ())
    found = concurrency.analyze_paths()
    where = [(f.path.split("/")[-1],
              re.match(r"async def (\S+) calls", f.message).group(1))
             for f in found]
    assert where == [
        ("http.py", "Server._handle"), ("http.py", "Server.start"),
        ("http.py", "Server.shutdown"), ("http.py", "Server.shutdown"),
        ("router.py", "Router.failover"), ("router.py", "Router.failover"),
        ("router.py", "Router._attempt"),
        ("router.py", "Router._proxy_evaluate"),
        ("router.py", "Router.start"), ("router.py", "Router.shutdown")]
    assert all(f.rule == "async-blocking" and "structlog.py::log_event"
               in f.message for f in found)


def test_guard_annotations_parsed_from_the_port():
    info = concurrency._load_module(
        os.path.join(ROOT, "raft_tpu_torch", "utils", "budget.py"))
    assert info.module_guards["_BUILDS"][0] == "_LOCK"
    scan = concurrency.default_paths()
    assert all("raft_tpu_torch" + os.sep in p for p in scan)


def test_cli_reports_findings_with_exit_1():
    p = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "concurrency",
         os.path.join(FIXTURES, "bad_lock.py")],
        capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "lock-discipline" in p.stdout

"""The port's AST linter (``python -m raft_tpu_torch.analysis lint``):
each rule fires on its seeded fixture under tests/fixtures/torch_lint/
and the port's tree lints clean against the port's own registries."""

import os
import re
import subprocess
import sys

import pytest

from raft_tpu_torch.analysis import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_lint")
ALL = set(lint.RULES)


def _lint(name):
    return lint.lint_file(os.path.join(FIXTURES, name), rules=ALL)


@pytest.mark.parametrize("name,rule,lines", [
    ("bad_dtype.py", "dtype-literal", [10, 11, 12, 13, 14, 19]),
    ("bad_coercion.py", "host-coercion", [11, 12, 18, 19, 20, 21, 22]),
    ("bad_env.py", "env-read", [8, 9, 10]),
    ("bad_event.py", "event-name", [9, 10]),
    ("bad_span.py", "span-name", [9, 11]),
])
def test_rule_fires_on_its_fixture(name, rule, lines):
    found = _lint(name)
    assert {f.rule for f in found} == {rule}, found
    assert [f.line for f in found] == lines


@pytest.mark.parametrize("name", ["good_dtype.py", "suppressed.py"])
def test_clean_twins_lint_clean(name):
    assert _lint(name) == []


def test_port_tree_lints_clean():
    """Every module of raft_tpu_torch/, the dead-entry audit included
    (the drivers open their spans by literal name)."""
    assert lint.lint_paths() == []
    assert lint.registered_unused() == []


def test_suppressions_in_the_port_carry_a_reason():
    """Every `# raft-lint: disable=` in the port's modules names its
    reason on the line, and the drag fixed point's stop test is the
    one suppressed host sync of models/dynamics.py."""
    pat = re.compile(r"#\s*raft-lint:\s*disable(-file)?\s*=\s*[a-z\-,]+(.*)")
    seen = []
    for path in lint.default_paths():
        if os.sep + "analysis" + os.sep in path:
            continue
        with open(path, encoding="utf-8") as f:
            for i, text in enumerate(f, start=1):
                m = pat.search(text)
                if m:
                    seen.append((os.path.relpath(path, ROOT), i))
                    assert re.match(r"\s*\(.+\)", m.group(2)), (path, i, text)
    stops = [p for p, _ in seen if p.endswith("models/dynamics.py")]
    assert len(stops) == 1, seen
    with open(os.path.join(ROOT, "raft_tpu_torch", "models", "dynamics.py"),
              encoding="utf-8") as f:
        src = f.read()
    assert ("if bool(done_prev.all()):  # raft-lint: "
            "disable=host-coercion (stop test)") in src


def test_rules_follow_the_traced_modules():
    """host-coercion and the torch 64-bit literals apply to the traced
    modules only; the registry is exempt from env-read; jit-static has
    no subject in an eager port."""
    src = "import torch\n\ndef f(x):\n    y = torch.abs(x)\n" \
          "    return float(y), y.to(torch.float64)\n"
    traced = lint.lint_file("x.py", "raft_tpu_torch/ops/x.py", source=src)
    host = lint.lint_file("x.py", "raft_tpu_torch/drivers.py", source=src)
    assert [f.rule for f in traced] == ["host-coercion", "dtype-literal"]
    assert host == []
    cfg = os.path.join(ROOT, "raft_tpu_torch", "utils", "config.py")
    assert lint.lint_file(cfg) == []
    assert "jit-static" not in lint.RULES


def test_finding_format_is_file_line_col():
    f = _lint("bad_env.py")[0]
    assert f.format().startswith(
        os.path.relpath(os.path.join(FIXTURES, "bad_env.py"), ROOT)
        + ":8:")


def test_cli_reports_findings_with_exit_1():
    p = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "lint",
         os.path.join(FIXTURES, "bad_env.py")],
        capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "bad_env.py:8" in p.stdout

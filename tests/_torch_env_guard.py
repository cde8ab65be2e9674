"""A guard for the port's test files that build fabric workers, fleet
replicas or routers in the test process: such objects write
``RAFT_TPU_*`` variables into ``os.environ`` (a fabric ``Worker`` stamps
``RAFT_TPU_WORKER_ID``, as the reference's does), and a variable that
outlives its test changes what later tests in the same process see
(the JAX package's ``structlog.log_event`` stamps ``worker`` from it).

Use it as a module-level autouse fixture::

    from _torch_env_guard import raft_env_unchanged

    @pytest.fixture(autouse=True)
    def _raft_env_guard():
        with raft_env_unchanged():
            yield

An autouse fixture that requests no other fixture is set up before the
test's own ``monkeypatch`` and torn down after it, so the comparison
sees the environment after ``monkeypatch`` restored what it recorded.
"""

import contextlib
import os

import pytest

PREFIX = "RAFT_TPU_"


def raft_env():
    """Every ``RAFT_TPU_*`` variable of the process, as a dict."""
    return {k: v for k, v in os.environ.items() if k.startswith(PREFIX)}


def env_diff(before, after):
    """``{name: (before, after)}`` of the variables that differ (None
    for an absent one)."""
    return {k: (before.get(k), after.get(k))
            for k in sorted(set(before) | set(after))
            if before.get(k) != after.get(k)}


@contextlib.contextmanager
def raft_env_unchanged():
    """Fail (``pytest.fail``) when the block leaves a ``RAFT_TPU_*``
    variable other than it found it."""
    before = raft_env()
    yield
    diff = env_diff(before, raft_env())
    if diff:
        pytest.fail(f"the test leaked RAFT_TPU_* variables into the "
                    f"process environment: {diff}", pytrace=False)

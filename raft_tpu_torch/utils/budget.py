"""The per-process compile budget (``RAFT_TPU_COMPILE_BUDGET``): a
count of the program builds this process made — program-bank misses
that built a program (:mod:`raft_tpu_torch.aot.bank`) plus ``nvcc``
runs of the kernel library (:mod:`raft_tpu_torch.ops.linsolve`) — each
charged before the build starts, so a build past the budget never runs.

Kept below both of its callers so the kernel loader charges its builds
without importing the program bank.  Pure stdlib at import; the
metrics counter and the flight dump of an exceeded budget are imported
only when the budget is exceeded.
"""

from __future__ import annotations

import threading

from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

_LOCK = threading.Lock()
_BUILDS = [0]  # raft-lint: guarded-by=_LOCK


class CompileBudgetError(RuntimeError):
    """A program build past ``RAFT_TPU_COMPILE_BUDGET`` (the reference's
    ``RecompilationError``)."""


def builds():
    """Program builds charged in this process (bank misses that built a
    program plus ``nvcc`` runs)."""
    with _LOCK:
        return _BUILDS[0]


def charge(what):
    """Count one program build (``what``: ``"program"`` or ``"nvcc"``)
    against ``RAFT_TPU_COMPILE_BUDGET``, before it starts.  Past the
    budget it logs ``compile_budget_exceeded`` and, under the default
    ``RAFT_TPU_COMPILE_BUDGET_ACTION=error``, raises
    :class:`CompileBudgetError`, so the build never runs."""
    with _LOCK:
        _BUILDS[0] += 1
        count = _BUILDS[0]
    budget = config.get("COMPILE_BUDGET")
    if budget is None or budget < 0 or count <= budget:
        return
    action = config.get("COMPILE_BUDGET_ACTION")
    from raft_tpu_torch.obs import flight, metrics

    metrics.counter("compile_budget_exceeded").inc()
    log_event("compile_budget_exceeded", count=count, budget=budget,
              action=action)
    flight.dump(trigger="compile-budget", quiet=True)
    if action == "error":
        raise CompileBudgetError(
            f"program build #{count} ({what}) exceeds "
            f"RAFT_TPU_COMPILE_BUDGET={budget}: the bank is cold for this "
            "program (`python -m raft_tpu_torch.aot warmup`, or one "
            "RAFT_TPU_AOT=load run), or the kernel library is not built")

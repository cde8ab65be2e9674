"""Deterministic fault injection for the sweep and serving runtime (the
port's copy of ``raft_tpu/utils/faults.py``).

Every failure path in :mod:`raft_tpu_torch.parallel.resilience` — truncated
shard writes, transient evaluator errors, device OOM, NaN payloads,
unhealthy accelerator backends — can be triggered on demand so tests
exercise the *recovery* code, not just the happy path.  Faults are armed
either through the ``RAFT_TPU_FAULTS`` environment variable or the
:class:`inject` context manager; each armed fault fires a fixed number
of times and then disarms, which keeps injection deterministic (the
N-th retry after N-1 injected failures really succeeds).

Spec syntax (comma-separated in the env var, one string per spec in
``inject``)::

    kind:site[:count]          count defaults to 1

Kinds and the sites that consult them:

========== ================== ==============================================
kind       site               effect at the consulting site
========== ================== ==============================================
transient  shard_eval         raise :class:`TransientInjectedError`
oom        shard_eval         raise :class:`OOMInjectedError` (message
                              mimics a device ``RESOURCE_EXHAUSTED``)
truncate   shard_write        shard file is truncated after the atomic
                              rename, then :class:`InjectedFault` is raised
                              (simulates the process dying mid-write on a
                              filesystem that lost the tail)
nan        shard_result       first row of the computed shard is poisoned
                              with NaN
delay      shard_eval         sleep 0.25 s before the shard evaluation (a
                              deliberately slowed dispatch; arm with a
                              count covering every shard)
unhealthy  backend_probe      the accelerator probe reports the backend
                              dead (the port's ``resolve_mesh`` raises)
replica_   serve_evaluate     the serving process, at its next /evaluate:
kill                          SIGKILLs itself
replica_   serve_evaluate     parks the request past every timeout
hang
replica_   serve_evaluate     answers 500
5xx
provenance serve_provenance   the provenance stamps built at start-up
_skew                         report a skewed program identity
========== ================== ==============================================

The fabric's kinds (``worker_kill``, ``lease_expire``) are consulted
by :mod:`raft_tpu_torch.parallel.fabric`.

Example::

    with faults.inject("transient:shard_eval:2"):
        run_sweep_checkpointed_full(...)   # first two evals fail, retries win
"""

from __future__ import annotations

import os

from raft_tpu_torch.utils import config


class InjectedFault(RuntimeError):
    """A non-transient injected failure (e.g. simulated crash mid-write)."""


class TransientInjectedError(RuntimeError):
    """An injected failure the retry layer must classify as transient."""


class OOMInjectedError(RuntimeError):
    """An injected failure that mimics a device-OOM error string."""

    def __init__(self, msg="RESOURCE_EXHAUSTED: injected out of memory"):
        super().__init__(msg)


# armed faults: list of dicts {kind, site, count, env: bool}
_ACTIVE = []
_ENV_SEEN = None


def _parse(spec):
    parts = spec.strip().split(":")
    if len(parts) not in (2, 3) or not parts[0] or not parts[1]:
        raise ValueError(f"bad fault spec {spec!r} (want kind:site[:count])")
    count = int(parts[2]) if len(parts) == 3 else 1
    return {"kind": parts[0], "site": parts[1], "count": count}


def _sync_env():
    """(Re-)arm faults from RAFT_TPU_FAULTS whenever the var changes."""
    global _ENV_SEEN
    raw = config.raw("FAULTS") or ""
    if raw == _ENV_SEEN:
        return
    _ENV_SEEN = raw
    _ACTIVE[:] = [f for f in _ACTIVE if not f.get("env")]
    for spec in filter(None, (s.strip() for s in raw.split(","))):
        f = _parse(spec)
        f["env"] = True
        _ACTIVE.append(f)


def take(kind, site):
    """True when an armed ``kind:site`` fault should fire now.

    Decrements the matching fault's remaining count; a fault with no
    shots left never fires again (deterministic retry testing)."""
    _sync_env()
    for f in _ACTIVE:
        if f["kind"] == kind and f["site"] == site and f["count"] > 0:
            f["count"] -= 1
            return True
    return False


def check(site):
    """Raise whichever injected *error* fault is armed for ``site``.

    Consults the raising kinds (``transient``, ``oom``) so call sites
    need a single hook before doing real work."""
    if take("transient", site):
        raise TransientInjectedError(f"injected transient fault at {site}")
    if take("oom", site):
        raise OOMInjectedError()


class inject:
    """Context manager arming one or more fault specs for its scope::

        with faults.inject("nan:shard_result", "transient:shard_eval:2"):
            ...
    """

    def __init__(self, *specs):
        self._faults = [_parse(s) for s in specs]

    def __enter__(self):
        _ACTIVE.extend(self._faults)
        return self

    def __exit__(self, *exc):
        for f in self._faults:
            if f in _ACTIVE:
                _ACTIVE.remove(f)
        return False


def truncate_file(path, keep_fraction=0.5):
    """Truncate ``path`` to a fraction of its bytes (corrupt-shard sim)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_fraction)))

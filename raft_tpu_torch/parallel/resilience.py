"""Fault-tolerant runtime for checkpointed sweeps (counterpart of
``raft_tpu/parallel/resilience.py``, function for function).

The north-star workload (10k+ designs x 12 cases, hours of wall time,
20+ checkpoint shards) fails in ways a happy-path driver ignores: a
preemption mid-write leaves a truncated ``.npz`` that poisons the
resume; a resumed run with *changed* inputs silently mixes stale shards
into fresh results; one non-converged drag linearization emits a NaN
row that propagates into every aggregate; and a dead device takes the
whole sweep down.  This module supplies:

* **atomic shard writes** — tmp file in the same directory +
  ``os.replace``, so a shard file either exists complete or not at all;
* **corrupt-shard detection** — resume loads with
  ``np.load(allow_pickle=False)``, verifies the stored keys cover the
  requested ``out_keys`` and row counts match, and re-queues (never
  crashes on) a truncated/corrupt/stale shard;
* **sweep manifest** — ``manifest.json`` per ``out_dir`` records a
  config fingerprint (case-array hashes, ``out_keys``, ``shard_size``,
  mesh shape, package version) plus per-shard status; resuming against
  a manifest whose *input-determining* fields differ raises
  :class:`ManifestMismatchError` instead of mixing stale data;
* **retry with exponential backoff** for transient errors, and OOM
  degradation by halving the shard batch (``torch.OutOfMemoryError``
  is recognised by type; the caching allocator is emptied before the
  halves run);
* **NaN/Inf quarantine** — a per-row finiteness check after each shard;
  offending case parameters land in ``quarantine.json`` (with an
  optional solo re-evaluation of the row on the CPU) so non-finite rows
  are auditable instead of silently poisoning aggregates;
* **status-aware quarantine + escalation ladder** — when the sweep
  carries the ``"status"`` out_key (the in-band int32 solver-health
  word, :mod:`raft_tpu_torch.utils.health`), rows with SEVERE bits are
  caught too.  ``RAFT_TPU_ESCALATE`` selects the degradation path:
  ``off`` (flag + record only), ``retol`` (re-solve the row with
  ``RAFT_TPU_ESCALATE_ITER_SCALE`` x the iteration budget), ``f64_cpu``
  (retol, then float64 on the CPU).  Each rung's outcome — its device,
  the status it left, cleared vs persistent bits, original-vs-escalated
  result deltas — lands per case in ``quarantine.json`` (schema v2).

Both re-solves (the escalation rungs and the solo re-evaluation) are
explicit, recorded re-solves of single flagged rows; neither ever
replaces a shard's device run.  Unlike the reference, the port never
falls back to the CPU when the accelerator is unhealthy:
:func:`resolve_mesh` raises with the health probe's own words (a CPU
sweep is asked for with a CPU mesh).  With ``RAFT_TPU_FABRIC_WORKERS``
> 1, a compute that carries a fabric entry runs on the worker fabric
(:func:`raft_tpu_torch.parallel.fabric.run_fabric`, on the card unless
the mesh is a CPU one); every other sweep runs serially, with a
``fabric_unavailable`` event when workers were asked for.

Every event flows through :mod:`raft_tpu_torch.utils.structlog` (JSONL),
under the reference's names: ``sweep_start``, ``shard_start``,
``shard_done``, ``shard_resume``, ``shard_corrupt``, ``shard_retry``,
``shard_oom_split``, ``shard_quarantine``, ``shard_escalate``,
``shard_escalate_failed``, ``manifest_mismatch``, ``sweep_done``.
Failure paths are exercised deterministically via
:mod:`raft_tpu_torch.utils.faults`.

Telemetry (:mod:`raft_tpu_torch.obs`): the sweep, every shard, every
retry attempt and every escalation rung run inside spans; the metrics
registry counts shards done/resumed, rows retried/quarantined/flagged
and escalation outcomes, and its snapshot lands in the sweep manifest
and ``<out_dir>/metrics.json`` at ``sweep_done`` (Prometheus text to
``RAFT_TPU_METRICS`` when set).  ``RAFT_TPU_HEARTBEAT_S`` samples
device memory between shards; ``RAFT_TPU_PROFILE`` writes a
``torch.profiler`` Chrome trace of the whole checkpointed sweep; with
``RAFT_TPU_RUNS_DIR`` set, ``sweep_done`` appends a run record
(:mod:`raft_tpu_torch.obs.runs`).

torch is imported by the functions that use it, so the fabric's ledger
loads without it (the protocol explorer,
:mod:`raft_tpu_torch.analysis.mcheck`, runs it torch-free).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time

import numpy as np

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.heartbeat import maybe_heartbeat
from raft_tpu_torch.obs.spans import span
from raft_tpu_torch.utils import config, faults, health
from raft_tpu_torch.utils.structlog import log_event

MANIFEST_NAME = "manifest.json"
METRICS_NAME = "metrics.json"
QUARANTINE_NAME = "quarantine.json"

# fingerprint fields that determine the numerical content and layout of
# the shard files; any difference on resume means the existing shards
# answer a different question and must not be mixed in
_STRICT_FINGERPRINT_KEYS = ("case_hashes", "n_cases", "out_keys", "shard_size")


class ManifestMismatchError(RuntimeError):
    """Resume attempted with inputs that differ from the manifest."""


class ShardCorruptError(RuntimeError):
    """A checkpoint shard failed to load or failed validation."""


# --------------------------------------------------------------- atomic I/O


def _atomic_write(path, writer, mode="wb"):
    """Write a file atomically: tmp file in the same dir, ``writer(f)``,
    then ``os.replace`` — atomic on POSIX within one filesystem, so a
    preempted/killed process leaves either the complete previous file or
    no file, never a truncated one at the final path."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_savez(path, **arrays):
    """Write an ``.npz`` atomically (tmp file + rename)."""
    _atomic_write(path, lambda f: np.savez(f, **arrays))
    if faults.take("truncate", "shard_write"):
        # simulate dying mid-write on a pre-atomic driver / a filesystem
        # that lost the tail: corrupt the final file, then "crash"
        faults.truncate_file(path)
        raise faults.InjectedFault(f"injected truncation of {path}")


def _atomic_json(path, obj):
    _atomic_write(path, lambda f: json.dump(obj, f, indent=1, default=str),
                  mode="w")


def load_shard(path, out_keys, expect_rows=None):
    """Load and validate one checkpoint shard.

    Loads with ``allow_pickle=False`` (checkpoints are plain arrays; a
    pickled object in one is corruption or tampering), verifies every
    requested output key is present, and optionally checks the row
    count.  Raises :class:`ShardCorruptError` on any failure so the
    caller can re-queue the shard instead of crashing."""
    try:
        with np.load(path, allow_pickle=False) as z:
            stored = set(z.files)
            missing = [k for k in out_keys if k not in stored]
            if missing:
                raise ShardCorruptError(
                    f"{path}: stored keys {sorted(stored)} missing "
                    f"requested out_keys {missing}")
            out = {k: z[k] for k in out_keys}
    except ShardCorruptError:
        raise
    except Exception as e:  # truncated zip, bad CRC, unreadable header...
        raise ShardCorruptError(f"{path}: failed to load ({e})") from e
    if expect_rows is not None:
        bad = {k: v.shape for k, v in out.items()
               if v.shape[:1] != (expect_rows,)}
        if bad:
            raise ShardCorruptError(
                f"{path}: expected {expect_rows} rows, got {bad}")
    return out


# ----------------------------------------------------------------- manifest


def compute_fingerprint(cases, out_keys, shard_size, mesh=None):
    """Config fingerprint of one checkpointed sweep.

    ``case_hashes`` digests each case array's dtype+shape+bytes, so any
    change to the inputs — values, order, length — changes the
    fingerprint.  Mesh shape and package version are recorded for audit
    but compared only advisorily (results do not depend on device
    layout)."""
    import raft_tpu_torch

    case_hashes = {}
    for k in sorted(cases):
        v = np.ascontiguousarray(cases[k])
        h = hashlib.sha256()
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
        case_hashes[k] = h.hexdigest()
    return {
        "case_hashes": case_hashes,
        "n_cases": int(len(next(iter(cases.values())))),
        "out_keys": list(out_keys),
        "shard_size": int(shard_size),
        "mesh_shape": ([int(s) for s in mesh.devices.shape]
                       if mesh is not None else []),
        "mesh_axes": (list(mesh.axis_names) if mesh is not None else []),
        "package_version": getattr(raft_tpu_torch, "__version__", "unknown"),
    }


def _manifest_path(out_dir):
    return os.path.join(out_dir, MANIFEST_NAME)


def init_manifest(out_dir, fingerprint, n_shards):
    """Create or validate the sweep manifest for ``out_dir``.

    First run: writes a fresh manifest.  Resume: the strict fingerprint
    fields must match or :class:`ManifestMismatchError` is raised —
    changed inputs silently mixed with stale shards is the one failure
    mode this layer exists to make loud.  Advisory fields (mesh shape,
    package version) only log a ``manifest_mismatch`` warning event.

    Returns the manifest dict (fresh or loaded)."""
    path = _manifest_path(out_dir)
    if os.path.exists(path):
        try:
            with open(path) as f:
                manifest = json.load(f)
            old = manifest["fingerprint"]
        except Exception as e:
            raise ManifestMismatchError(
                f"{path} exists but is unreadable ({e}); refusing to "
                "resume against an unvalidatable checkpoint directory — "
                "delete the directory to start fresh") from e
        mismatched = [k for k in _STRICT_FINGERPRINT_KEYS
                      if old.get(k) != fingerprint[k]]
        if mismatched:
            log_event("manifest_mismatch", out_dir=out_dir,
                      fields=mismatched, fatal=True)
            raise ManifestMismatchError(
                f"resume fingerprint mismatch in {path} on fields "
                f"{mismatched}: the existing shards were produced from "
                "different inputs/config and cannot be mixed with this "
                "sweep — use a fresh out_dir (or delete this one)")
        advisory = [k for k in ("mesh_shape", "mesh_axes", "package_version")
                    if old.get(k) != fingerprint[k]]
        # adopt current advisory fields, keep shard statuses; persist so
        # the advisory mismatch is logged once, not on every resume
        manifest["fingerprint"] = fingerprint
        manifest.setdefault("shards", {})
        if advisory:
            log_event("manifest_mismatch", out_dir=out_dir,
                      fields=advisory, fatal=False)
            _atomic_json(path, manifest)
        return manifest
    manifest = {
        "version": 1,
        "fingerprint": fingerprint,
        "n_shards": int(n_shards),
        "shards": {},
    }
    _atomic_json(path, manifest)
    return manifest


def validate_manifest(out_dir, fingerprint):
    """Read-only strict-fingerprint check against an existing manifest.

    The concurrent-safe face of :func:`init_manifest` for fabric
    workers: N workers validating the same ``out_dir`` must not race
    each other with advisory-field rewrites (last-writer-wins would
    drop another worker's adoption), so this only *reads* — a strict
    mismatch raises :class:`ManifestMismatchError`, advisory drift is
    ignored (every worker's mesh legitimately differs).  A missing
    manifest is an error: the coordinator writes it at init, so its
    absence means ``out_dir`` was never fabric-initialized."""
    path = _manifest_path(out_dir)
    try:
        with open(path) as f:
            old = json.load(f)["fingerprint"]
    except Exception as e:
        raise ManifestMismatchError(
            f"{path} is missing or unreadable ({e}); this out_dir was "
            "not initialized for this sweep") from e
    mismatched = [k for k in _STRICT_FINGERPRINT_KEYS
                  if old.get(k) != fingerprint[k]]
    if mismatched:
        log_event("manifest_mismatch", out_dir=out_dir, fields=mismatched,
                  fatal=True)
        raise ManifestMismatchError(
            f"fingerprint mismatch in {path} on fields {mismatched}: "
            "this worker's sweep spec differs from the ledger's")


def mark_shard(manifest, out_dir, shard, status, **extra):
    """Record one shard's status in the manifest (atomic rewrite)."""
    rec = {"status": status, "file": f"shard_{shard:04d}.npz"}
    rec.update(extra)
    manifest["shards"][str(shard)] = rec
    _atomic_json(_manifest_path(out_dir), manifest)


# --------------------------------------------------------------- quarantine


def _quarantine_path(out_dir):
    return os.path.join(out_dir, QUARANTINE_NAME)


def record_quarantine(out_dir, shard, entries):
    """Merge quarantine ``entries`` for one shard into quarantine.json.

    Entries for the same shard from an earlier (superseded) computation
    are replaced, so a recomputed shard re-judges its own rows.

    Schema v2 (see README "Solver health"): every entry carries
    ``status`` (int32 solver-health word) and ``reason``
    (:func:`raft_tpu_torch.utils.health.describe`), so NaN rows, cap-hit rows
    and ill-conditioned rows are distinguishable; escalated rows add an
    ``escalation`` block (rungs tried, resolving rung, status/reason
    after, original-vs-escalated result deltas)."""
    path = _quarantine_path(out_dir)
    existing = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f).get("entries", [])
        except Exception as e:
            # externally damaged audit file: resetting it silently would
            # erase every prior entry — leave a loud trace first
            log_event("quarantine_corrupt", out_dir=out_dir,
                      error=str(e)[:200])
            existing = []
    existing = [e for e in existing if e.get("shard") != shard]
    existing.extend(entries)
    existing.sort(key=lambda e: (e.get("shard", 0), e.get("index", 0)))
    _atomic_json(path, {"version": 2, "entries": existing})


def load_quarantine(out_dir):
    """Return the list of quarantine entries for ``out_dir`` ([] if none)."""
    path = _quarantine_path(out_dir)
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            return json.load(f).get("entries", [])
    except Exception as e:
        log_event("quarantine_corrupt", out_dir=out_dir, error=str(e)[:200])
        return []


def nonfinite_rows(out):
    """Indices of batch rows with any non-finite value in any output."""
    bad = None
    for v in out.values():
        a = np.asarray(v)
        if not np.issubdtype(a.dtype, np.number):
            continue
        row_ok = np.isfinite(a).reshape(a.shape[0], -1).all(axis=1)
        bad = ~row_ok if bad is None else (bad | ~row_ok)
    if bad is None:
        return np.array([], dtype=int)
    return np.nonzero(bad)[0]


def flagged_rows(out, mask=health.SEVERE):
    """Indices of batch rows whose ``"status"`` word carries any bit of
    ``mask`` ([] when the sweep did not request the status out_key)."""
    st = out.get("status")
    if st is None:
        return np.array([], dtype=int)
    st = np.asarray(st)
    bad = (st & np.int32(mask)).reshape(st.shape[0], -1).any(axis=1)
    return np.nonzero(bad)[0]


def _row_status(out, i):
    """OR-fold of one row's status word(s) as a host int (0 when the
    sweep carries no status column)."""
    st = out.get("status")
    if st is None:
        return 0
    return int(np.bitwise_or.reduce(
        np.asarray(st[i], dtype=np.int64).ravel(), initial=0))


# --------------------------------------------------------------- escalation

_RUNGS = {"off": (), "retol": ("retol",), "f64_cpu": ("retol", "f64_cpu")}


def escalation_rungs():
    """The active escalation ladder (``RAFT_TPU_ESCALATE``, re-read per
    call): the ordered rungs a flagged row climbs until healthy."""
    return _RUNGS[config.get("ESCALATE")]


@contextlib.contextmanager
def _rung_flags(rung):
    """Pin one rung's flags around a solo re-evaluation.

    ``retol`` grants the solvers ``RAFT_TPU_ESCALATE_ITER_SCALE`` x
    their AMBIENT iteration budgets (``RAFT_TPU_ITER_SCALE``, read per
    call by the statics Newton and the drag fixed point) — relative,
    not absolute, so a base sweep already running with a scaled budget
    still escalates to a strictly larger one; ``f64_cpu`` additionally
    forces the float64 compute policy (``RAFT_TPU_DTYPE``), under which
    the rung's evaluator twin is built.

    A rung's flags change its program-bank key, and warm-up stores no
    rung programs, so under the serving config (``RAFT_TPU_AOT=require``
    with ``RAFT_TPU_COMPILE_BUDGET=0``) the rung's first re-solve would
    miss the bank and raise instead of healing the row.  Escalation is a
    rare one-row recovery where availability comes before a build-free
    process: a rung may always build (``AOT_MISS=compile``, no budget),
    and under ``load`` / ``require`` it stores its entry, so the next
    process's same rung loads."""
    ambient = max(int(config.get("ITER_SCALE")), 1)
    flags = {"ITER_SCALE":
             str(ambient * max(int(config.get("ESCALATE_ITER_SCALE")), 2)),
             "AOT_MISS": "compile", "COMPILE_BUDGET": "-1"}
    if rung == "f64_cpu":
        flags["DTYPE"] = "float64"
    old = {}
    try:
        for name, val in flags.items():
            env = config.env_name(name)
            old[env] = os.environ.get(env)
            os.environ[env] = val
        yield
    finally:
        for env, val in old.items():
            if val is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = val


def _rung_mesh(rung, mesh):
    """The rung's target mesh: ``f64_cpu`` re-solves on the CPU."""
    if rung == "f64_cpu":
        return _cpu_mesh(mesh)
    return mesh


def _result_delta(orig_row, new_row):
    """Max-abs difference between one row's original and escalated
    values (None for non-numeric keys or NaN-poisoned originals) — the
    compact original-vs-escalated record for quarantine.json."""
    try:
        a, b = np.asarray(orig_row), np.asarray(new_row)
        if not (np.issubdtype(a.dtype, np.number) and a.shape == b.shape):
            return None
        d = float(np.max(np.abs(a.astype(np.complex128)
                                - b.astype(np.complex128))))
        return d if np.isfinite(d) else None
    except Exception:
        return None


def _escalate_row(compute, solo, status_before, mesh, shard, index):
    """Climb the escalation ladder for one flagged row.

    Returns ``(retried_row_or_None, rungs_tried, resolved_rung,
    status_after, rung_log)``.  A retried row is returned only when a
    rung produced a HEALTHY one (finite, no SEVERE status bits) — an
    escalated result that is still flagged is never adopted, the
    original (auditable) values stay in the shard.  ``rung_log`` has
    one record per rung tried: its device, the status it left, the
    bits it cleared and the bits that persisted (or its error)."""
    tried, rung_log = [], []
    status_after = status_before
    for rung in escalation_rungs():
        tried.append(rung)
        metrics.counter("escalation_rungs").inc()
        rmesh = _rung_mesh(rung, mesh)
        rec = {"rung": rung, "device": _mesh_device(rmesh)}
        rung_log.append(rec)
        try:
            with span("escalation_rung", shard=shard, index=index,
                      rung=rung), _rung_flags(rung):
                retried = {k: np.asarray(v)[:1]
                           for k, v in compute(solo, rmesh).items()}
        except Exception as e:
            log_event("shard_escalate_failed", shard=shard, index=index,
                      rung=rung, error=str(e)[:200])
            rec["error"] = str(e)[:200]
            continue
        st = _row_status(retried, 0)
        if nonfinite_rows(retried).size:
            st |= health.NONFINITE_INTERMEDIATE
        status_after = st
        healthy = not bool(health.any_bit(st))
        rec.update(status_after=int(st),
                   cleared=int(status_before & ~st),
                   persistent=int(status_before & st))
        log_event("shard_escalate", shard=shard, index=index, rung=rung,
                  status_before=int(status_before), status_after=int(st),
                  resolved=healthy)
        if healthy:
            metrics.counter("escalations_resolved").inc()
            return retried, tried, rung, st, rung_log
    return None, tried, None, status_after, rung_log


# ------------------------------------------------------- retry / degradation


def _is_oom(e):
    """A device OOM: ``torch.OutOfMemoryError`` (the CUDA caching
    allocator's), the injected :class:`~raft_tpu_torch.utils.faults.
    OOMInjectedError`, or an error whose words say so."""
    import torch

    if isinstance(e, (torch.OutOfMemoryError, faults.OOMInjectedError)):
        return True
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def _free_device_memory():
    """Return the CUDA caching allocator's free blocks to the driver
    before an OOM-halved retry."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _is_transient(e):
    if isinstance(e, faults.TransientInjectedError):
        return True
    s = str(e)
    return any(tok in s for tok in (
        "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
        "Socket closed", "Connection reset", "failed to connect"))


def eval_with_recovery(compute, chunk, shard, max_retries=3, backoff_s=0.5,
                       _depth=0):
    """Evaluate one shard chunk with retry/backoff and OOM halving.

    compute : callable(chunk_dict) -> dict of per-row numpy arrays (same
        leading length as the chunk).
    Transient errors (transport error strings, injected faults) retry up
    to ``max_retries`` times with exponential backoff; a device OOM
    halves the batch and evaluates the two halves independently
    (recursively, down to single rows).  Anything else propagates."""
    n = len(next(iter(chunk.values())))
    attempt = 0
    while True:
        try:
            # span per attempt: a failing attempt is a span with
            # ok=False + error, so retries are visible in the
            # wall-time tree, not just as shard_retry events
            with span("shard_attempt", shard=shard, rows=n,
                      attempt=attempt + 1):
                faults.check("shard_eval")
                return compute(chunk)
        except Exception as e:
            if _is_oom(e) and n > 1:
                _free_device_memory()
                half = n // 2
                metrics.counter("shard_oom_splits").inc()
                log_event("shard_oom_split", shard=shard, rows=n,
                          split=[half, n - half], error=str(e)[:200])
                lo = eval_with_recovery(
                    compute, {k: v[:half] for k, v in chunk.items()},
                    shard, max_retries, backoff_s, _depth + 1)
                hi = eval_with_recovery(
                    compute, {k: v[half:] for k, v in chunk.items()},
                    shard, max_retries, backoff_s, _depth + 1)
                return {k: np.concatenate([lo[k], hi[k]]) for k in lo}
            if _is_transient(e) and attempt < max_retries:
                attempt += 1
                delay = backoff_s * (2.0 ** (attempt - 1))
                metrics.counter("shard_retries").inc()
                log_event("shard_retry", shard=shard, attempt=attempt,
                          max_retries=max_retries, delay_s=round(delay, 3),
                          error=str(e)[:200])
                time.sleep(delay)
                continue
            raise


_PROBE_VERDICT = None  # per-process cache: (ok, words) of the probe


def resolve_mesh(make_mesh, mesh=None):
    """Resolve the sweep mesh: ``mesh`` when given, else ``make_mesh()``
    over the CUDA devices once the device has passed a health probe in
    a child process (:func:`raft_tpu_torch.utils.devices.probe_backend`;
    its verdict is cached per process).

    Unlike the reference, this never falls back to the CPU: without
    CUDA, or when the probe fails (or the ``unhealthy:backend_probe``
    fault is armed), it logs ``backend_fallback_failed`` and raises a
    ``RuntimeError`` carrying the probe's own words and naming the CPU
    mesh the caller can ask for instead."""
    global _PROBE_VERDICT
    if mesh is not None:
        return mesh
    import torch

    from raft_tpu_torch.utils.devices import probe_backend

    forced = faults.take("unhealthy", "backend_probe")
    if forced:
        ok, words = False, "injected fault unhealthy:backend_probe"
    elif not torch.cuda.is_available():
        ok, words = False, "no CUDA device is available"
    else:
        if _PROBE_VERDICT is None:
            _PROBE_VERDICT = probe_backend(detail=True)
        ok, words = _PROBE_VERDICT
    if not ok:
        log_event("backend_fallback_failed", from_platform="cuda",
                  reason=f"unhealthy device, no CPU fallback: {words}"[:300])
        raise RuntimeError(
            f"the CUDA device failed its health probe ({words}); the "
            "sweep does not fall back to the CPU: pass "
            "mesh=make_mesh(device=\"cpu\") to run it there")
    return make_mesh()


# ------------------------------------------------------------- sweep runner


@contextlib.contextmanager
def _maybe_profile():
    """Write a ``torch.profiler`` Chrome trace of the block to
    ``<RAFT_TPU_PROFILE>/sweep-<pid>.json`` when the flag is set.
    Profiling must never take the sweep down: start/stop failures are
    logged (``profile_failed``) and swallowed."""
    prof_dir = config.get("PROFILE")
    if not prof_dir:
        yield
        return
    prof = None
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(prof_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        log_event("profile_start", dir=prof_dir)
    except Exception as e:
        prof = None
        log_event("profile_failed", error=str(e)[:200])
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(
                    os.path.join(prof_dir, f"sweep-{os.getpid()}.json"))
                log_event("profile_stop", dir=prof_dir)
            except Exception as e:
                log_event("profile_failed", error=str(e)[:200])


def _dump_metrics(out_dir, manifest, counters0):
    """Snapshot the metrics registry at sweep_done: ``metrics.json`` in
    the checkpoint directory, a copy inside the manifest (so a resumed
    run's manifest still carries the last completed picture), a
    ``metrics_snapshot`` event, and the Prometheus text export when
    ``RAFT_TPU_METRICS`` points somewhere.

    The registry is process-cumulative; ``counters0`` is the counter
    picture taken at sweep start, so ``counters`` in the dumped
    snapshot is THIS sweep's delta (a second sweep in the same process
    must not claim the first one's shards) — the raw totals stay
    available under ``counters_total``."""
    snap = metrics.snapshot()
    snap["counters_total"] = dict(snap["counters"])
    snap["counters"] = {k: v - counters0.get(k, 0)
                        for k, v in snap["counters"].items()
                        if v - counters0.get(k, 0)}
    try:
        _atomic_json(os.path.join(out_dir, METRICS_NAME), snap)
        manifest["metrics"] = snap
        _atomic_json(_manifest_path(out_dir), manifest)
    except OSError:
        pass  # telemetry must not fail the sweep that produced it
    log_event("metrics_snapshot", snapshot=snap)
    prom_path = config.get("METRICS")
    if prom_path:
        metrics.export(prom_path)
    return snap


def evaluate_shard(compute, chunk, shard, offset, mesh, max_retries=3,
                   backoff_s=0.5, quarantine_retry=True, on_result=None):
    """One shard's full fault-tolerant evaluation — the unit of work of
    the checkpointed runner (and of the fabric workers, so
    a fabric sweep judges and records a shard exactly like the serial
    path does).

    Orchestration: retry/backoff/OOM-halving eval -> injected-NaN
    fault -> non-finite + status-flagged row quarantine/escalation ->
    ``on_result(out, entries)`` (the caller persists the shard inside
    the shard span so write time stays on the telemetry tree) ->
    counters + the ``shard_wall_s`` histogram (which feeds the fabric's
    straggler-steal threshold).  Returns ``(out, entries, wall_s)``."""
    rows = len(next(iter(chunk.values())))
    with span("shard", shard=shard, rows=rows):
        log_event("shard_start", shard=shard, rows=rows)
        t_sh = time.perf_counter()
        if faults.take("delay", "shard_eval"):
            # deliberately slowed dispatch (fixed 0.25 s): the drill
            # the perf-regression sentinel (`obs runs regress`) must
            # catch as a shard_wall_s / span-histogram regression
            time.sleep(0.25)
        out = eval_with_recovery(
            lambda c: {k: np.asarray(v)[: len(next(iter(c.values())))]
                       for k, v in compute(c, mesh).items()},
            chunk, shard, max_retries=max_retries, backoff_s=backoff_s)
        if faults.take("nan", "shard_result"):
            for k, v in out.items():
                a = np.array(v)
                if np.issubdtype(a.dtype, np.inexact):
                    a[0] = np.nan
                    out[k] = a
        bad = nonfinite_rows(out)
        flagged = flagged_rows(out)
        entries = []
        if bad.size or flagged.size:
            out, entries = _quarantine_shard(
                compute, chunk, out, bad, flagged, shard, offset, mesh,
                retry_solo=quarantine_retry)
        if on_result is not None:
            on_result(out, entries)
        wall = time.perf_counter() - t_sh
        metrics.counter("shards_done").inc()
        metrics.counter("rows_evaluated").inc(rows)
        metrics.counter("rows_quarantined").inc(
            sum(1 for e in entries if not e.get("resolved")))
        metrics.counter("rows_flagged").inc(len(flagged_rows(out)))
        # latency exemplar: enough identity to name the p99 SHARD from
        # a /metrics scrape or a flight dump — which shard, how many
        # rows, how many rows stayed quarantined, on which worker —
        # and the span ids to pull its retry/escalation subtree out of
        # a merged trace
        from raft_tpu_torch.obs import spans as spans_mod

        ex = {"shard": int(shard), "rows": int(rows),
              "quarantined": sum(1 for e in entries
                                 if not e.get("resolved"))}
        wid = config.raw("WORKER_ID")
        if wid:
            ex["worker"] = wid
        ids = spans_mod.current_ids()
        if ids is not None:
            ex["trace_id"], ex["span_id"] = ids
        metrics.histogram("shard_wall_s").observe(wall, exemplar=ex)
        log_event("shard_done", shard=shard, rows=rows,
                  wall_s=round(wall, 3))
    return out, entries, wall


def run_checkpointed(compute, cases, out_dir, shard_size, mesh, out_keys,
                     on_shard=None, max_retries=3, backoff_s=0.5,
                     quarantine_retry=True):
    """Shared fault-tolerant core of the checkpointed sweep drivers.

    compute : callable(chunk_dict, mesh) -> dict of stacked outputs
        (tensors or numpy arrays, leading axis == chunk length; the callable
        must pad to the mesh itself if needed — the core always passes
        chunks whose length it reports truthfully and trims nothing).
    cases : dict of equal-length (N, ...) numpy arrays.

    Orchestration per shard: resume-validate -> (recompute on
    corruption) -> retry/backoff/OOM-halving eval -> NaN quarantine ->
    atomic write -> manifest update.  Returns the dict of concatenated
    results; quarantined row indices/params are in
    ``<out_dir>/quarantine.json`` and the rows themselves are left
    non-finite (aggregate nan-aware, or drop via the quarantine list)."""
    os.makedirs(out_dir, exist_ok=True)
    cases = {k: np.asarray(v) for k, v in cases.items()}
    lengths = {k: len(v) for k, v in cases.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(
            f"ragged case dict: all case arrays must have equal length, "
            f"got {lengths}")

    # elastic fabric path: RAFT_TPU_FABRIC_WORKERS > 1 routes the sweep
    # through N worker subprocesses claiming shards from the lease
    # ledger — zero caller changes, same out_dir layout, same results.
    # Needs a fabric entry spec on the compute closure (the sweep
    # runners propagate it from the evaluator's `_raft_fabric_entry`
    # stamp) so workers can rebuild the evaluator in their own process;
    # they run on the card unless the caller's mesh is a CPU one
    workers = int(config.get("FABRIC_WORKERS") or 0)
    if workers > 1:
        spec = getattr(compute, "_raft_fabric_entry", None)
        if spec:
            import torch

            from raft_tpu_torch.parallel import fabric

            device = ("cpu" if mesh is not None
                      and torch.device(mesh.devices.flat[0]).type == "cpu"
                      else "cuda")
            return fabric.run_fabric(
                out_dir, workers=workers, entry=spec["entry"],
                entry_kwargs=spec.get("kwargs"), warmup=spec.get("warmup"),
                cases=cases, out_keys=out_keys, shard_size=shard_size,
                on_shard=on_shard, max_retries=max_retries,
                backoff_s=backoff_s, quarantine_retry=quarantine_retry,
                device=device)
        log_event("fabric_unavailable", out_dir=out_dir,
                  reason="RAFT_TPU_FABRIC_WORKERS set but the evaluator "
                         "carries no _raft_fabric_entry spec; running "
                         "serial in-process")

    n = next(iter(lengths.values()))
    n_shards = (n + shard_size - 1) // shard_size

    fingerprint = compute_fingerprint(cases, out_keys, shard_size, mesh)
    progress = {"out_dir": out_dir, "shards_done": 0, "n_shards": n_shards}
    # profiler outermost: the sweep span's record_function must begin
    # INSIDE the active profiler session to land on the timeline
    with _maybe_profile(), \
            span("sweep", out_dir=out_dir, n_cases=n, n_shards=n_shards), \
            maybe_heartbeat(devices=list(mesh.devices.flat),
                            progress=progress) as heartbeat:
        manifest = init_manifest(out_dir, fingerprint, n_shards)
        log_event("sweep_start", out_dir=out_dir, n_cases=n,
                  n_shards=n_shards, shard_size=shard_size,
                  out_keys=list(out_keys),
                  mesh_shape=fingerprint["mesh_shape"])

        t0 = time.perf_counter()
        counters0 = dict(metrics.snapshot()["counters"])
        results = []
        n_quarantined = 0
        n_flagged = 0
        for s in range(n_shards):
            path = os.path.join(out_dir, f"shard_{s:04d}.npz")
            sl = slice(s * shard_size, min((s + 1) * shard_size, n))
            rows = sl.stop - sl.start
            if os.path.exists(path):
                try:
                    out = load_shard(path, out_keys, expect_rows=rows)
                    results.append(out)
                    resumed_flagged = len(flagged_rows(out))
                    # rows still bad in the stored shard (NaN or severe
                    # bits) ARE this sweep's quarantined rows even when
                    # the shard resumed from disk — otherwise a resumed
                    # run reports n_quarantined=0 while the shard data
                    # and quarantine.json still carry the poison
                    resumed_bad = len({int(i) for i in nonfinite_rows(out)}
                                      | {int(i) for i in flagged_rows(out)})
                    n_flagged += resumed_flagged
                    n_quarantined += resumed_bad
                    metrics.counter("shards_resumed").inc()
                    metrics.counter("rows_flagged").inc(resumed_flagged)
                    metrics.counter("rows_quarantined").inc(resumed_bad)
                    log_event("shard_resume", shard=s, rows=rows)
                    progress["shards_done"] = s + 1
                    if on_shard is not None:
                        on_shard(s + 1, n_shards, False)
                    continue
                except ShardCorruptError as e:
                    # re-queue: a truncated/stale shard is recomputed,
                    # not fatal
                    metrics.counter("shards_corrupt").inc()
                    log_event("shard_corrupt", shard=s, error=str(e)[:300])
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            mark_shard(manifest, out_dir, s, "running")
            chunk = {k: v[sl] for k, v in cases.items()}

            def persist(out_, entries_, _s=s, _path=path):
                # re-judge even when clean: a recomputed shard must
                # clear its own stale quarantine entries from a
                # previous run (no file is created for sweeps that
                # never quarantined anything)
                if entries_ or os.path.exists(_quarantine_path(out_dir)):
                    record_quarantine(out_dir, _s, entries_)
                atomic_savez(_path, **out_)

            out, entries, wall = evaluate_shard(
                compute, chunk, s, sl.start, mesh, max_retries=max_retries,
                backoff_s=backoff_s, quarantine_retry=quarantine_retry,
                on_result=persist)
            # rows still bad after recovery/escalation (resolved
            # escalation entries are audit records, not quarantined rows)
            shard_quarantined = sum(
                1 for e in entries if not e.get("resolved"))
            n_quarantined += shard_quarantined
            shard_flagged = len(flagged_rows(out))  # severe bits left
            n_flagged += shard_flagged
            mark_shard(manifest, out_dir, s, "done",
                       wall_s=round(wall, 3),
                       quarantined=shard_quarantined,
                       flagged=shard_flagged)
            results.append(out)
            progress["shards_done"] = s + 1
            if on_shard is not None:
                on_shard(s + 1, n_shards, True)

        if heartbeat is not None:
            # terminal beat BEFORE the snapshot: the end-of-run memory
            # watermark must be inside metrics.json, not after it
            heartbeat.stop()
        _dump_metrics(out_dir, manifest, counters0)
        log_event("sweep_done", out_dir=out_dir, n_cases=n,
                  n_quarantined=n_quarantined, n_flagged=n_flagged,
                  wall_s=round(time.perf_counter() - t0, 3))
        # longitudinal perf trajectory: one schema-versioned run record
        # per sweep session when RAFT_TPU_RUNS_DIR is set (no-op and
        # never fatal otherwise) — what `obs runs regress` gates on
        from raft_tpu_torch.obs import runs as obs_runs

        obs_runs.maybe_record(
            "sweep", label=os.path.basename(os.path.normpath(out_dir)),
            wall_s=time.perf_counter() - t0,
            extra={"n_cases": n, "n_shards": n_shards,
                   "n_quarantined": n_quarantined, "n_flagged": n_flagged})
    return {k: np.concatenate([r[k] for r in results]) for k in out_keys}


def _quarantine_shard(compute, chunk, out, bad, flagged, shard, offset, mesh,
                      retry_solo=True):
    """Handle non-finite AND status-flagged rows in one computed shard.

    With the escalation ladder OFF, NaN rows keep the original
    behavior — optional solo re-evaluation on the CPU (a device-side
    numerical pathology — e.g. f32 overflow in the drag linearization —
    can converge fine in host f64), quarantine entry only when the row
    stays non-finite, naming the device it was re-solved on
    (``retry_device``) — and finite-but-flagged rows are recorded
    (reason included) without a re-solve.  With ``RAFT_TPU_ESCALATE``
    active, every bad row climbs the ladder and gets an entry either
    way: resolved rows document which rung cleared which bits plus
    original-vs-escalated result deltas, persistent rows document the
    surviving reason, and ``escalation.rungs`` records each rung's
    device, status and cleared / persistent bits.  Unhealthy rows stay as
    computed (NaN rows stay NaN) so downstream aggregation can never
    mistake them for physics."""
    out = {k: np.array(v) for k, v in out.items()}
    entries = []
    rungs = escalation_rungs()
    cpu_mesh = _cpu_mesh(mesh) if retry_solo else None
    bad_set = {int(b) for b in bad}
    severe_unresolved = 0
    for i in sorted(bad_set | {int(f) for f in flagged}):
        nonfinite = i in bad_set
        keys_bad = [k for k, v in out.items()
                    if np.issubdtype(np.asarray(v).dtype, np.number)
                    and not np.isfinite(np.asarray(v[i])).all()]
        status_before = _row_status(out, i)
        if nonfinite:
            status_before |= health.NONFINITE_INTERMEDIATE
        solo = {k: v[i:i + 1] for k, v in chunk.items()}
        recovered = False
        escalation = None
        retry_device = None
        status_after = status_before
        if rungs:
            retried, tried, resolved_by, status_after, rung_log = \
                _escalate_row(compute, solo, status_before, mesh, shard,
                              offset + i)
            delta = None
            if retried is not None:
                delta = {k: _result_delta(out[k][i], retried[k][0])
                         for k in out if k != "status"}
                for k in out:
                    out[k][i] = retried[k][0]
                recovered = True
            escalation = {
                "mode": config.get("ESCALATE"),
                "rungs_tried": list(tried),
                "resolved_by": resolved_by,
                "result_delta": delta,
                "rungs": rung_log,
            }
        elif nonfinite and cpu_mesh is not None:
            retry_device = _mesh_device(cpu_mesh)
            try:
                retried = {k: np.asarray(v)[:1]
                           for k, v in compute(solo, cpu_mesh).items()}
                if not nonfinite_rows(retried).size:
                    for k in out:
                        out[k][i] = retried[k][0]
                    recovered = True
                    status_after = _row_status(out, i)
            except Exception as e:
                log_event("shard_quarantine_retry_failed", shard=shard,
                          index=offset + i, error=str(e)[:200])
        log_event("shard_quarantine", shard=shard, index=offset + i,
                  keys=keys_bad, recovered=recovered,
                  status=int(status_before),
                  reason=health.describe(status_before),
                  **({} if retry_device is None
                     else {"retry_device": retry_device}))
        if not recovered and (status_after & health.SEVERE
                              or nonfinite):
            severe_unresolved += 1
        # escalated rows are recorded even when resolved (the ladder's
        # outcome is part of the audit trail); the legacy NaN-only path
        # records only rows that stayed bad
        if rungs or not recovered:
            entry = {
                "shard": shard,
                "index": offset + i,
                "keys_nonfinite": keys_bad,
                "status": int(status_before),
                "reason": health.describe(status_before),
                "status_after": int(status_after),
                "reason_after": health.describe(status_after),
                "resolved": bool(recovered),
                "case": {k: np.asarray(v[i]).tolist()
                         for k, v in chunk.items()},
            }
            if escalation is not None:
                entry["escalation"] = escalation
            if retry_device is not None:
                entry["retry_device"] = retry_device
            entries.append(entry)
    if severe_unresolved:
        # a SEVERE row the ladder could not clear is a postmortem
        # moment: persist the flight ring (one dump per shard, after
        # the loop — not one per row) with the recent solve/dispatch
        # history that led to it
        from raft_tpu_torch.obs import flight

        flight.dump(trigger="quarantine-severe")
    return out, entries


def _cpu_mesh(mesh):
    """A one-entry CPU mesh with the same axis names as ``mesh`` (for
    the solo re-evaluations)."""
    from raft_tpu_torch.parallel.sweep import Mesh, device_array

    return Mesh(device_array(["cpu"], (1,) * len(mesh.axis_names)),
                mesh.axis_names)


def _mesh_device(mesh):
    """The first device of a mesh, as text (for quarantine records)."""
    return str(mesh.devices.flat[0])

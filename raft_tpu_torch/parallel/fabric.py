"""Elastic multi-worker sweep fabric: lease ledger, workers, stealing
(counterpart of ``raft_tpu/parallel/fabric.py``, function for function,
on the reference's on-disk formats).

The serial checkpointed runner (:func:`raft_tpu_torch.parallel.
resilience.run_checkpointed`) walks shards in ONE process.  Here the
shard queue becomes a shared **work ledger** living in the sweep's
``out_dir`` — no server, no locks beyond the filesystem — and any number
of **worker processes** drain it concurrently:

* **ledger** — per-shard lease records under ``<out_dir>/_fabric/``
  written with the same atomic patterns the checkpoint layer already
  trusts: a *claim* is ``O_CREAT|O_EXCL`` on the lease file (exactly
  one claimant wins), a *renewal* is an atomic tmp+``os.replace``
  rewrite, a *steal* is an ``os.rename`` of the expired lease away
  (exactly one stealer wins the rename);
* **workers** (``python -m raft_tpu_torch.parallel.fabric worker``)
  loop: claim an unleased/expired shard, evaluate it through the SAME
  retry/OOM-halving/quarantine/escalation path as the serial runner
  (:func:`~raft_tpu_torch.parallel.resilience.evaluate_shard`), write
  the shard atomically, release the lease.  A worker that dies
  mid-shard simply stops renewing; its lease expires and the shard is
  re-claimed — the corrupt/truncated-shard detection makes a
  half-written ``.npz`` safe to requeue, and re-execution is
  deterministic (the card's run-independent scatter-adds,
  :mod:`raft_tpu_torch.ops.scatter`), so double-computation is benign;
* **work stealing** — a lease is stealable when it EXPIRED (holder
  stopped renewing: dead or wedged), when the holder's status-file
  heartbeat went stale, or when its age exceeds
  ``RAFT_TPU_FABRIC_STEAL_MULT`` x the fleet-pooled ``shard_wall_s``
  p95 (bucket counts from every worker's status file merge exactly —
  :func:`raft_tpu_torch.obs.metrics.merge_states`);
* **coordinator** (``fabric run --workers N`` / :func:`run_fabric`)
  initializes the ledger, spawns N local worker subprocesses, waits on
  the ledger and assembles results exactly as the serial runner does
  (manifest statuses, merged quarantine.json, metrics.json, a run
  record) — callers see the same out_dir layout and the same
  concatenated result dict, bit-identical to a serial run.

Workers rebuild their evaluator from an importable **entry spec**
(``module:callable`` or ``path.py:callable`` — never a pickled
closure); the callable returns the shard ``compute(chunk, mesh)``
(usually via :func:`raft_tpu_torch.parallel.sweep.full_compute` /
``case_compute``) or a dict ``{"compute", "cases"}``.  A worker calls
it with the spec's ``entry_kwargs`` plus ``device`` (the spec's, unless
the kwargs name one), so the evaluator is built where the worker runs.
Evaluators advertise their entry by stamping ``evaluate.
_raft_fabric_entry = {"entry": "mod:fn", "kwargs": {...}}``; with that
stamp in place, ``RAFT_TPU_FABRIC_WORKERS=N`` routes any checkpointed
sweep through the fabric with zero caller changes.

Devices: the spec carries ``device`` (``"cuda"`` unless the caller's
mesh or ``device=`` says ``"cpu"``) and the dtype policy.  A worker on
``"cuda"`` resolves its mesh through :func:`~raft_tpu_torch.parallel.
resilience.resolve_mesh` (health probe, raise, never the CPU); on
``"cpu"`` it takes ``make_mesh(device="cpu")``.  With one card, every
worker lands on ``cuda:0``.  One thing of the reference is refused
rather than skipped: multi-host workers (``RAFT_TPU_DIST*`` set;
ROADMAP A15(g); a worker raises).

Cold start: an entry can name an AOT ``warmup`` spec — a worker pushes
it through :func:`raft_tpu_torch.aot.warmup.warmup_model` before its
first claim when ``RAFT_TPU_AOT`` is armed, so its first shard does not
carry the process's first evaluation; its ``fabric_worker_start`` event
and status file report ``programs_loaded`` / ``programs_compiled``,
``warmup_s`` and ``warmup_launches``.

Failure injection (:mod:`raft_tpu_torch.utils.faults`): ``worker_kill:
worker_shard`` SIGKILLs a worker right after it claims a lease;
``lease_expire:lease_renew`` makes a worker silently stop renewing.
The coordinator forwards these two kinds to exactly ONE worker
(``RAFT_TPU_FABRIC_FAULT_WORKER``) so the kill-a-worker drill is
deterministic.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.heartbeat import maybe_heartbeat
from raft_tpu_torch.obs.spans import ambient_ids, propagation_env, span
from raft_tpu_torch.parallel import resilience
from raft_tpu_torch.utils import config, faults, fsops
from raft_tpu_torch.utils.structlog import log_event

FABRIC_DIRNAME = "_fabric"
SPEC_NAME = "fabric.json"
CASES_NAME = "cases.npz"

#: observations required before the pooled shard_wall_s p95 is trusted
#: to judge stragglers (below this, only TTL expiry steals)
MIN_WALL_SAMPLES = 4


class FabricError(RuntimeError):
    """The fabric could not complete the sweep (all workers died with
    shards remaining, or assembly found a missing/corrupt shard)."""


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# ------------------------------------------------------------------ paths


def fabric_dir(out_dir):
    return os.path.join(out_dir, FABRIC_DIRNAME)


def _spec_path(out_dir):
    return os.path.join(fabric_dir(out_dir), SPEC_NAME)


def _cases_path(out_dir):
    return os.path.join(fabric_dir(out_dir), CASES_NAME)


def _lease_path(out_dir, shard):
    return os.path.join(fabric_dir(out_dir), "leases",
                        f"shard_{shard:04d}.json")


def _done_path(out_dir, shard):
    return os.path.join(fabric_dir(out_dir), "done",
                        f"shard_{shard:04d}.json")


def _workers_dir(out_dir):
    return os.path.join(fabric_dir(out_dir), "workers")


def _worker_path(out_dir, worker_id):
    return os.path.join(_workers_dir(out_dir), f"{worker_id}.json")


def _shard_path(out_dir, shard):
    return os.path.join(out_dir, f"shard_{shard:04d}.npz")


def load_spec(out_dir):
    with open(_spec_path(out_dir)) as f:
        return json.load(f)


def load_cases(out_dir):
    with np.load(_cases_path(out_dir), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------- atomic lease primitives
#
# The three filesystem idioms a lease ledger is built from: claim =
# ``O_CREAT|O_EXCL`` (exactly one creator), rewrite = tmp +
# ``os.replace`` (readers see old-or-new, never torn), steal/evict =
# ``os.rename`` to a unique grave (exactly one winner).


def lease_claim(path, rec):
    """Exclusive lease creation: True when THIS caller won the
    ``O_CREAT|O_EXCL`` race and wrote ``rec``."""
    try:
        fsops.create_exclusive(path, json.dumps(rec))
    except FileExistsError:
        return False
    return True


def lease_read(path):
    """``(record, mtime)`` of a lease file, or ``(None, None)`` when
    absent.  A present-but-unreadable lease (claimant mid-write) reads
    as an empty record with the file's mtime."""
    try:
        mtime = fsops.getmtime(path)
    except OSError:
        return None, None
    try:
        return json.loads(fsops.read_text(path)), mtime
    except (OSError, ValueError):
        return {}, mtime


def lease_rewrite(path, rec):
    """Atomic full rewrite of a lease record (renewals): tmp write +
    ``replace`` through the :mod:`~raft_tpu_torch.utils.fsops` seam."""
    fsops.write_atomic(path, json.dumps(rec))


def lease_remove(path):
    """Atomically remove a lease via rename to a unique grave: True
    when THIS caller won the rename (steal/evict — the losing racer
    sees False and must not double-count the removal)."""
    grave = fsops.grave_name(path, "stolen")
    try:
        fsops.rename(path, grave)
    except OSError:
        return False
    try:
        fsops.unlink(grave)
    except OSError:
        pass
    return True


# ----------------------------------------------------------------- ledger


class Ledger:
    """The shared shard ledger for one sweep directory.

    Every mutation is a single atomic filesystem operation, so any
    number of processes can use one instance's worth of methods
    concurrently:

    * :meth:`claim` — ``O_CREAT|O_EXCL`` lease-file creation;
    * :meth:`renew` — atomic rewrite bumping ``renewed_t`` (ownership
      checked by token; a lost race recreates a lease the owner still
      legitimately holds — worst case two workers compute the same
      deterministic shard, which is benign);
    * :meth:`steal` — ``os.rename`` of the stealable lease to a unique
      grave name: exactly one stealer wins, the shard returns to the
      unleased pool;
    * :meth:`write_done` — atomic completion record (the shard ``.npz``
      itself is the source of truth; the done record carries
      worker/wall/attempt/quarantine bookkeeping and spares rescans from
      re-validating every file).
    """

    def __init__(self, out_dir, n_shards, worker_id=None):
        self.out_dir = out_dir
        self.n_shards = int(n_shards)
        self.worker_id = worker_id
        self.token = uuid.uuid4().hex
        for sub in ("leases", "done", "workers"):
            fsops.makedirs(os.path.join(fabric_dir(out_dir), sub),
                           exist_ok=True)

    # -- leases

    def read_lease(self, shard):
        """``(record, mtime)`` of the shard's lease, or ``(None,
        None)`` (see :func:`lease_read`)."""
        return lease_read(_lease_path(self.out_dir, shard))

    def claim(self, shard, attempt=1):
        """Try to claim the shard; True when THIS caller won the
        exclusive lease-file creation."""
        path = _lease_path(self.out_dir, shard)
        now = time.time()
        rec = {
            "worker": self.worker_id,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "claimed_t": now,
            "renewed_t": now,
            "ttl_s": float(config.get("FABRIC_TTL_S")),
            "attempt": int(attempt),
            "token": self.token,
        }
        ids = ambient_ids()  # active span or env-inherited trace ctx
        if ids is not None:
            rec["trace_id"], rec["parent_span_id"] = ids
        if not lease_claim(path, rec):
            return False
        metrics.counter("shards_claimed").inc()
        log_event("shard_claim", shard=shard, worker=self.worker_id,
                  attempt=int(attempt))
        return True

    def renew(self, shard):
        """Refresh the lease's ``renewed_t``; False when the lease is
        no longer this worker's (stolen or released)."""
        rec, _ = self.read_lease(shard)
        if not rec or rec.get("token") != self.token:
            return False
        rec["renewed_t"] = time.time()
        lease_rewrite(_lease_path(self.out_dir, shard), rec)
        return True

    def release(self, shard):
        """Drop this worker's lease (no-op when it was stolen)."""
        rec, _ = self.read_lease(shard)
        if rec and rec.get("token") == self.token:
            try:
                fsops.unlink(_lease_path(self.out_dir, shard))
            except OSError:
                pass

    def stealable(self, shard, now=None, pooled=None):
        """``(reason, age_s, holder, attempt)`` when the shard's lease
        may be stolen, else ``(None, ...)``.

        Reasons: ``expired`` (not renewed within TTL — a dead worker IS
        an expired lease), ``holder_stale`` (the holder's status file
        stopped updating), ``straggler`` (lease age exceeds
        ``RAFT_TPU_FABRIC_STEAL_MULT`` x the fleet-pooled
        ``shard_wall_s`` p95 with at least ``MIN_WALL_SAMPLES``
        observations).  ``now`` (unix seconds) is the instant judged;
        pass a precomputed ``pooled`` histogram when checking many
        shards in one pass."""
        rec, mtime = self.read_lease(shard)
        if rec is None:
            return None, 0.0, None, 0
        now = time.time() if now is None else now
        ttl = float(rec.get("ttl_s") or config.get("FABRIC_TTL_S"))
        holder = rec.get("worker")
        attempt = int(rec.get("attempt") or 1)
        renewed = float(rec.get("renewed_t") or mtime)
        age = now - renewed
        if age > ttl:
            return "expired", age, holder, attempt
        if holder:
            try:
                st_m = fsops.getmtime(_worker_path(self.out_dir, holder))
                if now - st_m > ttl:
                    return "holder_stale", now - st_m, holder, attempt
            except OSError:
                pass  # holder never wrote a status file: TTL rules it
        claim_age = now - float(rec.get("claimed_t") or mtime)
        if pooled is None:
            pooled = self.pooled_walls()
        if pooled.count >= MIN_WALL_SAMPLES:
            p95 = pooled.percentile(0.95)
            mult = float(config.get("FABRIC_STEAL_MULT"))
            if p95 and p95 > 0 and claim_age > mult * p95:
                return "straggler", claim_age, holder, attempt
        return None, age, holder, attempt

    def steal(self, shard, reason, age, holder):
        """Atomically remove a stealable lease (rename to a unique
        grave, then unlink).  True when THIS caller won the rename —
        the shard is unleased again and open to normal claims."""
        if not lease_remove(_lease_path(self.out_dir, shard)):
            return False  # someone else stole/released it first
        metrics.counter("shards_stolen").inc()
        log_event("shard_steal", shard=shard, worker=self.worker_id,
                  from_worker=holder, reason=reason,
                  age_s=round(float(age), 3))
        return True

    # -- completion records

    def has_done(self, shard):
        return os.path.exists(_done_path(self.out_dir, shard))

    def read_done(self, shard):
        try:
            with open(_done_path(self.out_dir, shard)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def write_done(self, shard, **rec):
        rec.setdefault("worker", self.worker_id)
        rec.setdefault("t", time.time())
        ids = ambient_ids()
        if ids is not None and "trace_id" not in rec:
            rec["trace_id"], rec["parent_span_id"] = ids
        resilience._atomic_json(_done_path(self.out_dir, shard), rec)

    def done_count(self):
        return sum(1 for s in range(self.n_shards) if self.has_done(s))

    # -- worker status (the holder-staleness heartbeat + wall pooling)

    def worker_states(self):
        """Every worker's last status record (unreadable files skipped)."""
        out = {}
        try:
            names = fsops.listdir(_workers_dir(self.out_dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                out[name[:-5]] = json.loads(fsops.read_text(
                    os.path.join(_workers_dir(self.out_dir), name)))
            except (OSError, ValueError):
                continue
        return out

    def pooled_walls(self, states=None):
        """Fleet-wide ``shard_wall_s`` histogram: every worker's
        published bucket state merged (pass ``states`` to reuse one
        :meth:`worker_states` read across many shard checks).  Only a
        WORKER that has not yet published a status file folds in its
        own live registry — a coordinator's registry may hold an
        unrelated earlier sweep's observations."""
        if states is None:
            states = self.worker_states()
        pooled = metrics.merge_states(
            [st.get("shard_wall_s") for st in states.values() if st],
            name="shard_wall_s_pooled")
        if self.worker_id is not None and self.worker_id not in states:
            pooled.merge_state(metrics.histogram("shard_wall_s").state())
        return pooled

    def write_worker_status(self, state, held=(), **extra):
        rec = {
            "worker": self.worker_id,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "t": time.time(),
            "state": state,
            "held": sorted(int(s) for s in held),
            "shard_wall_s": metrics.histogram("shard_wall_s").state(),
        }
        rec.update(extra)
        resilience._atomic_json(
            _worker_path(self.out_dir, self.worker_id), rec)

    def touch_worker(self):
        """Cheap liveness bump of this worker's status file (called
        from the lease renewer so a long shard keeps the holder's
        heartbeat fresh without a full status rewrite)."""
        try:
            fsops.utime(_worker_path(self.out_dir, self.worker_id))
        except OSError:
            pass

    def summary(self):
        """Ledger snapshot for the ``status`` CLI / tests."""
        now = time.time()
        leases = {}
        for s in range(self.n_shards):
            rec, mtime = self.read_lease(s)
            if rec is None:
                continue
            leases[s] = {
                "worker": rec.get("worker"),
                "attempt": rec.get("attempt"),
                "age_s": round(now - float(rec.get("renewed_t") or mtime
                                           or now), 3),
            }
        done = [s for s in range(self.n_shards) if self.has_done(s)]
        return {
            "n_shards": self.n_shards,
            "done": len(done),
            "leased": leases,
            "remaining": self.n_shards - len(done),
            "workers": {wid: {k: st.get(k) for k in
                              ("state", "held", "shards_done", "pid")}
                        for wid, st in self.worker_states().items()},
        }


# ------------------------------------------------------------ entry specs


def resolve_entry(entry, kwargs=None):
    """Import and call one fabric entry spec.

    ``entry`` is ``module:callable`` (importable from the repo root)
    or ``path/to/file.py:callable``.  The callable receives ``kwargs``
    and returns either the shard ``compute(chunk, mesh)`` callable or
    a dict with keys ``compute`` (required) and ``cases``.  Returns the
    normalized dict."""
    if ":" not in entry:
        raise ValueError(
            f"bad fabric entry {entry!r} (want module:callable or "
            "path.py:callable)")
    target, attr = entry.rsplit(":", 1)
    if target.endswith(".py") or os.sep in target:
        spec = importlib.util.spec_from_file_location(
            "_raft_fabric_entry_" + os.path.basename(target)[:-3], target)
        if spec is None or spec.loader is None:
            raise ValueError(f"cannot load fabric entry file {target!r}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(target)
    fn = getattr(module, attr)
    res = fn(**(kwargs or {}))
    if callable(res):
        res = {"compute": res}
    if not (isinstance(res, dict) and callable(res.get("compute"))):
        raise ValueError(
            f"fabric entry {entry!r} must return a compute callable or a "
            "dict with a 'compute' callable")
    return res


#: the bundled demo design: the reference's ``designs/spar_demo.yaml``
#: in the JSON form the port reads (the card's machine has no PyYAML)
DEMO_DESIGN = os.path.join(_repo_root(), "tests", "fixtures", "torch_port",
                           "design_spar.json")


def demo_entry(out_keys=("PSD", "X0", "status"), n=256, seed=0,
               design=None, device=None, **_):
    """Built-in entry over the bundled spar design (the CLI quick start
    and the chip script use it): the port's case evaluator of
    ``design`` (default :data:`DEMO_DESIGN`; any ``.json`` / ``.yaml``
    path) on ``device``, and a deterministic (Hs, Tp, beta) case batch
    of ``n`` rows — the reference's draws from ``seed``."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.parallel.sweep import case_compute

    model = Model(design or DEMO_DESIGN)
    evaluate = api.make_case_evaluator(model, device=device)
    rng = np.random.default_rng(seed)
    cases = {
        "Hs": rng.uniform(2.0, 8.0, int(n)),
        "Tp": rng.uniform(6.0, 14.0, int(n)),
        "beta": rng.uniform(-0.5, 0.5, int(n)),
    }
    return {"compute": case_compute(evaluate, out_keys=tuple(out_keys)),
            "cases": cases}


# ----------------------------------------------------------------- worker


def _process_age_s():
    """Seconds since this process started (Linux ``/proc``; None where
    it cannot be read): a worker's start-up, interpreter and imports
    included."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return time.time() - (btime + start_ticks
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return None


class _Renewer(threading.Thread):
    """Daemon thread renewing the held lease (+ touching the worker's
    status file) every ``ttl/3`` while a shard evaluates.  The
    ``lease_expire:lease_renew`` fault silences it permanently — the
    wedged-but-alive worker the straggler rules exist for."""

    def __init__(self, ledger, shard, silenced):
        super().__init__(name=f"raft-tpu-lease-{shard}", daemon=True)
        self.ledger = ledger
        self.shard = shard
        self.silenced = silenced  # 1-element list shared with the worker
        ttl = float(config.get("FABRIC_TTL_S"))
        self.interval_s = max(ttl / 3.0, 0.05)
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            if not self.silenced[0] and faults.take("lease_expire",
                                                    "lease_renew"):
                self.silenced[0] = True
            if self.silenced[0]:
                continue
            try:
                self.ledger.renew(self.shard)
                self.ledger.touch_worker()
            except Exception:
                pass  # renewal must never kill the evaluation

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)


class Worker:
    """One fabric worker: claims shards from the ledger of ``out_dir``
    and evaluates them until the ledger is drained.  Run via
    :meth:`run` (CLI: ``python -m raft_tpu_torch.parallel.fabric
    worker``)."""

    def __init__(self, out_dir, worker_id=None):
        self.out_dir = out_dir
        self.worker_id = (worker_id or config.raw("WORKER_ID")
                          or "w-" + uuid.uuid4().hex[:6])
        # ambient worker stamp: every structured-log record this
        # process emits carries worker=<id> (per-worker report tables)
        os.environ[config.env_name("WORKER_ID")] = self.worker_id
        self.held = set()
        self.shards_done = 0
        self.shards_resumed = 0
        self.rows = 0
        self._renew_silenced = [False]

    def _setup_runtime(self, spec):
        """Pin what decides the bits to the spec's (the dtype policy),
        refuse multi-host wiring (ROADMAP A15(g)) and resolve the mesh:
        the CUDA devices after the health probe (never the CPU), or one
        CPU entry for a ``"cpu"`` spec."""
        dist = sorted(k for k, v in os.environ.items()
                      if k.startswith(config.PREFIX + "DIST")
                      and v.strip() not in ("", "0"))
        if dist:
            raise NotImplementedError(
                f"fabric worker started with {', '.join(dist)}: multi-host "
                "workers are not ported yet (ROADMAP A15(g)); run every "
                "worker on this host")
        if spec.get("dtype"):
            os.environ[config.env_name("DTYPE")] = spec["dtype"]
        from raft_tpu_torch.parallel.sweep import make_mesh

        if spec.get("device", "cuda") == "cpu":
            return make_mesh(device="cpu")
        return resilience.resolve_mesh(make_mesh)

    def run(self):
        """Join the sweep: claim/evaluate/release until every shard has
        a completion record.  Returns the number of shards this worker
        computed."""
        t0 = time.perf_counter()
        spec = load_spec(self.out_dir)
        self.spec = spec
        self.out_keys = list(spec["out_keys"])
        self.shard_size = int(spec["shard_size"])
        self.n_cases = int(spec["n_cases"])
        self.n_shards = int(spec["n_shards"])
        cases = load_cases(self.out_dir)
        resilience.validate_manifest(
            self.out_dir,
            resilience.compute_fingerprint(cases, self.out_keys,
                                           self.shard_size, mesh=None))
        self.cases = cases
        self.ledger = Ledger(self.out_dir, self.n_shards,
                             worker_id=self.worker_id)
        self.ledger.write_worker_status("starting")
        self.mesh = self._setup_runtime(spec)
        warm = {}
        if spec.get("warmup") and config.get("AOT") != "off":
            warm = self._warmup(spec["warmup"])
        kwargs = dict(spec.get("entry_kwargs") or {})
        kwargs.setdefault("device", spec.get("device", "cuda"))
        self.compute = resolve_entry(spec["entry"], kwargs)["compute"]
        counters0 = dict(metrics.snapshot()["counters"])
        self._counters0 = counters0
        startup = _process_age_s()
        # arm the flight recorder (no-op without RAFT_TPU_FLIGHT_DIR):
        # a killed worker leaves a black box with its last shards' spans
        from raft_tpu_torch.obs import flight

        flight.maybe_start()
        programs = dict(
            programs_loaded=counters0.get("aot_programs_loaded", 0),
            programs_compiled=counters0.get("aot_programs_compiled", 0))
        log_event("fabric_worker_start", out_dir=self.out_dir,
                  worker=self.worker_id, n_shards=self.n_shards,
                  device=str(self.mesh.devices.flat[0]),
                  startup_s=None if startup is None else round(startup, 3),
                  **programs, **warm)
        progress = {"out_dir": self.out_dir, "shards_done": 0,
                    "n_shards": self.n_shards}
        self.ledger.write_worker_status("ready", **programs, **warm)
        poll_s = float(config.get("FABRIC_POLL_S"))
        with maybe_heartbeat(devices=list(self.mesh.devices.flat),
                             progress=progress,
                             worker_id=self.worker_id,
                             leases=lambda: list(self.held)):
            while True:
                verdict, shard = self._scan_once()
                if verdict == "done":
                    break
                if verdict == "wait":
                    if not self._renew_silenced[0]:
                        self.ledger.touch_worker()
                    time.sleep(poll_s)
                    continue
                self._eval_shard(shard)
                progress["shards_done"] = self.shards_done

        from raft_tpu_torch.aot import bank

        # `programs` is this worker's kernel ledger (launches per solve
        # entry, its warm-up's included), folded fleet-wide by the
        # coordinator's assemble; the bank counters are absolute (the
        # warm-up predates counters0)
        programs = bank.ledger_summary()
        cnt = metrics.snapshot()["counters"]
        banked = dict(
            programs_loaded=cnt.get("aot_programs_loaded", 0),
            programs_compiled=cnt.get("aot_programs_compiled", 0))
        # the record's keys spelled out: the schema checker reads them
        self.ledger.write_worker_status(
            "done", counters=self._counter_delta(),
            shards_done=self.shards_done,
            shards_resumed=self.shards_resumed, rows=self.rows,
            programs=programs,
            programs_loaded=banked["programs_loaded"],
            programs_compiled=banked["programs_compiled"])
        log_event("fabric_worker_done", out_dir=self.out_dir,
                  worker=self.worker_id, shards_done=self.shards_done,
                  shards_resumed=self.shards_resumed, rows=self.rows,
                  wall_s=round(time.perf_counter() - t0, 3),
                  launches=sum(r["dispatches"] for r in programs), **banked)
        return self.shards_done

    def _warmup(self, warmup):
        """Push the entry's AOT warm-up spec through the program bank
        before the first claim (:func:`raft_tpu_torch.aot.warmup.
        warmup_model` on this worker's mesh): the process's first
        evaluation — the library's load, the lazy loading of the kernels
        it and torch launch — then happens here, not inside a leased
        shard.  A failure is logged, never fatal: the first shard then
        pays it.  Returns ``warmup_s`` and ``warmup_launches`` (the
        solve kernel's launches of the warm-up)."""
        from raft_tpu_torch.ops import linsolve

        t0 = time.perf_counter()
        l0 = linsolve.forward_launches()
        try:
            from raft_tpu_torch.aot.warmup import warmup_model

            warmup_model(
                design=warmup.get("design"),
                sizes=tuple(warmup.get("sizes") or (self.shard_size,)),
                kinds=tuple(warmup.get("kinds") or ("cases",)),
                out_keys=tuple(warmup.get("out_keys") or self.out_keys),
                mesh=self.mesh)
        except Exception as e:
            log_event("aot_error", error=f"fabric warmup failed: {e}"[:300])
        return {"warmup_s": round(time.perf_counter() - t0, 3),
                "warmup_launches": linsolve.forward_launches() - l0}

    def _shard_rows(self, shard):
        lo = shard * self.shard_size
        return min(lo + self.shard_size, self.n_cases) - lo

    def _counter_delta(self):
        """This worker's sweep-scoped counter deltas (published on
        EVERY status write, not just the final one — a worker killed
        mid-sweep must still contribute its completed shards' counters
        to the assembled metrics)."""
        cnt = metrics.snapshot()["counters"]
        return {k: v - self._counters0.get(k, 0) for k, v in cnt.items()
                if v - self._counters0.get(k, 0)}

    def _try_adopt(self, s, own_lease_ok=False):
        """Adopt an existing VALID shard file as done (resumed): done
        record, counters, ``shard_resume`` event.  False when the file
        is absent or corrupt (the caller decides whether to recompute).

        A shard under someone ELSE's lease is never adopted: its holder
        may be between ``atomic_savez`` and ``write_done``, and a racing
        ``resumed=True`` record would clobber the holder's richer one.
        ``own_lease_ok`` lets the post-claim check adopt under this
        worker's own fresh lease."""
        path = _shard_path(self.out_dir, s)
        if not os.path.exists(path):
            return False
        rec, _ = self.ledger.read_lease(s)
        if rec is not None and not (own_lease_ok
                                    and rec.get("token")
                                    == self.ledger.token):
            return False
        try:
            resilience.load_shard(path, self.out_keys,
                                  expect_rows=self._shard_rows(s))
        except resilience.ShardCorruptError:
            return False
        self.ledger.write_done(s, resumed=True, rows=self._shard_rows(s))
        self.shards_resumed += 1
        metrics.counter("shards_resumed").inc()
        log_event("shard_resume", shard=s, rows=self._shard_rows(s))
        return True

    def _scan_once(self):
        """One pass over the ledger.  Returns ``("claimed", s)`` /
        ``("wait", None)`` (work remains but every open shard is
        leased) / ``("done", None)``."""
        remaining = False
        n = self.n_shards
        pooled = None  # one worker_states read per PASS, not per shard
        # stagger scan starts per worker so a fresh fleet doesn't
        # serialize on the same O_EXCL races shard by shard
        start = (abs(hash(self.worker_id)) % n) if n else 0
        for i in range(n):
            s = (start + i) % n
            if self.ledger.has_done(s):
                continue
            if self._try_adopt(s):
                continue
            remaining = True
            if self.ledger.claim(s):
                return "claimed", s
            if pooled is None:
                pooled = self.ledger.pooled_walls()
            reason, age, holder, attempt = self.ledger.stealable(
                s, pooled=pooled)
            if reason and self.ledger.steal(s, reason, age, holder):
                if self.ledger.claim(s, attempt=attempt + 1):
                    return "claimed", s
        return ("wait", None) if remaining else ("done", None)

    def _eval_shard(self, s):
        if faults.take("worker_kill", "worker_shard"):
            # simulate a preempted/OOM-killed host: no cleanup, no
            # lease release — recovery is the OTHER workers' job
            os.kill(os.getpid(), signal.SIGKILL)
        path = _shard_path(self.out_dir, s)
        if self._try_adopt(s, own_lease_ok=True):
            # a double-compute race landed a valid shard between our
            # scan and our claim
            self.ledger.release(s)
            return
        if os.path.exists(path):
            # present but corrupt (truncated write of a dead worker):
            # requeue by recomputing under our fresh lease
            metrics.counter("shards_corrupt").inc()
            log_event("shard_corrupt", shard=s,
                      error=f"{path}: failed validation on claim")
            try:
                fsops.unlink(path)
            except OSError:
                pass
        self.held.add(s)
        renewer = _Renewer(self.ledger, s, self._renew_silenced)
        renewer.start()
        sl = slice(s * self.shard_size,
                   min((s + 1) * self.shard_size, self.n_cases))
        chunk = {k: v[sl] for k, v in self.cases.items()}
        try:
            out, entries, wall = resilience.evaluate_shard(
                self.compute, chunk, s, sl.start, self.mesh,
                max_retries=int(self.spec.get("max_retries", 3)),
                backoff_s=float(self.spec.get("backoff_s", 0.5)),
                quarantine_retry=bool(self.spec.get("quarantine_retry",
                                                    True)),
                on_result=lambda out_, _e: resilience.atomic_savez(
                    path, **out_))
            self.ledger.write_done(
                s, wall_s=round(wall, 3), rows=sl.stop - sl.start,
                attempt=self._lease_attempt(s),
                quarantined=sum(1 for e in entries
                                if not e.get("resolved")),
                flagged=int(len(resilience.flagged_rows(out))),
                entries=entries)
            self.shards_done += 1
            self.rows += sl.stop - sl.start
        finally:
            renewer.stop()
            self.held.discard(s)
            self.ledger.release(s)
        if not self._renew_silenced[0]:
            self.ledger.write_worker_status(
                "running", held=self.held, shards_done=self.shards_done,
                counters=self._counter_delta())

    def _lease_attempt(self, s):
        rec, _ = self.ledger.read_lease(s)
        return int((rec or {}).get("attempt") or 1)


# ------------------------------------------------------------ coordinator


def init_sweep(out_dir, entry, cases, out_keys, shard_size,
               entry_kwargs=None, warmup=None, max_retries=3,
               backoff_s=0.5, quarantine_retry=True, device="cuda"):
    """Write the sweep spec + case arrays + manifest so workers can
    join.  Never touches a device (a coordinator stays a cheap
    process); resuming against an existing out_dir is
    manifest-validated exactly like the serial runner.  ``device``
    (``"cuda"`` or ``"cpu"``) is where the workers run; the spec also
    carries the dtype policy (``RAFT_TPU_DTYPE``) and the entry's AOT
    ``warmup`` spec (``{"design", "sizes", "kinds", "out_keys"}``, each
    optional: the bundled spar demo, the shard size, ``cases``, the
    sweep's out_keys), which every worker runs before its first claim
    when ``RAFT_TPU_AOT`` is armed.  Returns the spec dict."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    cases = {k: np.asarray(v) for k, v in cases.items()}
    lengths = {k: len(v) for k, v in cases.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(
            f"ragged case dict: all case arrays must have equal length, "
            f"got {lengths}")
    n = next(iter(lengths.values()))
    n_shards = (n + shard_size - 1) // shard_size
    fsops.makedirs(fabric_dir(out_dir), exist_ok=True)
    fingerprint = resilience.compute_fingerprint(cases, out_keys,
                                                 shard_size, mesh=None)
    resilience.init_manifest(out_dir, fingerprint, n_shards)
    resilience._atomic_write(_cases_path(out_dir),
                             lambda f: np.savez(f, **cases))
    spec = {
        "version": 1,
        "entry": str(entry),
        "entry_kwargs": dict(entry_kwargs or {}),
        "out_keys": list(out_keys),
        "shard_size": int(shard_size),
        "n_cases": int(n),
        "n_shards": int(n_shards),
        "device": device,
        "dtype": config.get("DTYPE") or None,
        "warmup": dict(warmup) if warmup else None,
        "max_retries": int(max_retries),
        "backoff_s": float(backoff_s),
        "quarantine_retry": bool(quarantine_retry),
    }
    resilience._atomic_json(_spec_path(out_dir), spec)
    Ledger(out_dir, n_shards)  # create the ledger directories
    log_event("fabric_init", out_dir=out_dir, n_cases=n,
              n_shards=n_shards, shard_size=int(shard_size),
              entry=str(entry))
    return spec


def _worker_device_env(index, workers):
    """Per-worker accelerator pinning: slice a CUDA_VISIBLE_DEVICES
    list round-robin when the parent exposes one with at least one
    card per worker; otherwise nothing (with one card every worker
    lands on ``cuda:0``; CPU workers need nothing)."""
    for var in ("CUDA_VISIBLE_DEVICES", "HIP_VISIBLE_DEVICES"):
        raw = os.environ.get(var, "")
        devs = [d for d in raw.split(",") if d.strip()]
        if len(devs) >= workers > 1:
            return {var: ",".join(devs[index::workers])}
    return {}


def spawn_worker(out_dir, index=0, worker_id=None, env=None,
                 workers_total=1):
    """Spawn one worker subprocess against ``out_dir``'s ledger.
    stdout/stderr land in ``_fabric/workers/<wid>.log``.  Returns
    ``(Popen, worker_id)``."""
    wid = worker_id or f"w{index}"
    wenv = dict(os.environ)
    wenv.update(_worker_device_env(index, int(workers_total)))
    # telemetry linkage: pin the coordinator's run id into every worker
    # so their records and heartbeats join the parent run, and hand
    # them the enclosing sweep span as traceparent so worker shard
    # spans resolve into the coordinator's trace
    wenv.update(propagation_env())
    wenv.update(env or {})
    wenv[config.env_name("WORKER_ID")] = wid
    root = _repo_root()
    old_pp = wenv.get("PYTHONPATH", "")
    wenv["PYTHONPATH"] = root + (os.pathsep + old_pp if old_pp else "")
    # worker-targeted fault kinds go to exactly one worker
    fspecs = wenv.get(config.env_name("FAULTS"), "")
    if fspecs and index != int(config.get("FABRIC_FAULT_WORKER")):
        kept = [s for s in fspecs.split(",") if s.strip()
                and s.strip().split(":")[0] not in ("worker_kill",
                                                    "lease_expire")]
        wenv[config.env_name("FAULTS")] = ",".join(kept)
    fsops.makedirs(_workers_dir(out_dir), exist_ok=True)
    logf = open(os.path.join(_workers_dir(out_dir), f"{wid}.log"), "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.parallel.fabric",
             "worker", "--out-dir", os.path.abspath(out_dir),
             "--worker-id", wid],
            env=wenv, stdout=logf, stderr=subprocess.STDOUT, cwd=root)
    finally:
        logf.close()  # the child keeps its own handle
    log_event("fabric_worker_spawn", out_dir=out_dir, worker=wid,
              pid=proc.pid)
    return proc, wid


def _log_tail(out_dir, wid, n=12):
    try:
        with open(os.path.join(_workers_dir(out_dir), f"{wid}.log"),
                  errors="replace") as f:
            return [ln.rstrip() for ln in f.readlines()[-n:]]
    except OSError:
        return []


def run_fabric(out_dir, workers, entry, cases=None, entry_kwargs=None,
               out_keys=("PSD", "X0"), shard_size=256, warmup=None,
               on_shard=None, worker_env=None, max_retries=3,
               backoff_s=0.5, quarantine_retry=True, device="cuda"):
    """Coordinator: initialize the ledger, spawn ``workers`` local
    worker subprocesses on ``device`` (``"cuda"`` or ``"cpu"``), wait
    for the ledger to drain, assemble.

    ``cases=None`` resolves the entry in-process (on ``device``) and
    takes the case arrays from its result dict (the pure-CLI path).
    Returns the concatenated result dict, exactly like the serial
    :func:`~raft_tpu_torch.parallel.resilience.run_checkpointed` — same
    shards, same manifest, same quarantine.json, bit-identical values.
    Every spawned worker is waited for (terminated past its time) before
    this returns or raises."""
    t0 = time.perf_counter()
    if cases is None:
        kwargs = dict(entry_kwargs or {})
        kwargs.setdefault("device", device)
        res = resolve_entry(entry, kwargs)
        cases = res.get("cases")
        if cases is None:
            raise ValueError(
                f"fabric entry {entry!r} returned no case arrays; pass "
                "cases= explicitly or make the entry return "
                "{'compute': ..., 'cases': ...}")
        warmup = warmup if warmup is not None else res.get("warmup")
    spec = init_sweep(out_dir, entry, cases, out_keys, shard_size,
                      entry_kwargs=entry_kwargs, warmup=warmup,
                      max_retries=max_retries, backoff_s=backoff_s,
                      quarantine_retry=quarantine_retry, device=device)
    n_shards = spec["n_shards"]
    log_event("sweep_start", out_dir=out_dir, n_cases=spec["n_cases"],
              n_shards=n_shards, shard_size=spec["shard_size"],
              out_keys=list(out_keys), mesh_shape=[])
    with span("sweep", out_dir=out_dir, n_cases=spec["n_cases"],
              n_shards=n_shards, fabric_workers=int(workers)):
        ledger = Ledger(out_dir, n_shards)
        procs = []
        try:
            for i in range(int(workers)):
                procs.append(spawn_worker(out_dir, index=i, env=worker_env,
                                          workers_total=int(workers)))
            _wait_drained(out_dir, ledger, n_shards, procs, on_shard)
        finally:
            _reap(out_dir, procs)
        out = assemble(out_dir, spec, wall_s=time.perf_counter() - t0)
    return out


def _wait_drained(out_dir, ledger, n_shards, procs, on_shard):
    """Poll the ledger until every shard has a done record; raise
    :class:`FabricError` when every worker exited first."""
    poll_s = float(config.get("FABRIC_POLL_S"))
    reported = set()

    def report_progress():
        for s in sorted(set(range(n_shards)) - reported):
            if not ledger.has_done(s):
                continue
            reported.add(s)
            if on_shard is not None:
                rec = ledger.read_done(s) or {}
                on_shard(len(reported), n_shards,
                         not rec.get("resumed", False))

    while True:
        report_progress()
        if len(reported) >= n_shards:
            return
        if all(p.poll() is not None for p, _ in procs):
            report_progress()
            if len(reported) >= n_shards:
                return
            tails = {wid: _log_tail(out_dir, wid) for _, wid in procs}
            raise FabricError(
                f"all {len(procs)} workers exited with "
                f"{n_shards - len(reported)}/{n_shards} shards "
                f"incomplete; worker log tails: "
                + json.dumps(tails)[:2000])
        time.sleep(poll_s)


def _reap(out_dir, procs):
    """Wait for every spawned worker (terminate, then kill, one that
    outlives its grace) and log its exit."""
    for p, wid in procs:
        try:
            rc = p.wait(timeout=max(
                10.0, 3 * float(config.get("FABRIC_TTL_S"))))
        except subprocess.TimeoutExpired:
            p.terminate()
            try:
                rc = p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
        log_event("fabric_worker_exit", out_dir=out_dir, worker=wid,
                  returncode=rc)


def assemble(out_dir, spec=None, wall_s=None):
    """Validate every shard, merge worker quarantine/metrics records
    into the standard artifacts (quarantine.json, manifest statuses,
    metrics.json), write the run record and return the concatenated
    result dict."""
    t0 = time.perf_counter()
    spec = spec or load_spec(out_dir)
    out_keys = list(spec["out_keys"])
    n_shards = int(spec["n_shards"])
    n_cases = int(spec["n_cases"])
    shard_size = int(spec["shard_size"])
    ledger = Ledger(out_dir, n_shards)
    try:
        with open(resilience._manifest_path(out_dir)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise FabricError(f"unreadable manifest in {out_dir}: {e}") from e
    manifest.setdefault("shards", {})

    results = []
    n_quarantined = 0
    n_flagged = 0
    for s in range(n_shards):
        rows = min((s + 1) * shard_size, n_cases) - s * shard_size
        try:
            out = resilience.load_shard(_shard_path(out_dir, s), out_keys,
                                        expect_rows=rows)
        except resilience.ShardCorruptError as e:
            raise FabricError(
                f"assembly found shard {s} missing/corrupt: {e}") from e
        rec = ledger.read_done(s) or {}
        entries = rec.get("entries") or []
        # only shards COMPUTED this run re-judge their quarantine
        # entries; an adopted (resumed) shard carries no entries in its
        # done record, and replacing its slice with [] would erase the
        # prior run's audit while the bad rows are still in the shard
        if not rec.get("resumed") and (
                entries or os.path.exists(
                    resilience._quarantine_path(out_dir))):
            resilience.record_quarantine(out_dir, s, entries)
        # same accounting as a serial resume: rows still bad in the
        # stored shard are this sweep's quarantined rows
        bad = len({int(i) for i in resilience.nonfinite_rows(out)}
                  | {int(i) for i in resilience.flagged_rows(out)})
        flagged = len(resilience.flagged_rows(out))
        n_quarantined += bad
        n_flagged += flagged
        srec = {"status": "done", "file": f"shard_{s:04d}.npz",
                "rows": rows, "quarantined": bad, "flagged": flagged}
        for k in ("worker", "wall_s", "attempt", "resumed"):
            if rec.get(k) is not None:
                srec[k] = rec[k]
        manifest["shards"][str(s)] = srec
        results.append(out)

    # fold every worker's sweep-delta counters into this process's
    # registry and into metrics.json
    states = ledger.worker_states()
    counters = {}
    for st in states.values():
        for k, v in (st.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
    for k, v in counters.items():
        metrics.counter(k).inc(v)
    pooled = ledger.pooled_walls()
    from raft_tpu_torch.aot import bank

    snap = {
        "counters": counters,
        "gauges": {},
        "histograms": {"shard_wall_s": pooled.snapshot()},
        "workers": {wid: {k: st.get(k) for k in
                          ("state", "shards_done", "shards_resumed",
                           "rows", "programs_loaded", "programs_compiled",
                           "pid", "host")}
                    for wid, st in states.items()},
        # fleet-wide kernel ledger: every worker's launches per solve
        # entry merged
        "programs": bank.merge_ledgers(
            [st.get("programs") for st in states.values()]),
    }
    manifest["metrics"] = snap
    resilience._atomic_json(resilience._manifest_path(out_dir), manifest)
    try:
        resilience._atomic_json(os.path.join(out_dir,
                                             resilience.METRICS_NAME), snap)
    except OSError:
        pass  # telemetry must not fail the sweep that produced it
    prom_path = config.get("METRICS")
    if prom_path:
        metrics.export(prom_path)
    log_event("fabric_assemble", out_dir=out_dir, n_shards=n_shards,
              n_workers=len(states), n_quarantined=n_quarantined,
              n_flagged=n_flagged,
              wall_s=round(time.perf_counter() - t0, 3))
    log_event("sweep_done", out_dir=out_dir, n_cases=n_cases,
              n_quarantined=n_quarantined, n_flagged=n_flagged,
              wall_s=round(wall_s if wall_s is not None
                           else time.perf_counter() - t0, 3))
    # the run record of the fabric-assembled sweep, as the serial path
    # writes one (the registry now holds the folded worker counters)
    from raft_tpu_torch.obs import runs as obs_runs

    obs_runs.maybe_record(
        "sweep", label=os.path.basename(os.path.normpath(out_dir)),
        wall_s=(wall_s if wall_s is not None
                else time.perf_counter() - t0),
        extra={"n_cases": n_cases, "n_shards": n_shards,
               "n_workers": len(states), "n_quarantined": n_quarantined,
               "n_flagged": n_flagged})
    return {k: np.concatenate([r[k] for r in results]) for k in out_keys}


# -------------------------------------------------------------------- CLI


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.parallel.fabric",
        description="elastic multi-worker sweep fabric")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("worker", help="join a sweep as one worker")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--worker-id", default=None)

    p = sub.add_parser("run", help="coordinate N local workers")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--entry",
                   default="raft_tpu_torch.parallel.fabric:demo_entry",
                   help="module:callable or path.py:callable returning "
                        "{'compute', 'cases'} (default: bundled spar demo)")
    p.add_argument("--entry-kwargs", default="{}",
                   help="JSON kwargs for the entry callable")
    p.add_argument("--out-keys", default="PSD,X0,status")
    p.add_argument("--shard", type=int, default=64)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the workers run (default: the card)")

    p = sub.add_parser("status", help="print the ledger summary")
    p.add_argument("--out-dir", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "worker":
        Worker(args.out_dir, worker_id=args.worker_id).run()
        return 0
    if args.cmd == "run":
        out = run_fabric(args.out_dir, workers=args.workers,
                         entry=args.entry,
                         entry_kwargs=json.loads(args.entry_kwargs),
                         out_keys=tuple(args.out_keys.split(",")),
                         shard_size=args.shard, device=args.device)
        print(json.dumps({k: list(np.asarray(v).shape)
                          for k, v in out.items()}))
        return 0
    if args.cmd == "status":
        spec = load_spec(args.out_dir)
        print(json.dumps(Ledger(args.out_dir,
                                spec["n_shards"]).summary(), indent=1))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())

"""The port's registry of ``RAFT_TPU_*`` environment flags.

Main-path flags, the evaluation service's and its alert engine's, and
the flags of the checkpointed sweeps, their worker fabric and their telemetry
(structured log, heartbeat, metrics export, flight recorder, run
records, fault injection, escalation ladder, profiler), under the same environment names, kinds and defaults as
``raft_tpu/utils/config.py`` so that one environment drives both
packages in the parity tests.  Flags are re-read on every :func:`get`
(tests change them mid-process); :func:`raw` is the raw string for the
modules with their own parsing (fault specs, log sinks, ids).

``SOLVER`` has no ``pallas`` choice here: on a CUDA tensor ``native``
is the hand-written kernel (:mod:`raft_tpu_torch.ops.linsolve`).  The
program bank's flags (``AOT``, ``AOT_DIR``, ``AOT_MISS``,
``COMPILE_BUDGET``, ``COMPILE_BUDGET_ACTION``) keep the reference's
names and choices with the port's meanings (:mod:`raft_tpu_torch.aot.
bank`); an empty ``AOT_DIR`` means a directory of the port's own
(:func:`raft_tpu_torch.aot.bank.aot_root`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

PREFIX = "RAFT_TPU_"


@dataclass(frozen=True)
class Flag:
    """One registered flag (``name`` is the ``RAFT_TPU_``-less suffix)."""

    name: str
    kind: str = "str"          # str | int | float | bool | choice | raw
    default: object = None
    choices: tuple = ()
    help: str = ""
    aliases: dict = field(default_factory=dict)

    @property
    def env(self):
        return PREFIX + self.name


FLAGS: dict[str, Flag] = {}

DTYPE_F32_NAMES = ("float32", "f32", "single", "complex64")
DTYPE_F64_NAMES = ("float64", "f64", "double", "complex128")


def _register(*flags):
    for f in flags:
        FLAGS[f.name] = f


def env_name(name):
    """The full environment-variable name of a registered flag."""
    return FLAGS[name].env


def raw(name):
    """Raw string value of a registered flag (None when unset)."""
    return os.environ.get(FLAGS[name].env)


#: the flags that shape the numbers the port's evaluators compute (the
#: reference's ``_flags_key`` in ``raft_tpu/parallel/sweep.py``, less
#: ``FIXED_POINT``, which the port does not have): every result-cache key
#: of the service folds them in, so a flag flip never serves stale rows
EVALUATOR_FLAGS = ("SOLVER", "SCAN_CHUNK", "DTYPE", "COND_CHECK",
                   "COND_THRESHOLD", "ITER_SCALE", "FUSED")


def flags_key():
    """The values of :data:`EVALUATOR_FLAGS` now, as a tuple."""
    return tuple(get(k) for k in EVALUATOR_FLAGS)


def get(name):
    """Typed, validated value of a registered flag.

    Bad values raise ``ValueError`` naming the variable; unknown flag
    names raise ``KeyError``."""
    f = FLAGS[name]
    s = os.environ.get(f.env)
    if s is None or (s == "" and f.kind != "str"):
        return f.default
    if f.kind in ("str", "raw"):
        return s
    if f.kind in ("int", "float"):
        try:
            return int(s) if f.kind == "int" else float(s)
        except ValueError:
            raise ValueError(f"{f.env}={s!r}: expected a number")
    if f.kind == "bool":
        v = s.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{f.env}={s!r}: expected a boolean (0/1)")
    v = s.strip().lower()
    v = f.aliases.get(v, v)
    if v not in f.choices:
        raise ValueError(f"{f.env}={v!r}: expected one of "
                         + "/".join(repr(c) for c in f.choices if c))
    return v


_register(
    Flag("SOLVER", "choice", "native", choices=("native", "lapack"),
         help="impedance solve: 'native' (the hand-written CUDA kernel "
              "on a CUDA tensor, its plain PyTorch version on a CPU "
              "tensor) or 'lapack' (torch.linalg.solve)"),
    Flag("FUSED", "choice", "on", choices=("on", "off"),
         help="take the response from the drag fixed point's final "
              "solve ('on') or re-stage drag_excitation + a second "
              "solve ('off', the parity oracle)"),
    Flag("DTYPE", "choice", "", choices=("", "float32", "float64"),
         aliases={**{a: "float32" for a in DTYPE_F32_NAMES},
                  **{a: "float64" for a in DTYPE_F64_NAMES}},
         help="compute-dtype policy (default: derive from the inputs)"),
    Flag("SCAN_CHUNK", "int", 4,
         help="drag fixed-point trips between all-rows-done checks"),
    Flag("ITER_SCALE", "int", 1,
         help="iteration-budget multiplier for the statics Newton and "
              "the drag fixed point"),
    Flag("COND_CHECK", "bool", False,
         help="fold a one-step Hager condition estimate of Z(w) into "
              "the status word (ILL_CONDITIONED_Z)"),
    Flag("COND_THRESHOLD", "float", 1e7,
         help="kappa_1(Z) estimate above which ILL_CONDITIONED_Z is set"),
    Flag("BUCKET_ROWS", "int", 512,
         help="rows per dispatched bucket chunk in sweep_heterogeneous "
              "and the design/case evaluators (0 = unlimited)"),
    Flag("BUCKET_STEPS", "str",
         "strips=16,24,32,48,64,96,128;nodes=pow2;lines=pow2",
         help="per-axis shape-bucket pad ladders: ';'-separated "
              "axis=rungs entries where rungs is an ascending comma list "
              "(doubling continues past the last rung) or 'pow2' "
              "(power-of-two ceiling at the axis floor)"),
    Flag("BEM_DIR", "str", "",
         help="panel-solver coefficient cache directory (default: "
              "_bem_cache in the working directory)"),
    # -- program bank (raft_tpu_torch.aot)
    Flag("AOT", "choice", "off", choices=("off", "load", "require"),
         help="program bank: 'load' consults the bank before a sweep "
              "or serving program's first run in the process (a hit "
              "loads the bank's copy of the kernel library; a miss "
              "runs the program and stores its entry for the next "
              "process); 'require' additionally treats a miss per "
              "RAFT_TPU_AOT_MISS (serving mode: start-up builds "
              "nothing); 'off' (default) reads and writes no file"),
    Flag("AOT_DIR", "str", "",
         help="program-bank root (default: ~/.cache/raft_tpu_torch/"
              "aot_bank): the port's entries live in its "
              "torch-v<format>/ and its releases in torch-releases/, "
              "so one root can hold the JAX package's bank beside it"),
    Flag("AOT_MISS", "choice", "error", choices=("error", "compile"),
         help="what RAFT_TPU_AOT=require does on a bank miss: 'error' "
              "raises BankMissError before the program runs; 'compile' "
              "logs the miss, builds and stores the program"),
    Flag("COMPILE_BUDGET", "int", -1,
         help="ceiling on program builds per process (-1 disables): "
              "bank misses that built a program plus nvcc runs of the "
              "kernel library.  A fresh process on a warm bank under "
              "RAFT_TPU_AOT=require holds 0"),
    Flag("COMPILE_BUDGET_ACTION", "choice", "error",
         choices=("error", "warn"),
         help="a build past RAFT_TPU_COMPILE_BUDGET raises "
              "CompileBudgetError before it starts ('error') or only "
              "logs + counts ('warn')"),
    # -- evaluation service (raft_tpu_torch.serve)
    Flag("SERVE_TICK_MS", "float", 20.0,
         help="continuous-batching tick CEILING: pending requests "
              "coalesce into one bucketed dispatch per (signature, "
              "tick).  Under RAFT_TPU_SERVE_TICK_MODE=adaptive this is "
              "the window under sustained load; light load shrinks the "
              "window toward RAFT_TPU_SERVE_TICK_MIN_MS"),
    Flag("SERVE_TICK_MIN_MS", "float", 1.0,
         help="adaptive-tick floor: with a near-empty queue the "
              "coalescing window shrinks to this, so a lone light-load "
              "request waits ~this long instead of the full tick "
              "(adaptive mode only)"),
    Flag("SERVE_TICK_MODE", "choice", "adaptive",
         choices=("adaptive", "fixed"),
         help="serve tick policy: 'adaptive' scales the coalescing "
              "window between SERVE_TICK_MIN_MS and SERVE_TICK_MS with "
              "the recent per-tick row load and dispatches early when a "
              "bucket group fills a top ladder rung; 'fixed' keeps the "
              "constant SERVE_TICK_MS window"),
    Flag("SERVE_LADDER", "str", "cost",
         help="serve batch-ladder policy: 'pow2' (1,2,4,... up to "
              "SERVE_MAX_BATCH), 'cost' (pow2 candidates warmed, then "
              "rungs whose measured dispatch wall is flat vs the next "
              "rung are pruned after warmup), or an explicit ascending "
              "comma list of rung sizes"),
    Flag("SERVE_LADDER_TOL", "float", 1.15,
         help="cost-ladder flatness tolerance: rung r is pruned when "
              "the next rung's measured per-dispatch wall is within "
              "this factor of r's"),
    Flag("SERVE_MAX_BATCH", "int", 64,
         help="largest padded batch one serving dispatch holds; the "
              "batch ladder is 1,2,4,... up to this"),
    Flag("SERVE_CACHE_MB", "float", 64.0,
         help="byte budget of the content-addressed result cache "
              "(design hash + case + out_keys -> outputs, LRU)"),
    Flag("SERVE_QUEUE", "int", 1024,
         help="admission-queue bound: requests past this many pending "
              "get 503 (backpressure) instead of an unbounded backlog"),
    Flag("SERVE_QPS", "float", 0.0,
         help="per-client token-bucket sustained rate (requests/s); "
              "0 disables quotas.  An over-quota client gets 429 with "
              "Retry-After"),
    Flag("SERVE_BURST", "float", 32.0,
         help="per-client token-bucket burst capacity"),
    Flag("SERVE_TIMEOUT_S", "float", 300.0,
         help="per-request evaluation timeout at the HTTP layer (408)"),
    Flag("SERVE_DRAIN_S", "float", 120.0,
         help="graceful-shutdown budget: SIGTERM finishes in-flight "
              "ticks and open responses within this window"),
    Flag("SERVE_SLO_MS", "float", 0.0,
         help="per-request latency SLO in milliseconds (0 disables): a "
              "request resolving slower than this increments the "
              "serve_slo_breaches counter and emits an slo_breach "
              "event"),
    Flag("SERVE_CLIENT_RETRIES", "int", 0,
         help="serve-client retry budget for clean 429/503 rejections "
              "(capped exponential backoff honoring Retry-After; 0 "
              "disables)"),
    # -- alert-rule engine (raft_tpu_torch.obs.alerts)
    Flag("ALERT_EVAL_S", "float", 0.0,
         help="alert-rule evaluation period in seconds (0 disables: no "
              "thread, no state): a daemon evaluates the rule pack "
              "against the live metrics registry, emitting "
              "alert_fire/alert_resolve events, the alerts_active "
              "gauge and the RAFT_TPU_ALERTS sink; state is served at "
              "GET /alerts"),
    Flag("ALERT_RULES", "str", "",
         help="YAML/JSON rule file loaded over the default alert pack "
              "(same-name rules replace, 'disabled: true' removes, "
              "top-level 'default_pack: false' starts empty); validate "
              "with `python -m raft_tpu_torch.obs alerts check`"),
    Flag("ALERTS", "str", "",
         help="JSONL sink path for alert fire/resolve records (one "
              "appended line per transition; unset = no sink)"),
    # -- checkpointed sweeps (raft_tpu_torch.parallel.resilience)
    Flag("ESCALATE", "choice", "off", choices=("off", "retol", "f64_cpu"),
         help="escalation ladder for status-flagged sweep rows: 'retol' "
              "re-solves with ESCALATE_ITER_SCALE x the iteration "
              "budget, 'f64_cpu' additionally retries under float64 on "
              "the CPU"),
    Flag("ESCALATE_ITER_SCALE", "int", 4,
         help="RAFT_TPU_ITER_SCALE applied by the escalation rungs"),
    Flag("PROBE_S", "float", 300.0,
         help="accelerator health-probe timeout (seconds)"),
    Flag("FAULTS", "raw", "",
         help="deterministic fault injection: comma list of "
              "kind:site[:count] specs (see raft_tpu_torch.utils.faults)"),
    Flag("FABRIC_WORKERS", "int", 0,
         help="route checkpointed sweeps through N local fabric worker "
              "subprocesses claiming shards from the lease ledger "
              "(0/1 = serial in-process path; needs a fabric entry "
              "spec on the evaluator, raft_tpu_torch.parallel.fabric)"),
    Flag("FABRIC_TTL_S", "float", 30.0,
         help="shard lease time-to-live: a lease not renewed within "
              "this window is expired and the shard is stealable "
              "(a dead worker is just an expired lease)"),
    Flag("FABRIC_STEAL_MULT", "float", 4.0,
         help="straggler steal threshold: a lease older than this "
              "multiple of the pooled shard_wall_s p95 is stealable "
              "even while still being renewed"),
    Flag("FABRIC_POLL_S", "float", 0.5,
         help="fabric ledger poll period for idle workers and the "
              "coordinator wait loop"),
    Flag("FABRIC_FAULT_WORKER", "int", 0,
         help="index of the ONE spawned worker that receives the "
              "worker-targeted RAFT_TPU_FAULTS kinds (worker_kill, "
              "lease_expire); other workers get them stripped so the "
              "kill-a-worker test is deterministic"),
    Flag("WORKER_ID", "raw", "",
         help="fabric worker id stamped as 'worker' on every "
              "structured-log record"),
    Flag("PROFILE", "str", "",
         help="when set, a checkpointed sweep writes a torch.profiler "
              "Chrome trace into this directory; telemetry spans mirror "
              "onto the profiler timeline as record_function ranges"),
    # -- telemetry (raft_tpu_torch.obs, raft_tpu_torch.utils.structlog)
    Flag("LOG", "raw", "",
         help="structured-log sink: '-' for stderr, a JSONL path, or a "
              "DIRECTORY (existing, or written with a trailing slash) — "
              "each process then appends to its own "
              "<dir>/trace-<pid>.jsonl shard"),
    Flag("RUN_ID", "raw", "",
         help="telemetry run id stamped on every structured-log record "
              "(default: a fresh uuid per process)"),
    Flag("TRACEPARENT", "raw", "",
         help="W3C traceparent (00-<trace>-<span>-01) inherited from a "
              "parent process: the first root span of this process "
              "joins that trace"),
    Flag("HEARTBEAT_S", "float", 0.0,
         help="device-heartbeat sampling period in seconds (0 disables): "
              "a daemon thread emits per-device allocator bytes and "
              "shard progress as 'heartbeat' events + gauges"),
    Flag("METRICS", "str", "",
         help="when set, the metrics registry is exported in Prometheus "
              "text format to this path at sweep_done"),
    Flag("SERVE_WINDOW_S", "float", 60.0,
         help="sliding-window length of the metrics windows a heartbeat "
              "reports"),
    Flag("FLIGHT_RING", "int", 4096,
         help="flight-recorder ring capacity in records (0 disables)"),
    Flag("FLIGHT_DIR", "str", "",
         help="flight-dump shard directory: periodic flushes and "
              "trigger dumps land there"),
    Flag("FLIGHT_FLUSH_S", "float", 2.0,
         help="period of the background flight-ring flush to "
              "RAFT_TPU_FLIGHT_DIR"),
    Flag("FLIGHT_SNAP_S", "float", 10.0,
         help="period of the flight ring's metric-snapshot delta records"),
    Flag("EXEMPLAR_K", "int", 2,
         help="exemplars kept per histogram log-bucket (0 disables)"),
    Flag("EXEMPLAR_MIN_S", "float", 0.0,
         help="minimum observed value for exemplar admission"),
    # -- run-record store (raft_tpu_torch.obs.runs)
    Flag("RUNS_DIR", "str", "",
         help="append-only run-record store directory: when set, every "
              "checkpointed-sweep session ends by writing a "
              "schema-versioned run record (env fingerprint, metrics "
              "snapshot, kernel launch ledger) there; `python -m "
              "raft_tpu_torch.obs runs {list,compare,regress}` read it. "
              "Unset (default) disables recording"),
    Flag("RUNS_REL_TOL", "float", 0.5,
         help="when SET, overrides every watch rule's relative "
              "worsening tolerance in `obs runs regress` (a watched "
              "metric regresses only past max(rel_tol x |baseline|, abs "
              "floor)); unset, the per-rule tolerances apply. "
              "`--rel-tol` outranks both"),
    Flag("RUNS_ABS_FLOOR", "float", 1.0,
         help="global multiplier on the per-rule minimum-absolute-"
              "delta floors of `obs runs regress`"),
)

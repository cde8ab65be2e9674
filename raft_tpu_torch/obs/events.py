"""Registry of every structured-log event and span name the port emits
(counterpart of ``raft_tpu/obs/events.py``, under the reference's names
and payload fields wherever the port emits the same event).

A typo'd event name does not crash anything — it silently splits an
event stream in two, and every consumer (the report CLI, the Chrome
trace exporter, a grep) sees only half the story.  This module is the
single source of truth: every ``log_event("<name>", ...)`` and
``span("<name>", ...)`` call site in ``raft_tpu_torch`` uses a name
registered here (held by ``tests/test_torch_obs_report.py``).

Each entry maps the event name to its schema: the payload fields the
emitter promises (beyond the universal stamps ``t``/``event``/``pid``/
``run_id`` and, inside a span, ``trace_id``/``span_id`` — see
:mod:`raft_tpu_torch.utils.structlog`) and a one-line description.

Pure stdlib — the report/trace CLIs import this without touching torch.
"""

from __future__ import annotations

#: name -> (fields tuple, help).  Fields are the emitter's documented
#: payload keys; optional keys are suffixed with ``?``.
EVENTS: dict[str, tuple[tuple[str, ...], str]] = {
    # --------------------------------------------------------- telemetry
    "proc_start": (
        ("unix_t", "argv0"),
        "per-(process, sink) clock anchor: unix_t is the wall-clock "
        "instant of this record's monotonic t, letting `obs trace "
        "--merge` normalize every process onto one shared timeline"),
    "span_begin": (
        ("name", "parent_id", "remote_parent?", "links?"),
        "a telemetry span opened (obs.span); attrs ride along verbatim "
        "(remote_parent marks a root adopted from traceparent "
        "propagation; links name coalesced request spans)"),
    "span_end": (
        ("name", "wall_s", "ok", "error?"),
        "the matching span closed; error carries repr(exc) on failure"),
    "heartbeat": (
        ("devices", "live_arrays", "progress?", "worker_id?", "leases?",
         "windows?", "host_rss_bytes?", "host_rss_peak_bytes?"),
        "periodic device sampler: per-device allocator bytes (no "
        "live-buffer count: live_arrays is null), sweep shard progress "
        "(RAFT_TPU_HEARTBEAT_S); fabric "
        "workers add their id and currently-held shard leases; serving "
        "processes add the sliding-window latency snapshots; on Linux "
        "each beat also carries the host process RSS/high-watermark "
        "(/proc/self/status, no psutil)"),
    "metrics_snapshot": (
        ("snapshot",),
        "full metrics-registry snapshot (emitted at sweep_done; also "
        "written to <out_dir>/metrics.json)"),
    "profile_start": (
        ("dir",),
        "torch.profiler capture started for a checkpointed sweep "
        "(RAFT_TPU_PROFILE)"),
    "profile_stop": (("dir",), "torch.profiler capture finished"),
    "profile_failed": (
        ("error",),
        "torch.profiler capture could not start/stop (logged, not "
        "fatal)"),
    "exemplar_recorded": (
        ("metric", "value"),
        "a histogram observation was admitted to a top-K-per-bucket "
        "exemplar slot (raft_tpu_torch.obs.metrics): the free-form rest of "
        "the payload carries the caller-stamped attrs — trace/span "
        "ids, design content hash, bucket signature, dispatched rows, "
        "cache-hit bit, replica id, int32 status word — and is the "
        "join key `obs report --tail` uses to render the actual tail "
        "request's span tree"),
    # ----------------------------------------------------- sweep runtime
    "dp_autopad": (
        ("rows", "pad", "dp"),
        "a ragged batch was padded to dp-divisibility with masked "
        "repeat rows (dropped again on gather) — warning-level: the "
        "caller is paying for rows it did not ask for"),
    "bucket_sweep": (
        ("rows", "n_buckets", "n_designs", "padding_waste_frac",
         "waste_by_axis?"),
        "heterogeneous sweep dispatched: designs auto-binned into "
        "shape buckets, one evaluator per bucket; waste_by_axis "
        "decomposes the row-weighted padding waste per padded axis "
        "(strips/nodes/lines/rows)"),
    "sweep_start": (
        ("out_dir", "n_cases", "n_shards", "shard_size", "out_keys",
         "mesh_shape"),
        "checkpointed sweep began"),
    "sweep_done": (
        ("out_dir", "n_cases", "n_quarantined", "n_flagged", "wall_s"),
        "checkpointed sweep finished"),
    "shard_start": (("shard", "rows"), "shard evaluation began"),
    "shard_done": (("shard", "rows", "wall_s"), "shard written"),
    "shard_resume": (
        ("shard", "rows"), "shard loaded from a valid checkpoint file"),
    "shard_corrupt": (
        ("shard", "error"),
        "checkpoint shard failed validation and was re-queued"),
    "shard_retry": (
        ("shard", "attempt", "max_retries", "delay_s", "error"),
        "transient shard failure; retrying with backoff"),
    "shard_oom_split": (
        ("shard", "rows", "split", "error"),
        "device OOM; shard batch halved and re-evaluated"),
    "shard_quarantine": (
        ("shard", "index", "keys", "recovered", "status", "reason"),
        "a non-finite or status-flagged row was judged"),
    "shard_quarantine_retry_failed": (
        ("shard", "index", "error"),
        "the solo CPU re-evaluation of a quarantined row raised"),
    "shard_escalate": (
        ("shard", "index", "rung", "status_before", "status_after",
         "resolved"),
        "one escalation-ladder rung re-solved a flagged row"),
    "shard_escalate_failed": (
        ("shard", "index", "rung", "error"),
        "an escalation rung raised instead of returning a result"),
    "backend_fallback_failed": (
        ("from_platform", "reason"),
        "the CUDA device failed its health probe (or none exists); the "
        "port raises instead of falling back to the CPU"),
    "manifest_mismatch": (
        ("out_dir", "fields", "fatal"),
        "resume fingerprint differs from manifest.json"),
    "quarantine_corrupt": (
        ("out_dir", "error"),
        "quarantine.json was unreadable (externally damaged)"),
    # ------------------------------------------------------ sweep fabric
    "fabric_init": (
        ("out_dir", "n_cases", "n_shards", "shard_size", "entry"),
        "fabric sweep spec + case arrays + lease ledger initialized "
        "under <out_dir>/_fabric (raft_tpu_torch.parallel.fabric)"),
    "fabric_worker_spawn": (
        ("out_dir", "worker", "pid"),
        "coordinator spawned one worker subprocess"),
    "fabric_worker_start": (
        ("out_dir", "worker", "n_shards", "device", "startup_s",
         "programs_loaded", "programs_compiled", "warmup_s?",
         "warmup_launches?"),
        "a fabric worker is ready to claim shards (after the torch "
        "import, its mesh resolution — the CUDA health probe on the "
        "card — its AOT warm-up when the entry names one and the bank "
        "is armed, and its entry's evaluator build; startup_s counts "
        "from the worker's first line; programs_* are the bank's "
        "counters so far, warmup_launches the warm-up's solve-kernel "
        "launches)"),
    "fabric_worker_done": (
        ("out_dir", "worker", "shards_done", "shards_resumed", "rows",
         "wall_s", "launches", "programs_loaded", "programs_compiled"),
        "a fabric worker found the ledger drained and exited cleanly; "
        "launches is its solve-kernel launches, every entry (its "
        "warm-up's included); programs_* are the bank's counters"),
    "fabric_worker_exit": (
        ("out_dir", "worker", "returncode"),
        "a spawned worker subprocess exited (nonzero returncode with "
        "the sweep incomplete means its leases will expire and be "
        "stolen)"),
    "shard_claim": (
        ("shard", "worker", "attempt"),
        "a worker claimed one shard lease (O_CREAT|O_EXCL on the "
        "lease file: exactly one claimant wins)"),
    "shard_steal": (
        ("shard", "worker", "from_worker", "reason", "age_s"),
        "an expired/stale/straggling lease was atomically removed so "
        "the shard can be re-claimed (reason: expired | holder_stale "
        "| straggler)"),
    "fabric_assemble": (
        ("out_dir", "n_shards", "n_workers", "n_quarantined",
         "n_flagged", "wall_s"),
        "coordinator validated every shard, merged worker quarantine "
        "records and wrote the final manifest/metrics"),
    "fabric_unavailable": (
        ("out_dir", "reason"),
        "RAFT_TPU_FABRIC_WORKERS requested but the sweep cannot run "
        "on the fabric (no entry spec on the evaluator); falling back "
        "to the serial in-process path"),
    # ------------------------------------------------------ program bank
    "aot_load": (
        ("kind", "key", "bytes", "wall_s"),
        "a bank entry answered this program: its payload's sha checked "
        "and, on the card, the bank's copy of the kernel library loaded "
        "— nothing built (raft_tpu_torch.aot.bank)"),
    "aot_miss": (
        ("kind", "key", "mode"),
        "no bank entry for this program key; 'require' mode raises "
        "BankMissError here unless RAFT_TPU_AOT_MISS=compile"),
    "aot_store": (
        ("kind", "key", "bytes", "compile_s"),
        "a program that missed was built and run, and its entry (the "
        "sidecar and the kernel library it ran) stored for the next "
        "process; compile_s is the wall of that first run"),
    "aot_unbankable": (
        ("kind",),
        "a sweep evaluator carries no program-identity stamp "
        "(_raft_program_key) and runs without the bank — make it with "
        "a raft_tpu_torch.api factory to make it bankable"),
    "aot_error": (
        ("error", "kind?", "key?"),
        "a bank entry could not be read or stored (corrupt or "
        "truncated payload, a library that does not load) — logged and "
        "treated as a miss, never fatal"),
    "aot_gc": (
        ("removed", "kept", "bytes_freed", "dry_run"),
        "bank garbage collection removed stale/orphaned entries "
        "(python -m raft_tpu_torch.aot gc)"),
    "aot_warmup": (
        ("kind", "n", "loaded", "compiled", "wall_s", "n_buckets?"),
        "one warm-up sweep dispatched (python -m raft_tpu_torch.aot "
        "warmup); bucketed kind warms n rows per bucket signature"),
    "compile_budget_exceeded": (
        ("count", "budget", "action"),
        "a program build (a bank miss or an nvcc run) exceeded "
        "RAFT_TPU_COMPILE_BUDGET; action 'error' raised "
        "CompileBudgetError before the build"),
    "release_cut": (
        ("release", "parent", "entries", "label?"),
        "an immutable content-addressed release manifest was cut from "
        "the current bank snapshot (python -m raft_tpu_torch.aot "
        "release cut): bank entry keys + payload shas + code hash + "
        "flags fingerprint + parent release, signed by its own sha"),
    "release_promote": (
        ("release", "previous"),
        "the torch-releases/current pointer was flipped (atomic "
        "rename) to a new release — a serving process resolves its "
        "bank through this pointer at start-up"),
    "release_rollback": (
        ("release", "to"),
        "the current pointer was re-pointed at the release's parent"),
    "release_resolve": (
        ("release", "root"),
        "a serving process resolved its bank through the current "
        "release pointer at start-up; the release id is stamped into "
        "every x-raft-provenance response header"),
    "release_preflight": (
        ("release", "unwarmed", "total", "reason?"),
        "the release-vs-designs bank preflight ran (aot release "
        "verify --against-designs, or a require-mode server dying on "
        "a BankMissError): how many design/rung programs are unwarmed "
        "and the mismatch class (code | flags | ladder | avals)"),
    # ----------------------------------------------------------- solvers
    "statics_unconverged": (
        ("n_iter", "status", "reason"),
        "statics Newton hit its budget with the step rule unmet"),
    "drag_linearisation": (
        ("case", "fowt", "resid", "converged", "n_iter", "status",
         "reason"),
        "per-case drag-linearisation convergence diagnostics"),
    # ------------------------------------------------ evaluation service
    "serve_start": (
        ("host", "port", "designs", "tick_ms", "batch_sizes"),
        "the evaluation service bound its socket (after design "
        "registration and warm-up — raft_tpu_torch.serve)"),
    "serve_request": (
        ("endpoint", "method", "code", "client", "wall_s", "cache_hit"),
        "one HTTP request served (any endpoint; wall_s includes "
        "queueing + batching + dispatch for /evaluate)"),
    "serve_tick": (
        ("rows", "unique", "n_groups", "dispatches", "wall_s"),
        "one non-empty batcher tick: pending requests deduplicated, "
        "grouped by bucket signature and dispatched"),
    "serve_reject": (
        ("reason", "client"),
        "a request was refused at admission (reason: quota -> 429 | "
        "queue_full -> 503)"),
    "serve_escalate": (
        ("status_before", "status_after", "resolved"),
        "a SEVERE-flagged request opted into the f64_cpu re-solve; "
        "only a healthy re-solve is adopted"),
    "serve_error": (
        ("error", "rows"),
        "a serving dispatch raised; every coalesced requester got the "
        "exception (HTTP 500)"),
    "serve_drain": (
        ("pending", "wall_s", "completed"),
        "graceful drain: new work refused, pending ticks finished"),
    "slo_breach": (
        ("wall_s", "slo_ms", "client?", "cache_hit?"),
        "one request resolved slower than RAFT_TPU_SERVE_SLO_MS "
        "(counted in serve_slo_breaches)"),
    "serve_request_stages": (
        ("wall_s", "queue_wait_s", "tick_wait_s", "dispatch_s",
         "solve_s", "post_s", "escalated?"),
        "per-resolved-request latency decomposition into named stages "
        "(admission-queue wait, in-tick wait behind earlier groups, "
        "dispatch overhead, device solve, post/cache fan-out); the "
        "stages sum to wall_s by construction"),
    "serve_stop": (
        ("requests", "wall_s"),
        "the service exited after draining and flushing metrics"),
    "serve_ladder": (
        ("candidates", "sizes", "walls_ms"),
        "cost-driven batch-ladder refinement (RAFT_TPU_SERVE_LADDER="
        "cost): candidate rungs whose measured per-dispatch wall was "
        "flat vs the next rung were pruned after warm-up"),
    # --------------------------------------------------- alert engine
    "alert_fire": (
        ("rule", "severity", "metric", "value", "threshold", "context"),
        "one alert rule's condition held past its for-duration and the "
        "alert FIRED (raft_tpu_torch.obs.alerts; also appended to the "
        "RAFT_TPU_ALERTS JSONL sink and counted in alerts_active/"
        "alerts_fired)"),
    "alert_resolve": (
        ("rule", "severity", "metric", "duration_s", "value"),
        "a firing alert's condition stayed clean past its clear_s "
        "hysteresis and the alert RESOLVED (duration_s = how long it "
        "fired)"),
    # -------------------------------------------------- run-record store
    "run_record": (
        ("kind", "path", "label?"),
        "one schema-versioned run record was appended to the "
        "RAFT_TPU_RUNS_DIR store (raft_tpu_torch.obs.runs) — the "
        "longitudinal perf-trajectory entry a later `obs runs "
        "regress` compares against the pinned baseline"),
    "regression_detected": (
        ("metric", "base", "new", "threshold", "baseline", "record"),
        "`obs runs regress` found one watched metric worse than the "
        "pinned baseline past its noise threshold (the CLI exits 1)"),
    # --------------------------------------------------- flight recorder
    "flight_dump": (
        ("trigger", "path", "records"),
        "the black-box flight ring was persisted as one atomic JSONL "
        "shard (raft_tpu_torch.obs.flight): trigger names the cause — an "
        "alert dump embeds the firing rule (alert-<rule>), plus "
        "quarantine-severe / compile-budget / crash-<exc> / sigterm / "
        "manual; `obs flight show` summarizes the shard and `obs trace "
        "--merge` places it on the shared timeline"),
    "flight_metrics": (
        ("counters",),
        "periodic metric-snapshot delta record inside a flight-dump "
        "shard (never emitted to the live stream): the counter "
        "movement since the previous flight snapshot "
        "(RAFT_TPU_FLIGHT_SNAP_S) — rate context for a postmortem"),
}

#: Span-name registry, mirroring EVENTS for the names used with
#: ``obs.span(...)``: a typo'd span name silently forks the wall-time
#: tree (and mints a stray ``span_<name>_s`` histogram) instead of
#: crashing.  name -> help.
SPANS: dict[str, str] = {
    "driver.run": "one full analysis via raft_tpu_torch.drivers.run",
    "driver.run_farm": "one farm analysis via "
                       "raft_tpu_torch.drivers.run_farm",
    "solve_statics": "per-case statics equilibrium solve",
    "solve_dynamics": "per-case dynamics (drag-linearised) solve",
    "sweep": "one checkpointed/fabric sweep, root of the shard tree",
    "shard": "one shard's fault-tolerant evaluation",
    "shard_attempt": "one retry attempt inside a shard",
    "escalation_rung": "one escalation-ladder re-solve of a flagged row",
    "sweep_dispatch": "one evaluator dispatch over a mesh (cases/full/"
                      "bucket)",
    "qtf_slender_sharded": "one slender-body QTF with its frequency "
                           "pairs split over a mesh's devices",
    "serve_request": "one /evaluate request, HTTP accept to response "
                     "(adopts the client's traceparent when sent)",
    "serve_tick": "one non-empty batcher tick; `links` names every "
                  "coalesced request span it dispatched for",
}


def is_registered_span(name):
    return name in SPANS


def describe_spans():
    """Yield ``(name, help)`` rows sorted by name (``python -m
    raft_tpu_torch.obs spans``)."""
    for name in sorted(SPANS):
        yield name, SPANS[name]


def is_registered(name):
    return name in EVENTS


def describe():
    """Yield ``(name, fields, help)`` rows sorted by name (``python -m
    raft_tpu_torch.obs events`` renders from this)."""
    for name in sorted(EVENTS):
        fields, help_ = EVENTS[name]
        yield name, fields, help_

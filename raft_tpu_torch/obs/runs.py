"""Longitudinal run-record store + perf-regression sentinel (the
port's copy of ``raft_tpu/obs/runs.py``: the same record schema,
``SCHEMA_VERSION``, flattening, watch rules and verdicts).

* every checkpointed-sweep session (serial or fabric-assembled) ends by
  writing a canonical, **schema-versioned run record** — environment
  fingerprint (platform, device kind and count, dtype, the torch and
  CUDA versions, the ``raft_tpu_torch`` source hash), the full
  metrics-registry snapshot, the per-kernel launch ledger
  (:func:`raft_tpu_torch.aot.bank.ledger_summary`), wall time and the
  git SHA when available — into an append-only store under
  ``RAFT_TPU_RUNS_DIR`` (unset = recording disabled, zero overhead);
* ``python -m raft_tpu_torch.obs runs regress`` compares the newest
  record against a **pinned baseline** record with noise-aware
  per-metric thresholds (relative tolerance + a minimum-absolute floor
  so a near-zero baseline cannot fail CI on microseconds of jitter),
  exiting 1 on regression and naming the regressed metric; an
  environment-fingerprint mismatch downgrades failures to warnings —
  numbers from different hosts/devices are not comparable;
* ``python -m raft_tpu_torch.obs runs ingest BENCH_*.json`` imports
  bench artifacts so a trajectory starts populated.

Pure stdlib at import time; torch is consulted only when it is already
loaded in the recording process (the CLI verbs never touch a device).
Recording is best-effort end to end — telemetry must never take down
the run that produced it.
"""

from __future__ import annotations

import fnmatch
import json
import os
import re
import subprocess
import sys
import time
import uuid

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event, run_id

SCHEMA_VERSION = 1

#: name of the baseline-pin file inside the store: its content is the
#: FILENAME of the pinned baseline record (``runs pin`` writes it)
BASELINE_NAME = "BASELINE"

#: env-fingerprint keys that must match for two records' numbers to be
#: comparable.  The source hash is deliberately absent — the whole
#: point of the sentinel is comparing across code changes.
ENV_COMPARE_KEYS = ("platform", "device_kind", "n_devices", "dtype",
                    "host", "torch", "cuda")


def runs_dir(create=False):
    """The store directory from ``RAFT_TPU_RUNS_DIR`` (None when unset
    — recording disabled)."""
    d = config.get("RUNS_DIR") or ""
    if not d:
        return None
    if create:
        os.makedirs(d, exist_ok=True)
    return d


# ------------------------------------------------------------ record build


def env_fingerprint():
    """Where these numbers were measured: host + toolchain + device.

    torch is queried only when the recording process already imported
    it (a sweep process has); a torch-free CLI record carries the host
    keys only and is treated as not-comparable by
    :func:`regress_records`.  ``platform`` is ``gpu`` when a CUDA device
    is visible, else ``cpu``; ``dtype`` is the compute-dtype policy
    (``RAFT_TPU_DTYPE``, ``float64`` unless set)."""
    import platform as _platform

    env = {"host": _platform.node(),
           "python": _platform.python_version()}
    try:
        from raft_tpu_torch.aot.bank import code_fingerprint

        env["code"] = code_fingerprint()
    except Exception:
        pass
    if "torch" in sys.modules:
        try:
            import torch

            env["torch"] = torch.__version__
            env["cuda"] = torch.version.cuda
            if torch.cuda.is_available():
                env.update(platform="gpu",
                           device_kind=torch.cuda.get_device_name(0),
                           n_devices=torch.cuda.device_count())
            else:
                env.update(platform="cpu", device_kind="cpu", n_devices=1)
            env["dtype"] = config.get("DTYPE") or "float64"
        except Exception:
            pass
    return env


def git_sha():
    """HEAD SHA of the enclosing checkout, or None (best-effort: the
    store must work outside a git tree too)."""
    try:
        p = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5.0,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        sha = (p.stdout or "").strip()
        return sha if p.returncode == 0 and re.fullmatch(r"[0-9a-f]{40}",
                                                         sha) else None
    except Exception:
        return None


def build_record(kind, label=None, wall_s=None, extra=None, events=None):
    """Assemble one run record from the live process state.  The port
    compiles no programs at run time (its kernels are built by ``nvcc``
    ahead of the first launch), so ``compiles`` stays empty; the
    ``cost_ledger`` holds the solve kernel's launches per entry.

    events : optional parsed JSONL capture (list of event dicts): its
        :func:`raft_tpu_torch.obs.report.report_data` sections are embedded
        under ``report`` — the machine-readable twin of ``obs report``
        — instead of re-parsing rendered text.
    """
    record = {
        "schema": SCHEMA_VERSION,
        "kind": str(kind),
        "label": str(label) if label else None,
        "t_unix": round(time.time(), 3),
        "wall_s": round(float(wall_s), 3) if wall_s is not None else None,
        "run_id": run_id(),
        "git_sha": git_sha(),
        "env": env_fingerprint(),
        "snapshot": metrics.snapshot(),
        "compiles": {},
        "extra": dict(extra) if extra else {},
    }
    try:
        from raft_tpu_torch.aot.bank import ledger_summary

        ledger = ledger_summary()
    except Exception:
        ledger = []
    if ledger:
        record["cost_ledger"] = ledger
    if events:
        from raft_tpu_torch.obs import report

        record["report"] = report.report_data(events)
    return record


def write_record(record, dir=None):
    """Append one record to the store (atomic tmp + rename; filenames
    sort chronologically, nothing is ever overwritten).  Returns the
    path."""
    d = dir or runs_dir(create=True)
    if d is None:
        raise ValueError("no store: set RAFT_TPU_RUNS_DIR or pass --dir")
    os.makedirs(d, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(
        record.get("t_unix") or time.time()))
    name = f"run-{stamp}-{os.getpid()}-{uuid.uuid4().hex[:6]}.json"
    path = os.path.join(d, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, default=str)
    os.replace(tmp, path)
    log_event("run_record", kind=record.get("kind"), path=path,
              label=record.get("label"))
    return path


def maybe_record(kind, label=None, wall_s=None, extra=None, events=None):
    """Record-if-enabled hook for the runtime exit points (the serial
    and the fabric ``sweep_done``): no-op unless ``RAFT_TPU_RUNS_DIR`` is
    set, and never raises — a failed record must not fail the run."""
    try:
        if runs_dir() is None:
            return None
        return write_record(build_record(kind, label=label, wall_s=wall_s,
                                         extra=extra, events=events))
    except Exception:
        return None


# ------------------------------------------------------------- store reads


def load_record(path):
    with open(path) as f:
        record = json.load(f)
    if not isinstance(record, dict) or "schema" not in record:
        raise ValueError(f"{path}: not a run record (no 'schema' field)")
    if int(record["schema"]) > SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema v{record['schema']} is newer than this "
            f"tool (v{SCHEMA_VERSION})")
    return record


def list_records(dir=None):
    """``[(path, record), ...]`` chronological by recorded ``t_unix``
    (filename as the tiebreak — same-second records would otherwise
    order by their random uniqueness suffix); unparseable files are
    skipped, not fatal."""
    d = dir or runs_dir()
    if d is None or not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if not (name.startswith("run-") and name.endswith(".json")):
            continue
        path = os.path.join(d, name)
        try:
            out.append((path, load_record(path)))
        except (OSError, ValueError):
            continue
    out.sort(key=lambda pr: (pr[1].get("t_unix") or 0.0,
                             os.path.basename(pr[0])))
    return out


def pinned_baseline(dir=None):
    """Path of the pinned baseline record, or None."""
    d = dir or runs_dir()
    if d is None:
        return None
    pin = os.path.join(d, BASELINE_NAME)
    try:
        with open(pin) as f:
            name = f.read().strip()
    except OSError:
        return None
    path = name if os.path.isabs(name) else os.path.join(d, name)
    return path if os.path.exists(path) else None


def pin_baseline(record_path, dir=None):
    """Pin one record as THE baseline `regress` compares against."""
    d = dir or runs_dir(create=True)
    if d is None:
        raise ValueError("no store: set RAFT_TPU_RUNS_DIR or pass --dir")
    load_record(record_path)  # must parse before we pin it
    rel = (os.path.basename(record_path)
           if os.path.dirname(os.path.abspath(record_path))
           == os.path.abspath(d) else os.path.abspath(record_path))
    tmp = os.path.join(d, BASELINE_NAME + ".tmp")
    with open(tmp, "w") as f:
        f.write(rel + "\n")
    os.replace(tmp, os.path.join(d, BASELINE_NAME))
    return os.path.join(d, BASELINE_NAME)


# --------------------------------------------------------------- flattening


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v == v


def _flatten_extra(prefix, obj, out):
    if isinstance(obj, dict):
        for k in sorted(obj):
            _flatten_extra(f"{prefix}.{k}" if prefix else str(k),
                           obj[k], out)
    elif _num(obj):
        out[f"extra:{prefix}"] = float(obj)


def flatten(record):
    """One flat ``{metric_name: float}`` view of a record — the
    comparison domain of ``compare``/``regress``.  Names are
    namespaced by source: ``counter:<name>``, ``gauge:<name>:max``,
    ``hist:<name>:{mean,p50,p95}``, ``window:<name>:{p50,p95}``,
    ``stage:<name>:{p50,p95}`` (serve tail attribution),
    ``waste:<axis>`` (row-weighted per-axis padding waste) and
    ``extra:<dotted.path>`` for caller-provided scalars."""
    out = {}
    snap = record.get("snapshot") or {}
    for name, v in (snap.get("counters") or {}).items():
        if _num(v):
            out[f"counter:{name}"] = float(v)
    for name, g in (snap.get("gauges") or {}).items():
        if isinstance(g, dict) and _num(g.get("max")):
            out[f"gauge:{name}:max"] = float(g["max"])
    for name, h in (snap.get("histograms") or {}).items():
        if isinstance(h, dict) and h.get("count"):
            for k in ("mean", "p50", "p95"):
                if _num(h.get(k)):
                    out[f"hist:{name}:{k}"] = float(h[k])
    for name, w in (snap.get("windows") or {}).items():
        if isinstance(w, dict) and w.get("count"):
            for k in ("p50", "p95"):
                if _num(w.get(k)):
                    out[f"window:{name}:{k}"] = float(w[k])
    report = record.get("report") or {}
    stages = (report.get("serve_stages") or {})
    for col in ("p50", "p95"):
        rep = stages.get(col) or {}
        for name, v in (rep.get("stages") or {}).items():
            if _num(v):
                out[f"stage:{name}:{col}"] = float(v)
        if _num(rep.get("total_s")):
            out[f"stage:total:{col}"] = float(rep["total_s"])
    # per-axis padding waste: prefer the exact counter ratios (sum of
    # valid / padded entries over every dispatched row) so the flat
    # view reproduces the aggregate row-weighted waste bit-for-bit
    from raft_tpu_torch.obs.report import waste_axes_from_counters

    for axis, a in waste_axes_from_counters(
            snap.get("counters") or {}).items():
        out[f"waste:{axis}"] = a["waste_frac"]
    # records built from a capture (`runs record --events`) carry the
    # waste table inside the embedded report, not the live registry
    for axis, a in ((report.get("waste") or {}).get("axes") or {}).items():
        if _num(a.get("waste_frac")):
            out.setdefault(f"waste:{axis}", float(a["waste_frac"]))
    _flatten_extra("", record.get("extra") or {}, out)
    if _num(record.get("wall_s")):
        out["wall_s"] = float(record["wall_s"])
    return out


# ---------------------------------------------------------------- regress

#: watch rules, first match wins: (fnmatch pattern over flattened
#: names, which direction is BETTER, relative tolerance [None = the
#: RAFT_TPU_RUNS_REL_TOL flag], minimum absolute worsening).  Metrics
#: matching no rule are informational — compared, never gated.
#: ``better="lower"`` means an increase can regress; floors are in the
#: metric's own unit and scaled by RAFT_TPU_RUNS_ABS_FLOOR.
#:
#: Latency histogram percentiles pin rel_tol=1.0: the registry's
#: histograms are log-bucketed at 4/decade, so a percentile moves in
#: x10^0.25 ≈ 1.78 quantization steps — any tolerance below 0.78 flags
#: single-bucket jitter on clean back-to-back runs, while 1.0 passes
#: one bucket step and fails two (≥ 2.2x, which a real slowdown is).
#: Throughput rules must stay tighter — at rel_tol 1.0 a higher-is-
#: better metric could never regress (worse-by > baseline needs a
#: negative rate).
WATCH_RULES = (
    # achieved-rate metrics (end in _s but higher is better): before
    # the generic latency rules
    ("hist:program_gflops_s:*", "higher", 0.5, 0.5),
    ("extra:*evals_per_s*", "higher", 0.5, 1.0),
    ("extra:*evals/s*", "higher", 0.5, 1.0),
    # padding waste (fraction of device work spent on masked pad rows)
    ("hist:pad_waste_*:mean", "lower", 0.5, 0.02),
    ("waste:*", "lower", 0.5, 0.02),
    # reliability counters: one stray event is noise, a jump is not
    ("counter:serve_errors", "lower", 0.5, 0.5),
    ("counter:serve_slo_breaches", "lower", 0.5, 1.5),
    ("counter:rows_quarantined", "lower", 0.5, 0.5),
    ("counter:shards_corrupt", "lower", 0.5, 0.5),
    ("counter:shard_retries", "lower", 0.5, 1.5),
    ("counter:shard_oom_splits", "lower", 0.5, 0.5),
    # per-TICK wall is a scheduling-policy metric, not a latency SLO:
    # an adaptive tick makes it bimodal BY DESIGN (near-empty
    # floor-window ticks vs dispatching ticks), so its percentiles
    # straddle log-bucket boundaries and flap on clean reruns.  The
    # request-level gates below (serve_request*/window/stage) are the
    # user-facing latency contract; tick walls stay informational.
    ("hist:serve_tick_s:*", "none", None, 0.0),
    ("hist:span_serve_tick_s:*", "none", None, 0.0),
    # latency-like: every *_s histogram/window/stage percentile
    ("hist:*_s:p50", "lower", 1.0, 0.02),
    ("hist:*_s:p95", "lower", 1.0, 0.05),
    ("hist:*_s:mean", "lower", 1.0, 0.02),
    ("window:*_s:p50", "lower", 1.0, 0.02),
    ("window:*_s:p95", "lower", 1.0, 0.05),
    ("stage:*:p50", "lower", 1.0, 0.02),
    ("stage:*:p95", "lower", 1.0, 0.05),
)


def watch_rule(name):
    """``(better, rel_tol | None, abs_floor)`` of the first matching
    rule, or None.  A rule with ``better="none"`` EXEMPTS its metrics:
    first-match-wins, so it shields them from a later catch-all
    pattern (informational — compared, never gated)."""
    for pattern, better, rel, floor in WATCH_RULES:
        if fnmatch.fnmatchcase(name, pattern):
            return None if better == "none" else (better, rel, floor)
    return None


def env_mismatch(a, b):
    """Comparison keys on which two records' environments differ (a
    non-empty result means their numbers are not comparable)."""
    ea, eb = a.get("env") or {}, b.get("env") or {}
    if ea.get("ingested") or eb.get("ingested"):
        return ["ingested"]
    return [k for k in ENV_COMPARE_KEYS if ea.get(k) != eb.get(k)]


def compare_records(new, base):
    """Per-metric delta rows over the union of both records' flattened
    metrics (``runs compare``): name, base, new, delta, pct, watched
    direction."""
    fn, fb = flatten(new), flatten(base)
    rows = []
    for name in sorted(set(fn) | set(fb)):
        b, n = fb.get(name), fn.get(name)
        rule = watch_rule(name)
        row = {"metric": name, "base": b, "new": n,
               "better": rule[0] if rule else None}
        if b is not None and n is not None:
            row["delta"] = round(n - b, 6)
            if b:
                row["pct"] = round(100.0 * (n - b) / abs(b), 2)
        rows.append(row)
    return rows


def regress_records(new, base, rel_tol=None, floor_scale=None):
    """Noise-aware regression verdict of ``new`` against ``base``.

    A watched metric regresses when it moves in the WORSE direction by
    more than ``max(rule_rel_tol * |baseline|, abs_floor)`` — the
    relative tolerance absorbs proportional noise (per-rule: latency
    histogram percentiles use 1.0 to absorb their log-bucket
    quantization step, see WATCH_RULES), the absolute floor keeps
    near-zero baselines (a 2 ms p95) from failing on jitter.  An
    explicit ``rel_tol`` argument (the CLI ``--rel-tol``), or
    ``RAFT_TPU_RUNS_REL_TOL`` set in the environment, overrides every
    rule's tolerance — the noisier-host loosening knob.  An
    environment mismatch downgrades every failure to a warning: the
    numbers were measured on different hardware/toolchains.
    """
    # the env flag only overrides when actually SET — its default must
    # not shadow the per-rule tolerances
    env_rel = (float(config.get("RUNS_REL_TOL"))
               if config.raw("RUNS_REL_TOL") else None)
    default_rel = float(config.get("RUNS_REL_TOL"))
    floor_scale = (float(config.get("RUNS_ABS_FLOOR"))
                   if floor_scale is None else float(floor_scale))
    mismatch = env_mismatch(new, base)
    fn, fb = flatten(new), flatten(base)
    regressions, improvements = [], []
    checked = 0
    for name in sorted(set(fn) & set(fb)):
        rule = watch_rule(name)
        if rule is None:
            continue
        better, rule_rel, floor = rule
        b, n = fb[name], fn[name]
        checked += 1
        worsening = (n - b) if better == "lower" else (b - n)
        rel = (float(rel_tol) if rel_tol is not None
               else env_rel if env_rel is not None
               else rule_rel if rule_rel is not None else default_rel)
        threshold = max(rel * abs(b), floor * floor_scale)
        entry = {"metric": name, "base": round(b, 6), "new": round(n, 6),
                 "worsening": round(worsening, 6),
                 "threshold": round(threshold, 6), "better": better}
        if worsening > threshold:
            regressions.append(entry)
        elif -worsening > threshold:
            improvements.append(entry)
    return {
        "comparable": not mismatch,
        "env_mismatch": mismatch,
        # different kinds (a serve session vs a sweep baseline) still
        # compare on their metric intersection, but the caller should
        # know the workloads differ
        "kind_mismatch": (new.get("kind") != base.get("kind")),
        "checked": checked,
        "regressions": regressions,
        "improvements": improvements,
        "ok": not regressions or bool(mismatch),
    }


# ----------------------------------------------------------------- ingest


def ingest_bench(path):
    """One ``BENCH_rNN.json`` artifact as a run record: the headline
    value + every numeric breakdown leaf become ``extra`` metrics, the
    environment is marked ``ingested`` (pre-store numbers have no env
    fingerprint, so `regress` will only ever warn against them), and
    the record timestamp is the artifact's mtime so the imported
    trajectory keeps its real order."""
    with open(path) as f:
        bench = json.load(f)
    label = os.path.basename(path)
    m = re.search(r"(r\d+)", label)
    if isinstance(bench, dict) and "metric" not in bench and "rc" in bench:
        # early-round wrapper artifact: {n, cmd, rc, tail, parsed: {...}}.
        # A round that produced NO parsed result (timeout/crash) still
        # belongs in the trajectory — as an explicitly failed record,
        # not a silent gap
        parsed = bench.get("parsed")
        if not isinstance(parsed, dict):
            return {
                "schema": SCHEMA_VERSION, "kind": "bench",
                "label": m.group(1) if m else label,
                "t_unix": round(os.path.getmtime(path), 3),
                "wall_s": None, "run_id": None, "git_sha": None,
                "env": {"ingested": True, "source": label},
                "snapshot": {}, "compiles": {},
                "extra": {"rc": bench.get("rc")},
                "headline": {"metric": None, "unit": None, "value": None,
                             "failed": True},
            }
        bench = parsed
    if not isinstance(bench, dict) or "metric" not in bench:
        raise ValueError(f"{path}: not a bench artifact (no 'metric')")
    extra = {k: bench[k] for k in ("value", "vs_baseline")
             if _num(bench.get(k))}
    unit = str(bench.get("unit") or "")
    if "evals/s" in unit and _num(bench.get("value")):
        extra["evals_per_s"] = float(bench["value"])
    _ingest_breakdown(bench.get("breakdown"), extra)
    return {
        "schema": SCHEMA_VERSION,
        "kind": "bench",
        "label": m.group(1) if m else label,
        "t_unix": round(os.path.getmtime(path), 3),
        "wall_s": None,
        "run_id": None,
        "git_sha": None,
        "env": {"ingested": True, "source": label},
        "snapshot": {},
        "compiles": {},
        "extra": extra,
        "headline": {"metric": bench.get("metric"), "unit": unit,
                     "value": bench.get("value")},
    }


def _ingest_breakdown(obj, extra, prefix="breakdown"):
    if isinstance(obj, dict):
        for k in sorted(obj):
            _ingest_breakdown(obj[k], extra, f"{prefix}.{k}")
    elif _num(obj):
        extra[prefix] = float(obj)

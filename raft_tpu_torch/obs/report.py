"""Offline tooling over captured telemetry JSONL streams (the port's
copy of ``raft_tpu/obs/report.py``: the same sections, the same text and
the same JSON on the same capture).

Two consumers of a ``RAFT_TPU_LOG`` capture (pure stdlib, no torch):

* :func:`render_report` — the ``python -m raft_tpu_torch.obs report``
  view: per-stage wall-time tree built from the span hierarchy (count /
  total / p50 / p95), the counter table from the run's final metrics
  snapshot, the fabric's per-worker table, per-event-name counts, and a
  reliability summary (retries, OOM splits, quarantine/escalation
  outcomes) — i.e. "where did the sweep spend its time and what
  fraction was retried / flagged / escalated" without re-running
  anything.
* :func:`chrome_trace` — the ``python -m raft_tpu_torch.obs trace``
  export: Chrome/Perfetto trace-event JSON (``chrome://tracing`` /
  https://ui.perfetto.dev) with one complete ("X") slice per matched
  span pair, instant events for everything else, and counter tracks
  from the heartbeat stream's device-memory samples.

The sections over serving events (endpoints, ticks, the stage split,
alerts) read what :mod:`raft_tpu_torch.serve` and
:mod:`raft_tpu_torch.obs.alerts` emit, in the reference's record
formats, and so do the fleet router's and the canaries' sections
(:mod:`raft_tpu_torch.serve.router`, :mod:`~raft_tpu_torch.serve.
canary`).  The
``x-raft-provenance`` parser and the cross-replica consistency verdict
come from :mod:`raft_tpu_torch.obs.alerts`.
"""

from __future__ import annotations

import json
import os
import re

from raft_tpu_torch.obs.alerts import parse_provenance, provenance_consistency


def expand_captures(paths):
    """Flatten capture arguments: a directory expands to its sorted
    ``*.jsonl`` shards (the per-process ``RAFT_TPU_LOG=<dir>`` layout),
    a file stands for itself."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            out += [os.path.join(p, n) for n in sorted(os.listdir(p))
                    if n.endswith(".jsonl")]
        else:
            out.append(p)
    return out


def merge_captures(paths):
    """Assemble several per-process captures into ONE event list on a
    shared wall-clock timeline.

    Every process's ``t`` is monotonic since ITS OWN start; the
    ``proc_start`` clock anchors (emitted as each sink's first record)
    carry ``unix_t``, so an anchored event maps to
    ``unix_t + (t - t_anchor)``.  Files without an anchor (captures
    predating the anchor, or truncated heads) are laid out sequentially
    AFTER the anchored window — visible, just not aligned.  Returns
    ``(events, n_bad, info)``; the returned events carry normalized
    ``t`` (seconds from the earliest anchored instant) and sort by it.
    """
    per_file = []
    n_bad = 0
    walls = []
    for path in expand_captures(paths):
        events, bad = read_events(path)
        n_bad += bad
        if not events:
            continue
        # segment by anchor: a pid-reused shard file can hold several
        # process lifetimes, each opening with its own proc_start
        anchor = None
        rows = []
        for ev in events:
            if ev["event"] == "proc_start" and "unix_t" in ev:
                anchor = (ev["t"], float(ev["unix_t"]))
            wall = (anchor[1] + (ev["t"] - anchor[0])
                    if anchor is not None else None)
            rows.append((wall, ev))
            if wall is not None:
                walls.append(wall)
        per_file.append((path, rows))
    t0 = min(walls) if walls else 0.0
    merged = []
    n_unanchored_files = 0
    cursor = (max(walls) - t0 + 1e-3) if walls else 0.0
    for path, rows in per_file:
        unanchored = [ev for wall, ev in rows if wall is None]
        if unanchored:
            n_unanchored_files += 1
            lo = min(ev["t"] for ev in unanchored)
            hi = max(ev["t"] for ev in unanchored)
            for ev in unanchored:
                ev = dict(ev)
                ev["t"] = round(cursor + (ev["t"] - lo), 6)
                merged.append(ev)
            cursor += (hi - lo) + 1e-3
        for wall, ev in rows:
            if wall is None:
                continue
            ev = dict(ev)
            ev["t"] = round(wall - t0, 6)
            merged.append(ev)
    merged.sort(key=lambda e: e["t"])
    info = {"files": len(per_file),
            "unanchored_files": n_unanchored_files,
            "t0_unix": round(t0, 6) if walls else None}
    return merged, n_bad, info


def read_events(path):
    """Parse one JSONL capture; returns ``(events, n_bad_lines)``.
    Damaged lines (a process killed mid-write pre-dates the sink lock)
    are counted, not fatal."""
    events, bad = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(ev, dict) and "event" in ev:
                events.append(ev)
            else:
                bad += 1
    return events, bad


def collect_spans(events):
    """Match ``span_begin``/``span_end`` pairs by span id.

    Returns ``(spans, unmatched_begins)``; each span dict carries
    name/t0/t1/wall_s/ok/ids/attrs.  Ends without a begin are dropped
    (a capture that starts mid-run)."""
    begins = {}
    spans = []
    for ev in events:
        kind = ev["event"]
        if kind == "span_begin" and "span_id" in ev:
            begins[ev["span_id"]] = ev
        elif kind == "span_end" and ev.get("span_id") in begins:
            b = begins.pop(ev["span_id"])
            attrs = {k: v for k, v in b.items()
                     if k not in ("t", "event", "pid", "run_id", "trace_id",
                                  "span_id", "name", "parent_id")}
            spans.append({
                "name": b.get("name", "?"),
                "t0": b["t"], "t1": ev["t"],
                "wall_s": ev.get("wall_s", round(ev["t"] - b["t"], 6)),
                "ok": ev.get("ok", True),
                "error": ev.get("error"),
                "span_id": b["span_id"],
                "parent_id": b.get("parent_id"),
                "trace_id": b.get("trace_id"),
                "pid": b.get("pid"),
                "run_id": b.get("run_id"),
                "attrs": attrs,
            })
    return spans, list(begins.values())


def _percentile(vals, p):
    vals = sorted(vals)
    if not vals:
        return None
    i = min(len(vals) - 1, max(0, round(p * (len(vals) - 1))))
    return vals[i]


def span_paths(spans):
    """Aggregate spans by their name *path* (root→leaf names following
    parent ids).  Returns ``{path_tuple: [wall_s, ...]}`` plus the
    per-path failure counts."""
    by_id = {s["span_id"]: s for s in spans}
    paths = {}
    fails = {}

    def path_of(s, _depth=0):
        if s["parent_id"] and s["parent_id"] in by_id and _depth < 64:
            return path_of(by_id[s["parent_id"]], _depth + 1) + (s["name"],)
        return (s["name"],)

    for s in spans:
        p = path_of(s)
        paths.setdefault(p, []).append(s["wall_s"])
        if not s.get("ok", True):
            fails[p] = fails.get(p, 0) + 1
    return paths, fails


def _fmt_s(v):
    return f"{v:9.3f}s" if v is not None else "        —"


#: the serve tail-attribution stage names, in pipeline order (the
#: batcher emits one ``serve_request_stages`` event per resolved
#: dispatched request with ``<stage>_s`` fields summing to wall_s)
SERVE_STAGES = ("queue_wait", "tick_wait", "dispatch", "solve", "post")


def serve_stage_attribution(events):
    """The p50-vs-p95 latency decomposition of the dispatched serve
    requests in a capture, or None when no ``serve_request_stages``
    events are present.

    Rather than reporting each stage's independent percentile (whose
    sum can exceed the total's percentile arbitrarily), the p50/p95
    columns show the stage breakdown of the *request at that rank of
    total latency* — stages then sum to that request's measured
    end-to-end latency by construction, so "p95 is 4.5x p50" reads
    directly as "the p95 request spent X ms in tick-wait"."""
    reqs = [e for e in events if e["event"] == "serve_request_stages"]
    if not reqs:
        return None

    def stages_of(e):
        return {s: float(e.get(f"{s}_s") or 0.0) for s in SERVE_STAGES}

    reqs.sort(key=lambda e: float(e.get("wall_s") or 0.0))

    def at_rank(p):
        i = min(len(reqs) - 1, max(0, round(p * (len(reqs) - 1))))
        e = reqs[i]
        st = stages_of(e)
        return {"total_s": round(float(e.get("wall_s") or 0.0), 6),
                "stages": {k: round(v, 6) for k, v in st.items()},
                "stages_sum_s": round(sum(st.values()), 6)}

    n = len(reqs)
    mean_stages = {s: round(sum(stages_of(e)[s] for e in reqs) / n, 6)
                   for s in SERVE_STAGES}
    return {
        "n_requests": n,
        "mean": {"total_s": round(sum(float(e.get("wall_s") or 0.0)
                                      for e in reqs) / n, 6),
                 "stages": mean_stages},
        "p50": at_rank(0.50),
        "p95": at_rank(0.95),
    }


def waste_axes_from_counters(counters):
    """``{axis: {valid, padded, waste_frac}}`` from the exact
    ``pad_valid_<axis>`` / ``pad_total_<axis>`` counter pairs a
    dispatch records — the single definition of the counter→waste
    derivation (the report table AND the run store's ``waste:*``
    regress metrics both go through here, so they cannot diverge)."""
    axes = {}
    for name, total in (counters or {}).items():
        m = re.fullmatch(r"pad_total_(\w+)", name)
        if m and total:
            axis = m.group(1)
            valid = counters.get(f"pad_valid_{axis}", 0)
            axes[axis] = {"valid": int(valid), "padded": int(total),
                          "waste_frac": round(1.0 - valid / total, 6)}
    return axes


def waste_attribution(events, snapshot=None):
    """Per-axis padding-waste decomposition, or None when the capture
    carries no waste instrumentation.

    Sources, in preference order: the final metrics snapshot's exact
    ``pad_valid_<axis>`` / ``pad_total_<axis>`` counter pairs (summed
    over every dispatched row — the strips axis reproduces the
    aggregate row-weighted ``padding_waste_frac`` bit-for-bit), else
    the ``bucket_sweep`` events' ``waste_by_axis`` payloads.  The
    per-row distribution (mean/p95 of each row's own pad fraction)
    joins from the ``pad_waste_<axis>`` histograms when present."""
    counters = (snapshot or {}).get("counters") or {}
    hists = (snapshot or {}).get("histograms") or {}
    axes = waste_axes_from_counters(counters)
    if not axes:
        for e in events:
            if e["event"] != "bucket_sweep" or not e.get("waste_by_axis"):
                continue
            for axis, rec in e["waste_by_axis"].items():
                a = axes.setdefault(axis, {"valid": 0, "padded": 0})
                a["valid"] += int(rec.get("valid") or 0)
                a["padded"] += int(rec.get("padded") or 0)
        for a in axes.values():
            a["waste_frac"] = (round(1.0 - a["valid"] / a["padded"], 6)
                               if a["padded"] else 0.0)
    if not axes:
        return None
    for axis, a in axes.items():
        h = hists.get(f"pad_waste_{axis}") or {}
        if h.get("count"):
            a["rows"] = h["count"]
            a["row_mean"] = h.get("mean")
            a["row_p95"] = h.get("p95")
    return {"axes": axes}


def report_data(events, n_bad=0, source="<events>"):
    """Machine-readable report: every section of :func:`render_report`
    as one JSON-ready dict (``obs report --format json``; embedded
    verbatim in run records by ``obs runs record --events`` instead of
    anyone re-parsing rendered text)."""
    run_ids = sorted({e.get("run_id") for e in events if e.get("run_id")})
    # per-pid windows summed: `t` is monotonic per process, so a
    # resume-appended capture spans several clocks
    pids = {}
    for e in events:
        lo, hi = pids.get(e.get("pid") or 1, (e["t"], e["t"]))
        pids[e.get("pid") or 1] = (min(lo, e["t"]), max(hi, e["t"]))
    window = sum(hi - lo for lo, hi in pids.values())

    spans, unmatched = collect_spans(events)
    paths, fails = span_paths(spans)
    # plain tuple sort = depth-first tree order (a child path sorts
    # immediately after its parent prefix)
    span_rows = []
    for p in sorted(paths):
        walls = paths[p]
        span_rows.append({
            "path": list(p), "count": len(walls),
            "total_s": round(sum(walls), 6),
            "p50_s": _percentile(walls, 0.50),
            "p95_s": _percentile(walls, 0.95),
            "max_s": max(walls),
            "failed": fails.get(p, 0)})

    # legacy flat stage timings (structlog.stage emits the stage name
    # as the event, with wall_s)
    legacy = {}
    for e in events:
        if "wall_s" in e and e["event"] not in (
                "span_end", "shard_done", "sweep_done",
                "serve_request_stages"):
            legacy.setdefault(e["event"], []).append(e["wall_s"])
    stage_rows = [
        {"name": name, "count": len(walls),
         "total_s": round(sum(walls), 6),
         "p50_s": _percentile(walls, 0.50),
         "p95_s": _percentile(walls, 0.95), "max_s": max(walls)}
        for name, walls in sorted(legacy.items())]

    snaps = [e for e in events if e["event"] == "metrics_snapshot"]
    snapshot = snaps[-1].get("snapshot", {}) if snaps else {}

    # fabric per-worker table: every record a worker emits is stamped
    # worker=<id> (RAFT_TPU_WORKER_ID via structlog), so one shared
    # capture splits cleanly into per-worker shard/latency rows
    workers = {}
    for e in events:
        w = e.get("worker")
        if not w:
            continue
        rec = workers.setdefault(
            w, {"walls": [], "claims": 0, "steals": 0, "resumes": 0})
        if e["event"] == "shard_done":
            rec["walls"].append(e.get("wall_s") or 0.0)
        elif e["event"] == "shard_claim":
            rec["claims"] += 1
        elif e["event"] == "shard_steal":
            rec["steals"] += 1
        elif e["event"] == "shard_resume":
            rec["resumes"] += 1
    worker_rows = [
        {"worker": w, "shards": len(r["walls"]), "claims": r["claims"],
         "steals": r["steals"], "resumes": r["resumes"],
         "total_s": round(sum(r["walls"]), 6) if r["walls"] else None,
         "p50_s": _percentile(r["walls"], 0.50),
         "p95_s": _percentile(r["walls"], 0.95)}
        for w, r in sorted(workers.items())
        if r["claims"] or r["walls"]]

    # evaluation-service table: per-endpoint request/latency rows from
    # serve_request events, batch occupancy from serve_tick events
    endpoints = {}
    for e in events:
        if e["event"] != "serve_request":
            continue
        key = (str(e.get("endpoint") or "?"), int(e.get("code") or 0))
        rec = endpoints.setdefault(key, {"walls": [], "hits": 0})
        rec["walls"].append(e.get("wall_s") or 0.0)
        if e.get("cache_hit"):
            rec["hits"] += 1
    endpoint_rows = [
        {"endpoint": ep, "code": code, "requests": len(rec["walls"]),
         "cache_hits": rec["hits"],
         "p50_s": _percentile(rec["walls"], 0.50),
         "p95_s": _percentile(rec["walls"], 0.95),
         "max_s": max(rec["walls"])}
        for (ep, code), rec in sorted(endpoints.items())]
    # fleet-router table: per-(answering replica, code) routed-request
    # rows from router_request events, plus the failover-ladder
    # summary (retries, hedges, breaker transitions, evictions) — the
    # kill-a-replica drill reads its "zero dropped responses" story
    # from here.  One pass: the ladder counters ride the same loop.
    routed = {}
    _ROUTER_COUNT_EVENTS = ("router_retry", "router_hedge",
                            "router_reject", "breaker_open",
                            "breaker_close", "replica_join",
                            "replica_drain", "replica_evict",
                            "router_ring_update")
    router_counts = dict.fromkeys(_ROUTER_COUNT_EVENTS, 0)
    prov_by_design = {}
    for e in events:
        if e["event"] in router_counts:
            router_counts[e["event"]] += 1
            continue
        if e["event"] != "router_request":
            continue
        key = (str(e.get("replica") or "-"), int(e.get("code") or 0))
        rec = routed.setdefault(key, {"walls": [], "attempts": 0,
                                      "hedged": 0})
        rec["walls"].append(e.get("wall_s") or 0.0)
        rec["attempts"] += int(e.get("attempts") or 1)
        if e.get("hedged"):
            rec["hedged"] += 1
        # per-replica provenance stamps (x-raft-provenance forwarded by
        # the router): the consistency line below checks that replicas
        # serving the SAME design agree on bank sha + code hash
        if e.get("provenance") and e.get("replica"):
            prov_by_design.setdefault(
                str(e.get("design") or "?"), {})[
                str(e["replica"])] = e["provenance"]
    router_rows = [
        {"replica": rid, "code": code, "requests": len(rec["walls"]),
         "attempts": rec["attempts"], "hedged": rec["hedged"],
         "p50_s": _percentile(rec["walls"], 0.50),
         "p95_s": _percentile(rec["walls"], 0.95),
         "max_s": max(rec["walls"])}
        for (rid, code), rec in sorted(routed.items())]
    provenance = None
    if prov_by_design:
        parsed = {d: {rid: parse_provenance(p) for rid, p in m.items()}
                  for d, m in prov_by_design.items()}
        provenance = provenance_consistency(parsed)
        provenance["replicas"] = sorted(
            {rid for m in parsed.values() for rid in m})
    router_summary = None
    if router_rows or any(router_counts.values()):
        router_summary = {"replicas": router_rows,
                          "provenance": provenance, **router_counts}

    # alerting + canary section: alert_fire/alert_resolve lifecycles
    # and canary probe outcomes from the capture (the alert layer over
    # these signals)
    alert_rules: dict = {}
    canary_checks = []
    canary_goldens = 0
    for e in events:
        if e["event"] == "alert_fire":
            r = alert_rules.setdefault(
                str(e.get("rule") or "?"),
                {"severity": e.get("severity"), "fires": 0, "resolves": 0})
            r["fires"] += 1
        elif e["event"] == "alert_resolve":
            r = alert_rules.setdefault(
                str(e.get("rule") or "?"),
                {"severity": e.get("severity"), "fires": 0, "resolves": 0})
            r["resolves"] += 1
        elif e["event"] == "canary_check":
            canary_checks.append(e)
        elif e["event"] == "canary_golden":
            canary_goldens += 1
    alerts_summary = None
    if alert_rules or canary_checks or canary_goldens:
        alerts_summary = {
            "rules": {n: dict(r) for n, r in sorted(alert_rules.items())},
            "active_at_end": sorted(
                n for n, r in alert_rules.items()
                if r["fires"] > r["resolves"]),
            "canary": ({
                "goldens": canary_goldens,
                "checks": len(canary_checks),
                "failed": sum(1 for e in canary_checks if not e.get("ok")),
                "provenance_failures": sum(
                    1 for e in canary_checks
                    if e.get("provenance_ok") is False),
            } if (canary_checks or canary_goldens) else None),
        }

    ticks = [e for e in events if e["event"] == "serve_tick"]
    tick_summary = None
    if ticks:
        rows = [e.get("rows") or 0 for e in ticks]
        walls = [e.get("wall_s") or 0.0 for e in ticks]
        tick_summary = {
            "ticks": len(ticks), "requests": sum(rows),
            "unique_rows": sum(e.get("unique") or 0 for e in ticks),
            "dispatches": sum(e.get("dispatches") or 0 for e in ticks),
            "mean_batch": round(sum(rows) / len(ticks), 2),
            "p95_s": _percentile(walls, 0.95)}
        # cost-driven ladder refinement, when the capture recorded one
        ladder_evs = [e for e in events if e["event"] == "serve_ladder"]
        if ladder_evs:
            tick_summary["ladder"] = {
                "candidates": ladder_evs[-1].get("candidates"),
                "sizes": ladder_evs[-1].get("sizes")}

    # device-cost ledger: one row per banked/compiled program, joined
    # from program_cost (flops, at load/store) and program_dispatch
    # (wall + achieved rate, per execution).  The "effective" column
    # adjusts achieved GFLOP/s for padding waste — flops spent on
    # masked pad rows are real device work but not useful evals — using
    # the capture's mean batch occupancy (serve) or 1 - padding waste
    # (bucketed sweeps) when either is present.
    progs = {}
    for e in events:
        if e["event"] == "program_cost" and e.get("key"):
            rec = progs.setdefault(e["key"], {"dispatches": 0,
                                              "wall_s": 0.0})
            rec["kind"] = e.get("kind")
            if e.get("flops") is not None:
                rec["flops"] = e["flops"]
        elif e["event"] == "program_dispatch" and e.get("key"):
            rec = progs.setdefault(e["key"], {"dispatches": 0,
                                              "wall_s": 0.0})
            rec.setdefault("kind", e.get("kind"))
            rec["dispatches"] += 1
            rec["wall_s"] += e.get("wall_s") or 0.0
    occupancy = None
    ledger_rows = []
    if progs:
        occ = (snapshot.get("histograms", {})
               .get("serve_batch_occupancy") or {})
        occupancy = occ.get("mean")
        if occupancy is None:
            wastes = [e["padding_waste_frac"] for e in events
                      if e["event"] == "bucket_sweep"
                      and e.get("padding_waste_frac") is not None]
            if wastes:
                occupancy = 1.0 - sum(wastes) / len(wastes)
        for key in sorted(progs):
            rec = progs[key]
            flops = rec.get("flops")
            gflops = (flops * rec["dispatches"] / rec["wall_s"] / 1e9
                      if flops and rec["wall_s"] > 0 and rec["dispatches"]
                      else None)
            eff = (gflops * occupancy
                   if gflops is not None and occupancy is not None else None)
            ledger_rows.append({
                "key": key, "kind": rec.get("kind"), "flops": flops,
                "dispatches": rec["dispatches"],
                "gflops_s": round(gflops, 4) if gflops is not None else None,
                "effective_gflops_s": (round(eff, 4)
                                       if eff is not None else None)})

    counts = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1

    # reliability summary: the "what fraction was retried/flagged/
    # escalated" question, straight from the event stream
    retries = [e for e in events if e["event"] == "shard_retry"]
    ooms = [e for e in events if e["event"] == "shard_oom_split"]
    quar = [e for e in events if e["event"] == "shard_quarantine"]
    esc = [e for e in events if e["event"] == "shard_escalate"]
    done = [e for e in events if e["event"] == "sweep_done"]
    reliability = None
    if retries or ooms or quar or esc or done:
        reasons = {}
        for e in quar:
            r = str(e.get("reason") or "?")
            reasons[r] = reasons.get(r, 0) + 1
        reliability = {
            "retries": len(retries),
            "retry_shards": sorted({e.get("shard") for e in retries}),
            "oom_splits": len(ooms),
            "quarantine_judgements": len(quar),
            "quarantine_recovered": sum(1 for e in quar
                                        if e.get("recovered")),
            "quarantine_reasons": reasons,
            "escalation_rungs": len(esc),
            "escalations_resolved": sum(1 for e in esc
                                        if e.get("resolved")),
            "sweeps_done": [
                {"n_cases": e.get("n_cases"),
                 "n_quarantined": e.get("n_quarantined"),
                 "n_flagged": e.get("n_flagged"),
                 "wall_s": e.get("wall_s")} for e in done]}

    return {
        "source": source,
        "meta": {"events": len(events), "bad_lines": n_bad,
                 "window_s": round(window, 6), "processes": len(pids),
                 "run_ids": run_ids},
        "spans": {"unmatched": len(unmatched), "paths": span_rows},
        "stages": stage_rows,
        "snapshot": snapshot,
        "workers": worker_rows,
        "serve": ({"endpoints": endpoint_rows, "ticks": tick_summary}
                  if endpoint_rows or ticks else None),
        "router": router_summary,
        "alerts": alerts_summary,
        "serve_stages": serve_stage_attribution(events),
        "cost_ledger": ({"occupancy": occupancy, "programs": ledger_rows}
                        if ledger_rows else None),
        "waste": waste_attribution(events, snapshot),
        "event_counts": counts,
        "reliability": reliability,
    }


def render_report(events, n_bad=0, source="<events>"):
    """Human-readable report (string) over one capture — the text
    rendering of :func:`report_data`."""
    data = report_data(events, n_bad, source)
    meta = data["meta"]
    out = []
    out.append(f"telemetry report — {source}")
    out.append(f"  {meta['events']} events"
               + (f" ({n_bad} unparseable lines skipped)" if n_bad else "")
               + f", window {meta['window_s']:.3f}s"
               + (f" across {meta['processes']} process(es)"
                  if meta["processes"] > 1 else "")
               + f", run_id(s): {', '.join(meta['run_ids']) or '—'}")

    span_rows = data["spans"]["paths"]
    unmatched = data["spans"]["unmatched"]
    if span_rows or unmatched:
        out.append("")
        out.append("span wall-time tree"
                   + (f"  [{unmatched} unmatched begin(s) — "
                      "process died mid-span]" if unmatched else ""))
        out.append(f"  {'':38s} {'count':>6s} {'total':>10s} "
                   f"{'p50':>10s} {'p95':>10s} {'max':>10s}")
        for r in span_rows:
            label = "  " * (len(r["path"]) - 1) + r["path"][-1]
            out.append(
                f"  {label:38s} {r['count']:6d} {_fmt_s(r['total_s'])} "
                f"{_fmt_s(r['p50_s'])} {_fmt_s(r['p95_s'])} "
                f"{_fmt_s(r['max_s'])}"
                + (f"   [{r['failed']} failed]" if r["failed"] else ""))

    if data["stages"]:
        out.append("")
        out.append("flat stage timings (structlog.stage)")
        for r in data["stages"]:
            out.append(
                f"  {r['name']:38s} {r['count']:6d} {_fmt_s(r['total_s'])} "
                f"{_fmt_s(r['p50_s'])} {_fmt_s(r['p95_s'])} "
                f"{_fmt_s(r['max_s'])}")

    snap = data["snapshot"]
    counters = snap.get("counters", {})
    if counters:
        out.append("")
        out.append("counters (final metrics snapshot)")
        for name, v in sorted(counters.items()):
            out.append(f"  {name:38s} {v}")
    gauges = snap.get("gauges", {})
    if gauges:
        out.append("")
        out.append("gauges (value / high watermark)")
        for name, g in sorted(gauges.items()):
            out.append(f"  {name:38s} {g.get('value')} / {g.get('max')}")
    hists = {k: h for k, h in snap.get("histograms", {}).items()
             if h.get("count")}
    if hists:
        out.append("")
        out.append("histograms (count / mean / p50 / p95 / max)")
        for name, h in sorted(hists.items()):
            out.append(
                f"  {name:38s} {h['count']:6d}  {h.get('mean')}  "
                f"{h.get('p50')}  {h.get('p95')}  {h.get('max')}")

    if data["workers"]:
        out.append("")
        out.append("fabric workers (shards / claims / steals / resumes / "
                   "total / p50 / p95)")
        for r in data["workers"]:
            out.append(
                f"  {r['worker']:20s} {r['shards']:6d} {r['claims']:6d} "
                f"{r['steals']:6d} {r['resumes']:7d} "
                f"{_fmt_s(r['total_s'])} "
                f"{_fmt_s(r['p50_s'])} "
                f"{_fmt_s(r['p95_s'])}")

    serve = data["serve"]
    if serve:
        out.append("")
        out.append("serve endpoints (endpoint / code / requests / "
                   "cache hits / p50 / p95 / max)")
        for r in serve["endpoints"]:
            out.append(
                f"  {r['endpoint']:24s} {r['code']:4d} {r['requests']:8d} "
                f"{r['cache_hits']:8d} "
                f"{_fmt_s(r['p50_s'])} "
                f"{_fmt_s(r['p95_s'])} "
                f"{_fmt_s(r['max_s'])}")
        t = serve["ticks"]
        if t:
            # occupancy vs the padded program sizes lives in the
            # serve_batch_occupancy histogram (metrics snapshot above);
            # this line is the tick-level view of the same batching
            out.append(
                f"  ticks: {t['ticks']} ({t['requests']} requests, "
                f"{t['unique_rows']} unique rows, "
                f"{t['dispatches']} dispatches; "
                f"mean batch {t['mean_batch']:.1f}, "
                f"tick p95 {t['p95_s']:.3f}s)")
            if t.get("ladder"):
                out.append(
                    f"  batch ladder: {t['ladder']['sizes']} "
                    f"(cost-pruned from {t['ladder']['candidates']})")

    router = data["router"]
    if router:
        out.append("")
        out.append("fleet router (replica / code / requests / attempts "
                   "/ hedged / p50 / p95 / max)")
        for r in router["replicas"]:
            out.append(
                f"  {r['replica']:20s} {r['code']:4d} {r['requests']:8d} "
                f"{r['attempts']:8d} {r['hedged']:6d} "
                f"{_fmt_s(r['p50_s'])} "
                f"{_fmt_s(r['p95_s'])} "
                f"{_fmt_s(r['max_s'])}")
        out.append(
            f"  ladder: {router['router_retry']} retries, "
            f"{router['router_hedge']} hedges, "
            f"{router['router_reject']} rejects; breakers "
            f"{router['breaker_open']} opened / "
            f"{router['breaker_close']} closed; membership "
            f"{router['replica_join']} joins / "
            f"{router['replica_drain']} drains / "
            f"{router['replica_evict']} evictions "
            f"({router['router_ring_update']} ring updates)")
        prov = router.get("provenance")
        if prov:
            if prov["consistent"]:
                out.append(
                    "  provenance: consistent — bank sha + code hash "
                    f"agree across {len(prov['replicas'])} replica(s)")
            else:
                out.append("  provenance: INCONSISTENT —")
                for s in prov["splits"]:
                    out.append(
                        f"    design {s['design']}: {s['field']} "
                        + "  ".join(f"{rid}={v}"
                                    for rid, v in s["values"].items()))

    alerts_summary = data["alerts"]
    if alerts_summary:
        out.append("")
        out.append("alerts & canaries (rule / severity / fires / "
                   "resolves)")
        for name, r in alerts_summary["rules"].items():
            out.append(f"  {name:32s} {str(r.get('severity') or '?'):10s} "
                       f"{r['fires']:6d} {r['resolves']:8d}")
        if alerts_summary["active_at_end"]:
            out.append("  STILL FIRING at capture end: "
                       + ", ".join(alerts_summary["active_at_end"]))
        c = alerts_summary["canary"]
        if c:
            out.append(
                f"  canary: {c['goldens']} golden(s), {c['checks']} "
                f"check(s), {c['failed']} failed "
                f"({c['provenance_failures']} provenance split(s))")

    attrib = data["serve_stages"]
    if attrib:
        out.append("")
        out.append(f"serve tail attribution ({attrib['n_requests']} "
                   "dispatched requests; p50/p95 columns are the stage "
                   "breakdown of the request at that latency rank)")
        out.append(f"  {'stage':24s} {'p50':>10s} {'p95':>10s} "
                   f"{'mean':>10s}")
        for stage in SERVE_STAGES:
            out.append(
                f"  {stage:24s} "
                f"{_fmt_s(attrib['p50']['stages'].get(stage))} "
                f"{_fmt_s(attrib['p95']['stages'].get(stage))} "
                f"{_fmt_s(attrib['mean']['stages'].get(stage))}")
        out.append(
            f"  {'total (measured)':24s} "
            f"{_fmt_s(attrib['p50']['total_s'])} "
            f"{_fmt_s(attrib['p95']['total_s'])} "
            f"{_fmt_s(attrib['mean']['total_s'])}")

    waste = data["waste"]
    if waste:
        out.append("")
        out.append("padding waste by axis (valid / padded / waste "
                   "/ row mean / row p95)")
        for axis, a in sorted(waste["axes"].items()):
            out.append(
                f"  {axis:16s} {a['valid']:10d} {a['padded']:10d} "
                f"{a['waste_frac']:8.4f}"
                + (f" {a['row_mean']:9.4f}" if a.get("row_mean") is not None
                   else "         —")
                + (f" {a['row_p95']:9.4f}" if a.get("row_p95") is not None
                   else "         —"))

    ledger = data["cost_ledger"]
    if ledger:
        out.append("")
        out.append("program cost ledger (key / kind / GFLOP / dispatches "
                   "/ achieved GFLOP/s / effective)")
        for r in ledger["programs"]:
            flops = r["flops"]
            out.append(
                f"  {r['key']:26s} {str(r.get('kind') or '?'):12s} "
                + (f"{flops / 1e9:10.3f}" if flops else "         —")
                + f" {r['dispatches']:6d} "
                + (f"{r['gflops_s']:10.2f}" if r["gflops_s"] is not None
                   else "         —")
                + (f" {r['effective_gflops_s']:10.2f}"
                   if r["effective_gflops_s"] is not None else "          —"))
        if ledger["occupancy"] is not None:
            out.append(f"  (effective = achieved x mean batch occupancy "
                       f"{ledger['occupancy']:.3f})")

    out.append("")
    out.append("event counts")
    for name, n in sorted(data["event_counts"].items(),
                          key=lambda kv: (-kv[1], kv[0])):
        out.append(f"  {name:38s} {n:6d}")

    rel = data["reliability"]
    if rel:
        out.append("")
        out.append("reliability summary")
        if rel["retries"]:
            out.append(f"  retries: {rel['retries']} "
                       f"(shards {rel['retry_shards']})")
        if rel["oom_splits"]:
            out.append(f"  oom splits: {rel['oom_splits']}")
        if rel["quarantine_judgements"]:
            nq, nr = rel["quarantine_judgements"], rel["quarantine_recovered"]
            out.append(f"  quarantine judgements: {nq} "
                       f"({nr} recovered, {nq - nr} kept bad)")
            for r, n in sorted(rel["quarantine_reasons"].items(),
                               key=lambda kv: -kv[1]):
                out.append(f"    reason {r}: {n}")
        if rel["escalation_rungs"]:
            out.append(f"  escalation rungs: {rel['escalation_rungs']} "
                       f"({rel['escalations_resolved']} resolved)")
        for e in rel["sweeps_done"]:
            out.append(
                f"  sweep_done: {e.get('n_cases')} cases, "
                f"{e.get('n_quarantined')} quarantined, "
                f"{e.get('n_flagged')} flagged, wall {e.get('wall_s')}s")
    return "\n".join(out) + "\n"


# ------------------------------------------------------------- tail view


def tail_view(events, rank=0.95):
    """"The actual p99 request": the single served request at latency
    rank ``rank``, reconstructed from a capture (``obs report --tail``).

    Ranks the ``serve_request_stages`` events by measured wall, picks
    the one at ``rank``, joins the ``exemplar_recorded`` attrs stamped
    by the batcher (design content hash, bucket signature, dispatched
    rows, cache-hit bit, int32 status word, replica id) on ``span_id``,
    and pulls the request's full span tree out of the capture by
    ``trace_id`` — so the tail is a concrete request with an identity
    and a timeline, not a percentile in a histogram.  Returns None when
    the capture has no stage events."""
    reqs = [e for e in events if e["event"] == "serve_request_stages"]
    if not reqs:
        return None
    reqs.sort(key=lambda e: float(e.get("wall_s") or 0.0))
    i = min(len(reqs) - 1, max(0, round(rank * (len(reqs) - 1))))
    e = reqs[i]
    stages = {s: float(e.get(f"{s}_s") or 0.0) for s in SERVE_STAGES}
    exemplar = None
    if e.get("span_id"):
        for x in events:
            if x["event"] == "exemplar_recorded" \
                    and x.get("span_id") == e["span_id"]:
                exemplar = {k: v for k, v in x.items()
                            if k not in ("t", "event", "pid", "run_id",
                                         "metric", "value")}
                exemplar["metric"] = x.get("metric")
                break
    tree = []
    if e.get("trace_id"):
        spans, _unmatched = collect_spans(events)
        trace_spans = [s for s in spans if s["trace_id"] == e["trace_id"]]
        by_parent: dict = {}
        for s in trace_spans:
            by_parent.setdefault(s["parent_id"], []).append(s)
        ids = {s["span_id"] for s in trace_spans}
        roots = sorted((s for s in trace_spans
                        if s["parent_id"] not in ids),
                       key=lambda s: s["t0"])

        def walk(s, depth):
            tree.append({"name": s["name"], "depth": depth,
                         "t0": s["t0"], "wall_s": s["wall_s"],
                         "ok": s.get("ok", True),
                         "span_id": s["span_id"],
                         "attrs": s["attrs"]})
            for c in sorted(by_parent.get(s["span_id"], []),
                            key=lambda c: c["t0"]):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 0)
    return {
        "rank": rank,
        "n_requests": len(reqs),
        "wall_s": round(float(e.get("wall_s") or 0.0), 6),
        "stages": {k: round(v, 6) for k, v in stages.items()},
        "stages_sum_s": round(sum(stages.values()), 6),
        "trace_id": e.get("trace_id"),
        "span_id": e.get("span_id"),
        "escalated": bool(e.get("escalated")),
        "exemplar": exemplar,
        "spans": tree,
    }


def render_tail(events, rank=0.95, source="<events>"):
    """Text rendering of :func:`tail_view` (``obs report --tail``)."""
    data = tail_view(events, rank)
    out = [f"tail exemplar — {source}"]
    if data is None:
        out.append("  no serve_request_stages events in this capture "
                   "(was a server handling dispatched requests?)")
        return "\n".join(out) + "\n"
    out.append(
        f"  the p{int(round(rank * 100))} request of "
        f"{data['n_requests']} dispatched: wall {data['wall_s']:.6f}s"
        + ("  [escalated]" if data["escalated"] else ""))
    ex = data["exemplar"]
    if ex:
        parts = [f"{k}={ex[k]}" for k in
                 ("design", "sig", "rows", "cache_hit", "status",
                  "replica") if ex.get(k) is not None]
        out.append("  identity: " + (", ".join(parts) or "—")
                   + (f"  (exemplar of {ex.get('metric')})"
                      if ex.get("metric") else ""))
    if data["trace_id"]:
        out.append(f"  trace {data['trace_id']}  span {data['span_id']}")
    out.append("")
    out.append(f"  {'stage':24s} {'wall':>10s}")
    for stage in SERVE_STAGES:
        out.append(f"  {stage:24s} {_fmt_s(data['stages'].get(stage))}")
    out.append(f"  {'sum of stages':24s} {_fmt_s(data['stages_sum_s'])}")
    out.append(f"  {'total (measured)':24s} {_fmt_s(data['wall_s'])}")
    if data["spans"]:
        out.append("")
        out.append("  span tree of this request's trace")
        for s in data["spans"]:
            label = "  " * s["depth"] + s["name"]
            attrs = ", ".join(f"{k}={v}" for k, v in sorted(
                s["attrs"].items()) if k not in ("remote_parent",
                                                 "boundary"))
            out.append(f"    {label:36s} {_fmt_s(s['wall_s'])}"
                       + (f"  [{attrs}]" if attrs else "")
                       + ("" if s["ok"] else "  FAILED"))
    elif data["span_id"]:
        out.append("")
        out.append("  (no spans for this trace in the capture — span "
                   "records need RAFT_TPU_LOG or a merged flight shard)")
    return "\n".join(out) + "\n"


# ----------------------------------------------------------- chrome trace


def _pid_time_offsets(events):
    """Per-pid timestamp offsets: ``t`` is monotonic within ONE
    process, so a capture appended across a resume (pinned
    ``RAFT_TPU_RUN_ID``) holds several pids whose clocks all start
    near zero.  Lay the processes out sequentially in file order (the
    real-world ordering of an append-mode capture) with a 1 ms gap."""
    bounds, order = {}, []
    for ev in events:
        pid = ev.get("pid") or 1
        b = bounds.get(pid)
        if b is None:
            bounds[pid] = [ev["t"], ev["t"]]
            order.append(pid)
        else:
            b[0] = min(b[0], ev["t"])
            b[1] = max(b[1], ev["t"])
    offsets, cursor = {}, 0.0
    for pid in order:
        lo, hi = bounds[pid]
        offsets[pid] = cursor - lo
        cursor += (hi - lo) + 1e-3
    return offsets


def chrome_trace(events, merged=False):
    """Chrome trace-event JSON (dict with ``traceEvents``) from one
    capture: matched spans as complete "X" slices, other events as
    instants, heartbeat memory samples as counter tracks.  Multi-pid
    captures (resume appends) render sequentially, one process track
    after the other — EXCEPT under ``merged=True``
    (:func:`merge_captures` already normalized every process onto one
    wall clock, so timestamps are used as-is and concurrent processes
    genuinely overlap on the timeline)."""
    spans, unmatched = collect_spans(events)
    offsets = {} if merged else _pid_time_offsets(events)
    tids = {}

    def tid_for(trace_id):
        if trace_id not in tids:
            tids[trace_id] = len(tids) + 1
        return tids[trace_id]

    def ts_of(t, pid):
        return round((t + offsets.get(pid or 1, 0.0)) * 1e6, 1)

    trace = []
    span_ids = set()
    for s in spans:
        span_ids.add(s["span_id"])
        args = dict(s["attrs"])
        args["span_id"] = s["span_id"]
        if s["parent_id"]:
            args["parent_id"] = s["parent_id"]
        if s["error"]:
            args["error"] = s["error"]
        trace.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": ts_of(s["t0"], s.get("pid")),
            "dur": round(max(s["t1"] - s["t0"], s["wall_s"] or 0.0) * 1e6, 1),
            "pid": s.get("pid") or 1,
            "tid": tid_for(s.get("trace_id")),
            "args": args,
        })
    for ev in events:
        kind = ev["event"]
        if kind in ("span_begin", "span_end"):
            continue
        pid = ev.get("pid") or 1
        tid = tid_for(ev.get("trace_id")) if ev.get("trace_id") else 0
        ts = ts_of(ev["t"], pid)
        if kind == "heartbeat":
            for d in ev.get("devices") or []:
                if "bytes_in_use" in d:
                    trace.append({
                        "name": f"device{d.get('id')} memory", "ph": "C",
                        "ts": ts, "pid": pid, "tid": 0,
                        "args": {"bytes_in_use": d["bytes_in_use"]}})
            if ev.get("live_arrays") is not None:
                trace.append({
                    "name": "live_arrays", "ph": "C", "ts": ts,
                    "pid": pid, "tid": 0,
                    "args": {"count": ev["live_arrays"]}})
            continue
        args = {k: v for k, v in ev.items()
                if k not in ("t", "event", "pid", "run_id",
                             "trace_id", "span_id")}
        trace.append({"name": kind, "cat": "event", "ph": "i", "s": "p",
                      "ts": ts, "pid": pid, "tid": tid, "args": args})
    # orphans: spans whose parent_id resolves to no span in the capture
    # — in a properly-propagated multi-process merge every worker root
    # chains to the coordinator's sweep span and every serve dispatch
    # to its tick, so the merged count must be 0 (the acceptance gate
    # `obs trace --merge --check` enforces).  Exceptions, both for
    # parents that legitimately live in an EXTERNAL tracer's telemetry:
    # a remote_parent span in a trace no other captured process
    # contributed to (a traced HTTP client hitting one server), and a
    # span stamped boundary="client" (the fleet router adopting a
    # client traceparent — its replicas' spans share the trace, but the
    # parent is still the client's).  Internally-propagated parents
    # (fabric coordinator -> workers, router -> replicas) get no
    # excuse: they must resolve in-capture.
    ids = {s["span_id"] for s in spans} | {b.get("span_id")
                                           for b in unmatched}
    pids_by_trace: dict = {}
    for s in spans:
        pids_by_trace.setdefault(s["trace_id"], set()).add(s.get("pid"))
    orphans = []
    for s in spans:
        if not s["parent_id"] or s["parent_id"] in ids:
            continue
        if s["attrs"].get("remote_parent") and (
                s["attrs"].get("boundary") == "client"
                or len(pids_by_trace.get(s["trace_id"], ())) <= 1):
            continue
        orphans.append(s)
    meta = {"spans_matched": len(spans),
            "spans_unmatched": len(unmatched),
            "spans_orphaned": len(orphans),
            "traces": len({s["trace_id"] for s in spans if s["trace_id"]}),
            "pids": len({e.get("pid") or 1 for e in events}),
            "run_ids": sorted({e.get("run_id") for e in events
                               if e.get("run_id")})}
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": meta}

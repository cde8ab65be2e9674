"""CLI for the telemetry subsystem (pure stdlib, no torch on import).

    python -m raft_tpu_torch.obs report <run.jsonl> [--format json]
    python -m raft_tpu_torch.obs report --merge <capture-dir | shards...>
    python -m raft_tpu_torch.obs trace  <run.jsonl> -o trace.json
    python -m raft_tpu_torch.obs trace  --merge <dir | shards...> -o t.json
    python -m raft_tpu_torch.obs events
    python -m raft_tpu_torch.obs spans
    python -m raft_tpu_torch.obs report <capture> --tail [RANK]
    python -m raft_tpu_torch.obs runs {record,list,compare,regress,ingest,pin}
    python -m raft_tpu_torch.obs alerts {list,check,eval}
    python -m raft_tpu_torch.obs flight {dump,show}

The verbs, options, output and exit codes of ``python -m raft_tpu.obs``.
``report`` prints the per-stage wall-time tree, counter table, fabric
per-worker table and the reliability summary of one ``RAFT_TPU_LOG``
capture (``--format json`` emits the same sections machine-readably);
``trace`` exports it as Chrome/Perfetto trace-event JSON.  ``--merge``
accepts several per-process capture shards (or a directory of
``trace-<pid>.jsonl`` files, the ``RAFT_TPU_LOG=<dir>`` layout) and
assembles coordinator + workers onto ONE wall-clock timeline using the
per-process ``proc_start`` clock anchors; ``--check`` (trace)
additionally exits 1 when the merged capture has unmatched span begins
or orphan spans.  ``events``/``spans`` list the registered schemas.
``flight`` dumps/validates the black-box recorder's shards (a damaged
shard exits 1).

``runs`` is the longitudinal perf store (:mod:`raft_tpu_torch.obs.runs`,
``RAFT_TPU_RUNS_DIR``): ``record`` appends a run record from the
current process/capture, ``list`` shows the trajectory, ``compare``
prints per-metric deltas between two records, ``regress`` gates the
newest record against the pinned baseline (exit 1 on regression,
env-fingerprint mismatch downgrades to warnings), ``ingest`` imports
``BENCH_rNN.json`` artifacts, ``pin`` chooses the baseline.

``alerts`` is the alert engine's offline face
(:mod:`raft_tpu_torch.obs.alerts`): ``list`` prints the effective rule
pack (default + ``RAFT_TPU_ALERT_RULES``/``--rules``, optionally
summarizing a ``RAFT_TPU_ALERTS`` sink), ``check`` validates it, and
``eval --record`` replays the rules against a stored run record — rate
rules gate on their cumulative totals — with no live process.

Exit codes: 0 ok, 1 check/regress failed, 2 usage/input error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load(paths, merge):
    from raft_tpu_torch.obs import report

    try:
        if merge:
            events, bad, info = report.merge_captures(paths)
        else:
            if len(paths) != 1:
                print("multiple captures need --merge", file=sys.stderr)
                raise SystemExit(2)
            events, bad = report.read_events(paths[0])
            info = None
    except OSError as e:
        print(f"cannot read {getattr(e, 'filename', None) or paths}: {e}",
              file=sys.stderr)
        raise SystemExit(2)
    if not events:
        print(f"{', '.join(paths)}: no parseable events (was RAFT_TPU_LOG "
              "pointed here during the run?)", file=sys.stderr)
        raise SystemExit(2)
    return events, bad, info


def _cmd_report(args):
    from raft_tpu_torch.obs import report

    events, bad, _ = _load(args.jsonl, args.merge)
    if args.tail is not None:
        source = ", ".join(args.jsonl)
        if args.format == "json":
            json.dump(report.tail_view(events, rank=args.tail),
                      sys.stdout, indent=1, default=str)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(report.render_tail(events, rank=args.tail,
                                                source=source))
        return 0
    if args.format == "json":
        json.dump(report.report_data(events, bad,
                                     source=", ".join(args.jsonl)),
                  sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(report.render_report(
            events, bad, source=", ".join(args.jsonl)))
    return 0


def _cmd_trace(args):
    from raft_tpu_torch.obs import report

    events, bad, info = _load(args.jsonl, args.merge)
    trace = report.chrome_trace(events, merged=args.merge)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    meta = trace["otherData"]
    print(f"{args.output}: {len(trace['traceEvents'])} trace events "
          f"({meta['spans_matched']} spans across {meta['pids']} "
          f"process(es), {meta['traces']} trace id(s)"
          + (f", {meta['spans_unmatched']} unmatched" if
             meta["spans_unmatched"] else "")
          + (f", {meta['spans_orphaned']} orphaned" if
             meta["spans_orphaned"] else "")
          + (f"; {info['unanchored_files']} unanchored shard(s)"
             if info and info.get("unanchored_files") else "")
          + (f"; {bad} unparseable lines skipped" if bad else "")
          + ") — open in chrome://tracing or ui.perfetto.dev")
    if args.check and (meta["spans_unmatched"] or meta["spans_orphaned"]):
        print(f"check FAILED: {meta['spans_unmatched']} unmatched begin(s), "
              f"{meta['spans_orphaned']} orphan span(s) — cross-process "
              "propagation is broken somewhere", file=sys.stderr)
        return 1
    return 0


def _cmd_events(_args):
    from raft_tpu_torch.obs import events as ev

    for name, fields, help_ in ev.describe():
        print(f"{name:32s} {', '.join(fields):56s} {help_}")
    return 0


def _cmd_spans(_args):
    from raft_tpu_torch.obs import events as ev

    for name, help_ in ev.describe_spans():
        print(f"{name:32s} {help_}")
    return 0


# ----------------------------------------------------------- flight verbs


def _cmd_flight_dump(args):
    """Persist THIS process's flight ring as one shard.  Mostly useful
    in-process (the ring is per-process); from the CLI it documents the
    dump format and gives scripts a deterministic writer."""
    from raft_tpu_torch.obs import flight

    path = flight.dump(trigger=args.trigger, path=args.output)
    if path is None:
        print("flight dump: nowhere to write — pass -o PATH or set "
              "RAFT_TPU_FLIGHT_DIR (and RAFT_TPU_FLIGHT_RING > 0)",
              file=sys.stderr)
        return 2
    print(f"{path}: flight shard written (trigger={args.trigger})")
    return 0


def _cmd_flight_show(args):
    """Validate + summarize one dump shard; exit 1 on a damaged or
    newer-schema shard (the lint.sh gate)."""
    from raft_tpu_torch.obs import flight

    return flight.show(args.shard)


# ----------------------------------------------------------- alerts verbs


def _alert_rules(args):
    from raft_tpu_torch.obs import alerts
    from raft_tpu_torch.utils import config

    path = getattr(args, "rules", None) or config.get("ALERT_RULES") or None
    return alerts.load_rules(path), path


def _cmd_alerts_list(args):
    from raft_tpu_torch.obs import alerts

    try:
        rules, path = _alert_rules(args)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"{len(rules)} rule(s)"
          + (f" (default pack + {path})" if path else " (default pack)"))
    print(f"  {'name':24s} {'severity':10s} {'predicate':12s} "
          f"{'threshold':>10s} {'for_s':>7s} {'clear_s':>7s}  metric")
    for r in sorted(rules, key=lambda r: r.name):
        print(f"  {r.name:24s} {r.severity:10s} {r.predicate:12s} "
              f"{r.threshold:10.4g} {r.for_s:7.1f} {r.clear_s:7.1f}  "
              f"{r.metric}")
    if args.sink:
        try:
            records, bad = alerts.read_sink(args.sink)
        except OSError as e:
            print(f"cannot read sink {args.sink}: {e}", file=sys.stderr)
            return 2
        print(f"\nsink {args.sink}: {len(records)} record(s)"
              + (f" ({bad} unparseable)" if bad else ""))
        for line in alerts.render_sink_summary(records):
            print(f"  {line}")
    return 0


def _cmd_alerts_check(args):
    """Rule-pack validation (the lint.sh gate): the default pack plus
    the given/flagged rule file must parse and validate.  Exit 0 ok,
    1 invalid."""
    try:
        rules, path = _alert_rules(args)
    except (OSError, ValueError) as e:
        print(f"alerts check FAILED: {e}", file=sys.stderr)
        return 1
    print(f"ok: {len(rules)} rule(s) valid"
          + (f" (default pack + {path})" if path else " (default pack)"))
    return 0


def _cmd_alerts_eval(args):
    """Replay the rule pack against a stored run record — no live
    process, no torch import.  Exit 0 clean, 1 when any rule fires."""
    from raft_tpu_torch.obs import alerts, runs

    try:
        rules, _path = _alert_rules(args)
        record = runs.load_record(args.record)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    fired, checked = alerts.replay_rules(rules, record)
    name = os.path.basename(args.record)
    print(f"alerts eval {name}: {checked}/{len(rules)} rule(s) "
          "applicable")
    for f in fired:
        print(f"  FIRED: {f['rule']} [{f['severity']}] {f['metric']} = "
              f"{f['value']:.6g} (replay threshold {f['threshold']:.6g})"
              + (f" — {f['help']}" if f.get("help") else ""))
    if fired:
        print(f"  FAILED: {len(fired)} rule(s) fired", file=sys.stderr)
        return 1
    print("  ok: no rules fired")
    return 0


# ------------------------------------------------------------- runs verbs


def _runs_store(args, need=True):
    from raft_tpu_torch.obs import runs

    d = getattr(args, "dir", None) or runs.runs_dir()
    if d is None and need:
        print("no run store: set RAFT_TPU_RUNS_DIR or pass --dir",
              file=sys.stderr)
        raise SystemExit(2)
    return d


def _cmd_runs_record(args):
    from raft_tpu_torch.obs import runs

    events = None
    if args.events:
        merge = len(args.events) > 1 or os.path.isdir(args.events[0])
        events, _bad, _ = _load(args.events, merge=merge)
    extra = {}
    if args.extra_json:
        try:
            extra = json.loads(args.extra_json)
            if not isinstance(extra, dict):
                raise ValueError("must be a JSON object")
        except ValueError as e:
            print(f"--extra-json: {e}", file=sys.stderr)
            return 2
    d = _runs_store(args)
    record = runs.build_record(args.kind, label=args.label, extra=extra,
                               events=events)
    path = runs.write_record(record, d)
    n = len(runs.flatten(record))
    print(f"{path}: recorded kind={args.kind} ({n} metrics)")
    return 0


def _cmd_runs_list(args):
    from raft_tpu_torch.obs import runs

    d = _runs_store(args)
    records = runs.list_records(d)
    if not records:
        print(f"{d}: no run records")
        return 0
    pinned = runs.pinned_baseline(d)
    import time as _time

    for path, rec in records:
        mark = "*" if pinned and os.path.samefile(path, pinned) else " "
        t = _time.strftime("%Y-%m-%d %H:%M:%S",
                           _time.localtime(rec.get("t_unix") or 0))
        env = rec.get("env") or {}
        where = ("ingested" if env.get("ingested")
                 else f"{env.get('platform', '?')}x"
                      f"{env.get('n_devices', '?')}")
        print(f"{mark} {os.path.basename(path):44s} {t}  "
              f"{rec.get('kind', '?'):12s} {str(rec.get('label') or '-'):16s} "
              f"{where:10s} {len(runs.flatten(rec)):4d} metrics")
    if pinned:
        print(f"baseline: {os.path.basename(pinned)}")
    return 0


def _fmt_v(v):
    return "—" if v is None else (f"{v:.6g}" if isinstance(v, float) else v)


def _cmd_runs_compare(args):
    from raft_tpu_torch.obs import runs

    try:
        a = runs.load_record(args.new)
        b = runs.load_record(args.baseline)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    rows = runs.compare_records(a, b)
    mismatch = runs.env_mismatch(a, b)
    print(f"compare {os.path.basename(args.new)} vs "
          f"{os.path.basename(args.baseline)}"
          + (f"  [env mismatch: {', '.join(mismatch)} — numbers not "
             "directly comparable]" if mismatch else ""))
    print(f"  {'metric':44s} {'baseline':>12s} {'new':>12s} "
          f"{'delta':>12s} {'pct':>8s}")
    for r in rows:
        # keep one-sided rows (metric present in only one record):
        # a metric DISAPPEARING is the biggest change of all
        if args.changed_only and r.get("delta") == 0:
            continue
        pct = r.get("pct")
        print(f"  {r['metric']:44s} {_fmt_v(r['base']):>12s} "
              f"{_fmt_v(r['new']):>12s} {_fmt_v(r.get('delta')):>12s} "
              + (f"{pct:+7.1f}%" if pct is not None else "       —"))
    return 0


def _cmd_runs_regress(args):
    from raft_tpu_torch.obs import runs
    from raft_tpu_torch.utils.structlog import log_event

    d = getattr(args, "dir", None) or runs.runs_dir()
    new_path = args.record
    base_path = args.baseline
    if new_path is None:
        records = runs.list_records(d) if d else []
        if not records:
            print("regress: no record given and no records in the store",
                  file=sys.stderr)
            return 2
        new_path = records[-1][0]
        # newest-vs-baseline: never judge the baseline against itself —
        # whether it came from the pin file or --baseline (a self-
        # compare trivially passes and the gate would check nothing)
        base = base_path or (runs.pinned_baseline(d) if d else None)
        if base and os.path.exists(base) \
                and os.path.samefile(new_path, base) and len(records) > 1:
            new_path = records[-2][0]
    if base_path is None:
        base_path = runs.pinned_baseline(d) if d else None
        if base_path is None:
            print("regress: no baseline pinned (obs runs pin <record>) "
                  "and no --baseline given", file=sys.stderr)
            return 2
    try:
        new = runs.load_record(new_path)
        base = runs.load_record(base_path)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    verdict = runs.regress_records(new, base, rel_tol=args.rel_tol)
    name_new, name_base = (os.path.basename(new_path),
                           os.path.basename(base_path))
    print(f"regress {name_new} vs baseline {name_base}: "
          f"{verdict['checked']} watched metrics checked")
    if verdict["env_mismatch"]:
        print(f"  WARNING: environment mismatch on "
              f"{', '.join(verdict['env_mismatch'])} — numbers are not "
              "comparable across hosts/backends; regressions downgraded "
              "to warnings")
    if verdict.get("kind_mismatch"):
        print(f"  note: comparing kind={new.get('kind')!r} against "
              f"kind={base.get('kind')!r} — only their shared metrics "
              "are checked")
    for r in verdict["regressions"]:
        tag = "warning" if verdict["env_mismatch"] else "REGRESSION"
        arrow = "↑" if r["better"] == "lower" else "↓"
        print(f"  {tag}: {r['metric']} {arrow} {_fmt_v(r['base'])} -> "
              f"{_fmt_v(r['new'])} (worse by {_fmt_v(r['worsening'])}, "
              f"threshold {_fmt_v(r['threshold'])})")
        if not verdict["env_mismatch"]:
            log_event("regression_detected", metric=r["metric"],
                      base=r["base"], new=r["new"],
                      threshold=r["threshold"], baseline=name_base,
                      record=name_new)
    for r in verdict["improvements"]:
        print(f"  improved: {r['metric']} {_fmt_v(r['base'])} -> "
              f"{_fmt_v(r['new'])}")
    if verdict["ok"]:
        print("  ok: no regressions"
              + (" gated (env mismatch)" if verdict["env_mismatch"]
                 and verdict["regressions"] else ""))
        return 0
    print(f"  FAILED: {len(verdict['regressions'])} regression(s)",
          file=sys.stderr)
    return 1


def _cmd_runs_ingest(args):
    from raft_tpu_torch.obs import runs

    d = _runs_store(args)
    n = 0
    for path in args.files:
        try:
            record = runs.ingest_bench(path)
        except (OSError, ValueError) as e:
            print(f"skip {path}: {e}", file=sys.stderr)
            continue
        out = runs.write_record(record, d)
        print(f"{os.path.basename(path)} -> {os.path.basename(out)} "
              f"({len(runs.flatten(record))} metrics)")
        n += 1
    return 0 if n or not args.files else 2


def _cmd_runs_pin(args):
    from raft_tpu_torch.obs import runs

    d = _runs_store(args)
    try:
        pin = runs.pin_baseline(args.record, d)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"pinned {os.path.basename(args.record)} as baseline ({pin})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="summarize one RAFT_TPU_LOG capture")
    p.add_argument("jsonl", nargs="+",
                   help="captured JSONL stream(s), or a capture directory "
                        "with --merge")
    p.add_argument("--merge", action="store_true",
                   help="assemble several per-process shards onto one "
                        "wall-clock timeline (proc_start anchors)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="'json' emits every report section machine-"
                        "readably (the run-record 'report' payload)")
    p.add_argument("--tail", nargs="?", const=0.95, default=None,
                   type=float, metavar="RANK",
                   help="render THE request at this latency rank "
                        "(default p95): its exemplar identity, stage "
                        "decomposition and full span tree")

    p = sub.add_parser("trace",
                       help="export a capture as Chrome trace events")
    p.add_argument("jsonl", nargs="+",
                   help="captured JSONL stream(s), or a capture directory "
                        "with --merge")
    p.add_argument("-o", "--output", default="trace.json",
                   help="output path (default trace.json)")
    p.add_argument("--merge", action="store_true",
                   help="assemble several per-process shards onto one "
                        "wall-clock timeline (proc_start anchors)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on unmatched or orphan spans (CI gate "
                        "for cross-process trace propagation)")

    sub.add_parser("events", help="list the registered event schema")
    sub.add_parser("spans", help="list the registered span names")

    p = sub.add_parser("flight",
                       help="black-box flight recorder: dump this "
                            "process's ring, validate/summarize shards "
                            "(raft_tpu_torch.obs.flight)")
    fsub = p.add_subparsers(dest="flight_cmd", required=True)

    f = fsub.add_parser("dump", help="persist the in-process ring as "
                                     "one schema-versioned JSONL shard")
    f.add_argument("-o", "--output", default=None,
                   help="output path (default: RAFT_TPU_FLIGHT_DIR/"
                        "flight-<pid>-<trigger>.jsonl)")
    f.add_argument("--trigger", default="manual",
                   help="trigger tag for the header + filename "
                        "(default manual)")

    f = fsub.add_parser("show",
                        help="strictly validate + summarize one dump "
                             "shard (exit 1 on a damaged/truncated/"
                             "newer-schema shard — the lint.sh gate)")
    f.add_argument("shard", help="a flight-*.jsonl dump shard")

    p = sub.add_parser("alerts",
                       help="alert-rule engine: list/check the rule "
                            "pack, replay it against stored run "
                            "records (raft_tpu_torch.obs.alerts)")
    asub = p.add_subparsers(dest="alerts_cmd", required=True)

    a = asub.add_parser("list", help="print the effective rule pack "
                                     "(default + RAFT_TPU_ALERT_RULES/"
                                     "--rules)")
    a.add_argument("--rules", default=None,
                   help="YAML/JSON rule file over the default pack")
    a.add_argument("--sink", default=None,
                   help="also summarize a RAFT_TPU_ALERTS JSONL sink")

    a = asub.add_parser("check", help="validate the rule pack "
                                      "(exit 1 on an invalid rule — "
                                      "the lint.sh gate)")
    a.add_argument("--rules", default=None)

    a = asub.add_parser(
        "eval",
        help="replay the rule pack against a stored run record")
    a.add_argument("--record", required=True,
                   help="a run-record .json from the RAFT_TPU_RUNS_DIR "
                        "store (or a checked-in fixture)")
    a.add_argument("--rules", default=None)

    p = sub.add_parser("runs",
                       help="longitudinal run-record store + regression "
                            "sentinel (RAFT_TPU_RUNS_DIR)")
    rsub = p.add_subparsers(dest="runs_cmd", required=True)

    r = rsub.add_parser("record", help="append one run record from the "
                                       "current process state")
    r.add_argument("--kind", default="manual")
    r.add_argument("--label", default=None)
    r.add_argument("--events", nargs="+", default=None,
                   help="fold a RAFT_TPU_LOG capture's report sections "
                        "into the record (machine-readable obs report)")
    r.add_argument("--extra-json", default=None,
                   help="JSON object of extra scalar metrics")
    r.add_argument("--dir", default=None)

    r = rsub.add_parser("list", help="list the stored run trajectory")
    r.add_argument("--dir", default=None)

    r = rsub.add_parser("compare", help="per-metric deltas of two records")
    r.add_argument("new")
    r.add_argument("baseline")
    r.add_argument("--changed-only", action="store_true")

    r = rsub.add_parser(
        "regress",
        help="gate a record against the pinned baseline (exit 1 on "
             "regression; env mismatch downgrades to warnings)")
    r.add_argument("record", nargs="?", default=None,
                   help="record to judge (default: newest in the store)")
    r.add_argument("--baseline", default=None,
                   help="baseline record (default: the pinned one)")
    r.add_argument("--dir", default=None)
    r.add_argument("--rel-tol", type=float, default=None,
                   help="override RAFT_TPU_RUNS_REL_TOL")
    r.add_argument("--check", action="store_true",
                   help="CI alias: identical gating, spelled explicitly "
                        "in lint.sh")

    r = rsub.add_parser("ingest",
                        help="import BENCH_rNN.json artifacts as records")
    r.add_argument("files", nargs="+")
    r.add_argument("--dir", default=None)

    r = rsub.add_parser("pin", help="pin one record as THE baseline")
    r.add_argument("record")
    r.add_argument("--dir", default=None)

    args = ap.parse_args(argv)
    if args.cmd == "runs":
        return {"record": _cmd_runs_record, "list": _cmd_runs_list,
                "compare": _cmd_runs_compare, "regress": _cmd_runs_regress,
                "ingest": _cmd_runs_ingest,
                "pin": _cmd_runs_pin}[args.runs_cmd](args)
    if args.cmd == "alerts":
        return {"list": _cmd_alerts_list, "check": _cmd_alerts_check,
                "eval": _cmd_alerts_eval}[args.alerts_cmd](args)
    if args.cmd == "flight":
        return {"dump": _cmd_flight_dump,
                "show": _cmd_flight_show}[args.flight_cmd](args)
    return {"report": _cmd_report, "trace": _cmd_trace,
            "events": _cmd_events, "spans": _cmd_spans}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

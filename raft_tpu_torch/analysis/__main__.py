"""CLI of the port's checkers (counterpart of ``python -m
raft_tpu.analysis``).

    python -m raft_tpu_torch.analysis lint [--json] [paths...]
    python -m raft_tpu_torch.analysis concurrency [--json] [paths...]
    python -m raft_tpu_torch.analysis schemas [--json] [--write | --fixture]
    python -m raft_tpu_torch.analysis protocol {check,extract,baseline}
        [--json] [--write] [--fixture PATH] [--static-only]
    python -m raft_tpu_torch.analysis contracts [--design JSON] [--modes ...]
        [--fixture PATH]
    python -m raft_tpu_torch.analysis baseline --write [--design JSON]
    python -m raft_tpu_torch.analysis flags

Exit codes: 0 clean, 1 findings/violations, 2 usage error or a broken
engine.  ``lint``, ``concurrency``, ``schemas``, ``protocol`` and
``flags`` import neither torch nor jax; ``contracts`` / ``baseline``
record the entries' aten ops on the CPU.  ``--json`` swaps the human
text for one machine-readable document (see
:mod:`raft_tpu_torch.analysis.report`).
"""

from __future__ import annotations

import argparse
import sys


def _cmd_lint(args):
    from raft_tpu_torch.analysis import lint, report

    findings = lint.lint_paths(args.paths or None)
    if not args.paths:
        # the dead-entry audit only makes sense over the full scan set
        # (a partial path list would flag every registration as dead)
        findings.extend(lint.registered_unused())
    rc = report.emit(
        "lint", findings, args.json,
        clean_note="lint clean "
        f"({len(args.paths) or len(lint.default_paths())} files).")
    if rc and not args.json:
        print(f"{len(findings)} finding(s). Suppress intentional ones with "
              "`# raft-lint: disable=<rule>`.", file=sys.stderr)
    return rc


def _cmd_concurrency(args):
    from raft_tpu_torch.analysis import concurrency, report

    findings = concurrency.analyze_paths(args.paths or None)
    scope = (f"{len(args.paths)} file(s)" if args.paths
             else "shared-state + serve modules")
    rc = report.emit("concurrency", findings, args.json,
                     clean_note=f"concurrency invariants clean ({scope}).")
    if rc and not args.json:
        print(f"{len(findings)} finding(s). Suppress audited exceptions "
              "with `# raft-lint: disable=<rule>`.", file=sys.stderr)
    return rc


def _cmd_schemas(args):
    from raft_tpu_torch.analysis import report, schemas

    if args.fixture:
        violations, _ = schemas.run_fixture_checks()
        if not violations:
            print("schema drift fixture produced NO violations — the "
                  "engine is broken", file=sys.stderr)
            return 2
        rc = report.emit("schemas", violations, args.json,
                         extra={"fixture": True})
        if not args.json:
            print(f"{len(violations)} violation(s) (seeded fixture drill).",
                  file=sys.stderr)
        return rc
    if args.write:
        contracts = schemas.extract_all()
        drift = []
        for name, contract in contracts.items():
            drift.extend(schemas.drift_violations(name, contract))
        if drift:
            # never bake live writer/reader drift into the baseline
            for v in drift:
                print(v, file=sys.stderr)
            print("refusing to write a baseline over live drift",
                  file=sys.stderr)
            return 1
        path = schemas.write_baseline(contracts)
        print(f"schema baseline written: {path} "
              f"({len(contracts)} families)")
        return 0
    violations, contracts = schemas.run_checks()
    n_keys = sum(len(c["written"]) + len(c["read"])
                 for c in contracts.values())
    rc = report.emit(
        "schemas", violations, args.json,
        clean_note=f"schema contracts clean ({len(contracts)} families, "
                   f"{n_keys} keys).",
        extra={"families": len(contracts), "keys": n_keys})
    if rc and not args.json:
        print(f"{len(violations)} schema-contract violation(s). "
              "Intentional evolution: `python -m raft_tpu_torch.analysis "
              "schemas --write` and commit the diff.", file=sys.stderr)
    return rc


def _cmd_protocol(args):
    from raft_tpu_torch.analysis import protocol, report

    if args.mode == "extract":
        sites, unmodeled = protocol.extract_all()
        if args.json:
            findings = [
                {"file": s.path, "line": s.line, "col": s.col,
                 "rule": ("protocol-unmodeled" if not s.modeled
                          else "protocol-site"),
                 "message": s.key, "action": s.action}
                for s in sites]
            report.emit("protocol", findings, True,
                        extra={"mode": "extract",
                               "unmodeled": len(unmodeled)})
        else:
            for s in sites:
                mark = "!" if not s.modeled else " "
                print(f"{mark} {s.key:58s} {s.action or 'UNMODELED':10s} "
                      f"{s.path}:{s.line}")
            print(f"{len(sites)} mutation site(s), "
                  f"{len(unmodeled)} unmodeled.", file=sys.stderr)
        return 1 if unmodeled else 0

    if args.mode == "baseline":
        if not args.write:
            print("baseline is checked in; pass --write to re-pin "
                  "(after an intentional protocol change)",
                  file=sys.stderr)
            return 2
        try:
            data = protocol.write_baseline()
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"protocol baseline written: {protocol.BASELINE_PATH} "
              f"({len(data['sites'])} sites, "
              f"{len(data['invariants'])} invariants)")
        return 0

    # mode == "check"
    if args.fixture:
        findings, stats = protocol.run_fixture(args.fixture)
        if not findings:
            print("protocol fixture produced NO findings — the engine "
                  "is broken", file=sys.stderr)
            return 2
        rc = report.emit("protocol", findings, args.json,
                         extra={"fixture": args.fixture, "stats": stats})
        if not args.json:
            print(f"{len(findings)} finding(s) (seeded fixture drill).",
                  file=sys.stderr)
        return rc
    findings, stats = protocol.check(explore=not args.static_only)
    rc = report.emit(
        "protocol", findings, args.json,
        clean_note="protocol model clean"
        + ("" if args.static_only else
           " (%d runs, %d states explored)" % (
               sum(s.get("runs", 0) for s in stats.values()),
               sum(s.get("states", 0) for s in stats.values()))) + ".",
        extra={"stats": stats})
    if rc and not args.json:
        print(f"{len(findings)} protocol finding(s). Intentional "
              "surface change: extend the mcheck model, then "
              "`python -m raft_tpu_torch.analysis protocol baseline --write`.",
              file=sys.stderr)
    return rc


def _cmd_contracts(args, update_baseline=False):
    from raft_tpu_torch.analysis import contracts

    if getattr(args, "fixture", None):
        violations = contracts.run_fixture(args.fixture)
        if not violations:
            print("contract fixture produced NO violations — the engine "
                  "is broken", file=sys.stderr)
            return 2
        for v in violations:
            print(v)
        print(f"{len(violations)} violation(s) (seeded fixture drill).",
              file=sys.stderr)
        return 1
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    report = contracts.run_checks(design=args.design, dtype_modes=modes,
                                  update_baseline=update_baseline)
    for line in report["log"]:
        print(line)
    if report["violations"]:
        print(f"{len(report['violations'])} contract violation(s):",
              file=sys.stderr)
        for v in report["violations"]:
            print("  " + v, file=sys.stderr)
        return 1
    if update_baseline:
        print(f"baseline written: {contracts.baseline_path()}")
    print("op contracts clean.")
    return 0


def _cmd_baseline(args):
    if not args.write:
        print("baseline is checked in; pass --write to regenerate "
              "(after an intentional hot-path change)", file=sys.stderr)
        return 2
    return _cmd_contracts(args, update_baseline=True)


def _cmd_flags(_args):
    from raft_tpu_torch.utils.config import FLAGS

    rows = [(f.env, f.kind, f.default, f.help) for f in FLAGS.values()]
    w = max(len(r[0]) for r in rows)
    for env, kind, default, help_ in sorted(rows):
        print(f"{env:<{w}}  {kind:<6}  default={default!r}  {help_}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _json_flag(parser):
        parser.add_argument(
            "--json", action="store_true",
            help="emit one machine-readable JSON document instead of "
                 "the human text format")
        return parser

    p = _json_flag(sub.add_parser(
        "lint", help="run the trace-hygiene AST linter"))
    p.add_argument("paths", nargs="*", help="files to lint "
                   "(default: raft_tpu_torch/ + bench.py + sweep_10k.py)")

    p = _json_flag(sub.add_parser(
        "concurrency",
        help="concurrency invariants: atomic-write, async-blocking, "
             "lock-discipline, thread-hygiene"))
    p.add_argument("paths", nargs="*",
                   help="files to analyze with every rule forced on "
                        "(default: the audited shared-state + serve "
                        "modules with per-module rule gating)")

    p = _json_flag(sub.add_parser(
        "schemas",
        help="cross-process writer/reader schema contracts vs the "
             "checked-in analysis/schema_baseline.json"))
    p.add_argument("--write", action="store_true",
                   help="regenerate the baseline (intentional schema "
                        "evolution; refuses over live drift)")
    p.add_argument("--fixture", action="store_true",
                   help="run the seeded drifted-lease fixture drill "
                        "(must exit 1 — the CI negative)")

    p = _json_flag(sub.add_parser(
        "protocol",
        help="protocol model checker: static mutation-site extraction "
             "vs analysis/protocol_baseline.json + exhaustive "
             "interleaving/crash exploration of the fs state machines"))
    p.add_argument("mode", choices=("check", "extract", "baseline"),
                   help="check: diff sites vs baseline and explore; "
                        "extract: list every mutation site; "
                        "baseline: re-pin the site model (--write)")
    p.add_argument("--write", action="store_true",
                   help="with `baseline`: re-pin protocol_baseline.json "
                        "(refuses over unmodeled sites)")
    p.add_argument("--fixture", metavar="PATH",
                   help="with `check`: drive the engines against a "
                        "seeded-bug fixture module (must exit 1 — the "
                        "CI negative)")
    p.add_argument("--static-only", action="store_true",
                   help="with `check`: skip the interleaving explorer "
                        "(extraction diff only)")

    for name in ("contracts", "baseline"):
        p = sub.add_parser(
            name, help=("check the entries' op contracts + op budgets"
                        if name == "contracts"
                        else "regenerate the op-count baseline"))
        p.add_argument("--design", default=None,
                       help="design JSON (default: the spar demo, "
                            "tests/fixtures/torch_port/design_spar.json)")
        p.add_argument("--modes", default="float64,float32",
                       help="comma list of RAFT_TPU_DTYPE modes to record")
        if name == "baseline":
            p.add_argument("--write", action="store_true")
        else:
            p.add_argument("--fixture", metavar="PATH",
                           help="record the entries of a seeded contract "
                                "negative with its patches applied (must "
                                "exit 1 — the CI negative)")

    sub.add_parser("flags", help="list the RAFT_TPU_* flag registry")

    args = ap.parse_args(argv)
    cmd = {"lint": _cmd_lint, "concurrency": _cmd_concurrency,
           "schemas": _cmd_schemas, "protocol": _cmd_protocol,
           "contracts": _cmd_contracts, "baseline": _cmd_baseline,
           "flags": _cmd_flags}[args.cmd]
    return cmd(args)


if __name__ == "__main__":
    sys.exit(main())

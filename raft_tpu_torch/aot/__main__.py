"""CLI of the program bank (the port's counterpart of ``python -m
raft_tpu.aot``).

    python -m raft_tpu_torch.aot warmup [--design PATH ...] [--n 512,8]
                                        [--kinds cases,full,design]
                                        [--out-keys PSD,X0,status]
                                        [--device cpu] [--dtype float64]
    python -m raft_tpu_torch.aot list
    python -m raft_tpu_torch.aot verify
    python -m raft_tpu_torch.aot gc [--max-age-days D] [--all] [--dry-run]
    python -m raft_tpu_torch.aot release {cut,list,verify,promote,rollback}

Exit codes: 0 clean, 1 problems (verify) / failed warm-up, 2 usage (a
typo'd kind; no CUDA device and no ``--device``).

``warmup`` runs the programs on ``--device`` (default: the current
CUDA device; ``cpu`` for the CPU) under ``--dtype`` (the compute-dtype
policy, ``RAFT_TPU_DTYPE``; the reference's ``--x64``).  Warm with
EXACTLY the device, dtype policy and flags the serving process or
worker will run — all are part of the bank key, so a mismatch is a
clean but total miss.  ``release verify --manifest`` checks one
manifest file and imports no torch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _apply_dtype(dtype):
    if dtype:
        from raft_tpu_torch.utils import config

        os.environ[config.env_name("DTYPE")] = dtype


def _device(arg):
    """The ``--device`` argument resolved, or None after printing why
    (no CUDA device and none given)."""
    from raft_tpu_torch.utils.dtypes import resolve_device

    try:
        return resolve_device(arg)
    except RuntimeError as e:
        print(f"{e} (--device cpu)", file=sys.stderr)
        return None


def _cmd_warmup(args):
    _apply_dtype(args.dtype)
    from raft_tpu_torch.aot import warmup

    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    unknown = set(kinds) - set(warmup.ALL_KINDS)
    if unknown:   # before any device work, e.g. a typo'd --kinds entry
        print(f"unknown warmup kind(s) {sorted(unknown)}; choose from "
              f"{list(warmup.ALL_KINDS)}", file=sys.stderr)
        return 2
    device = _device(args.device)
    if device is None:
        return 2
    sizes = [int(s) for s in args.n.split(",") if s.strip()]
    out_keys = tuple(k.strip() for k in args.out_keys.split(",") if k.strip())
    designs = list(args.design or ())
    reports = warmup.warmup_model(
        design=designs[0] if designs else None, sizes=sizes,
        kinds=kinds, out_keys=out_keys, device=device,
        designs=designs if len(designs) > 1 else None)
    for r in reports:
        how = ("already banked" if r["loaded"] and not r["compiled"]
               else f"compiled {r['compiled']} program(s)")
        print(f"warmup {r['kind']:<7} rows={r['rows']:<6} {how} "
              f"in {r['wall_s']}s, {r['launches']} kernel launch(es)")
    from raft_tpu_torch.aot import bank

    print(f"bank: {bank.bank_dir()}")
    return 0


def _fmt_age(created):
    if not created:
        return "?"
    days = (time.time() - created) / 86400.0
    return f"{days:.1f}d"


def _cmd_list(_args):
    from raft_tpu_torch.aot import bank

    rows = []
    for key, meta, meta_path, _path in bank.scan():
        if meta is None:
            rows.append((key, "?", "?", "?", "?",
                         "ORPHAN" if meta_path is None else "CORRUPT"))
            continue
        env = meta.get("environment") or {}
        state = "stale" if bank.is_stale(meta) else "ok"
        rows.append((key, meta.get("kind", "?"),
                     f"{env.get('device')}/{env.get('dtype')}",
                     f"{(meta.get('payload_bytes') or 0) / 1e6:.1f}MB",
                     _fmt_age(meta.get("created")), state))
    if not rows:
        print(f"bank empty: {bank.bank_dir()}")
        return 0
    widths = [max(len(str(r[i])) for r in rows) for i in range(6)]
    hdr = ("key", "kind", "env", "size", "age", "state")
    for r in (hdr,) + tuple(rows):
        print("  ".join(str(v).ljust(w) for v, w in zip(r, widths)))
    print(f"{len(rows)} entr{'y' if len(rows) == 1 else 'ies'} in "
          f"{bank.bank_dir()}")
    return 0


def _cmd_verify(_args):
    from raft_tpu_torch.aot import bank

    problems, notes, n = bank.verify_bank()
    for note in notes:
        print(f"note: {note}")
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    if problems:
        print(f"aot verify: {len(problems)} problem(s) across {n} "
              f"entr{'y' if n == 1 else 'ies'}.", file=sys.stderr)
        return 1
    print(f"aot bank verified: {n} entr{'y' if n == 1 else 'ies'}, "
          f"{len(notes)} note(s), 0 problems ({bank.bank_dir()}).")
    return 0


def _cmd_gc(args):
    from raft_tpu_torch.aot import bank

    s = bank.gc_bank(max_age_days=args.max_age_days,
                     remove_all=args.all, dry_run=args.dry_run)
    verb = "would remove" if args.dry_run else "removed"
    print(f"aot gc: {verb} {s['removed']} entr"
          f"{'y' if s['removed'] == 1 else 'ies'} "
          f"({s['bytes_freed'] / 1e6:.1f}MB), kept {s['kept']}.")
    return 0


def _cmd_release(args):
    from raft_tpu_torch.aot import release

    if args.release_cmd == "cut":
        _apply_dtype(args.dtype)
        man = release.cut(label=args.label, promote_after=args.promote)
        state = "promoted" if args.promote else "cut"
        print(f"release {man['release']} {state}: {man['n_entries']} "
              f"entr{'y' if man['n_entries'] == 1 else 'ies'}, parent "
              f"{man['parent'] or 'none'} ({release.releases_dir()})")
        return 0

    if args.release_cmd == "list":
        cur = release.current_release()
        mans = release.list_releases()
        if not mans:
            print(f"no releases under {release.releases_dir()}")
            return 0
        for man in mans:
            mark = "*" if man["release"] == cur else " "
            print(f"{mark} {man['release']}  entries={man['n_entries']:<4}"
                  f" parent={man.get('parent') or '-':<12}"
                  f" age={_fmt_age(man.get('created'))}"
                  f"  {man.get('label') or ''}")
        print(f"{len(mans)} release(s); * = current")
        return 0

    if args.release_cmd == "verify":
        return _cmd_release_verify(args)

    if args.release_cmd == "promote":
        previous = release.promote(args.release)
        print(f"current -> {args.release} (was {previous or 'unset'})")
        return 0

    if args.release_cmd == "rollback":
        rid, parent = release.rollback()
        print(f"rolled back: current {rid} -> parent {parent}")
        return 0
    return 2


def _cmd_release_verify(args):
    """Integrity (+ optionally bank / live-design) check of one
    release.  ``--manifest PATH`` is a pure file check — no bank, no
    torch; the default target is the ``current`` release."""
    from raft_tpu_torch.aot import release

    if args.manifest:
        man = release.load_manifest(args.manifest)
        if man is None:
            print(f"PROBLEM: unreadable manifest {args.manifest}",
                  file=sys.stderr)
            return 1
        problems = release.verify_manifest(man)
    else:
        rid = args.release or release.current_release()
        if rid is None:
            print("no --release/--manifest given and no current "
                  "release pointer", file=sys.stderr)
            return 2
        man = release.load_release(rid)
        if man is None:
            print(f"PROBLEM: no release {rid} under "
                  f"{release.releases_dir()}", file=sys.stderr)
            return 1
        problems = release.verify_manifest(man)
        if not problems:
            problems = release.verify_against_bank(man)
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    if problems:
        print(f"release verify: {len(problems)} problem(s).",
              file=sys.stderr)
        return 1
    if args.against_designs:
        _apply_dtype(args.dtype)
        device = _device(args.device)
        if device is None:
            return 2
        from raft_tpu_torch.serve import engine

        reg = engine.Registry()
        paths = []
        for spec in args.against_designs:
            name, _, path = spec.rpartition("=")
            path = path or spec
            reg.register(name or f"design-{len(paths)}", path)
            paths.append(path)
        entries = [reg.get(n) for n in reg.names()]
        report = release.diagnose(entries, device=device, manifest=man)
        if report["unwarmed"]:
            for line in release.format_diagnosis(
                    report, paths, dtype=args.dtype, device=args.device):
                print(line, file=sys.stderr)
            return 1
        print(f"release {man['release']}: all {report['total']} serve "
              "program(s) warmed for the given designs.")
        return 0
    print(f"release {man['release']} verified: {man['n_entries']} "
          f"entr{'y' if man['n_entries'] == 1 else 'ies'}, 0 problems.")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.aot")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("warmup", help="build, run and store the sweep and "
                                      "serving programs of a design")
    p.add_argument("--design", action="append", default=None,
                   help="design .json/.yaml (default: the bundled spar "
                        "demo); repeatable — several designs warm the "
                        "serve kind's whole design set in one pass "
                        "(deduplicated by bucket signature)")
    p.add_argument("--n", default="8",
                   help="comma list of batch sizes to warm (rounded up "
                        "to the dp mesh-axis size)")
    p.add_argument("--kinds", default=",".join(
        ("cases", "full", "design")),
        help="comma list of kinds: cases,full,design,bucketed,serve "
             "(bucketed warms the bucket programs of the bundled design "
             "trio; serve warms the serving engine's programs at the "
             "RAFT_TPU_SERVE_MAX_BATCH batch ladder — --n is ignored "
             "for it)")
    p.add_argument("--out-keys", default="PSD,X0,status",
                   help="out_keys of the warmed programs")
    p.add_argument("--device", default=None,
                   help="device the programs run on (default: the "
                        "current CUDA device; 'cpu' for the CPU)")
    p.add_argument("--dtype", default=None, choices=("float32", "float64"),
                   help="compute-dtype policy (RAFT_TPU_DTYPE; part of the "
                        "bank key, so warm with the server's)")

    sub.add_parser("list", help="table of bank entries")
    sub.add_parser("verify", help="integrity-check the bank (CI gate)")

    p = sub.add_parser("gc", help="remove stale/orphaned/corrupt entries")
    p.add_argument("--max-age-days", type=float, default=None)
    p.add_argument("--all", action="store_true",
                   help="empty the port's bank entirely")
    p.add_argument("--dry-run", action="store_true")

    p = sub.add_parser("release", help="immutable, content-addressed "
                                       "releases of the bank")
    rsub = p.add_subparsers(dest="release_cmd", required=True)
    rp = rsub.add_parser("cut", help="snapshot the warmed bank into a "
                                     "signed release manifest")
    rp.add_argument("--label", default=None,
                    help="free-form annotation (not part of the id)")
    rp.add_argument("--promote", action="store_true",
                    help="flip the current pointer to the new release")
    rp.add_argument("--dtype", default=None,
                    choices=("float32", "float64"))
    rsub.add_parser("list", help="table of releases (* = current)")
    rp = rsub.add_parser("verify", help="integrity-check a release "
                                        "(CI gate)")
    rp.add_argument("--release", default=None,
                    help="release id (default: the current pointer)")
    rp.add_argument("--manifest", default=None,
                    help="verify ONE manifest file in isolation "
                         "(pure integrity; no bank, no torch)")
    rp.add_argument("--against-designs", action="append", default=None,
                    metavar="[NAME=]PATH",
                    help="also preflight the live designs' program "
                         "identities against the manifest and name the "
                         "mismatch class (code/flags/ladder/avals); "
                         "repeatable")
    rp.add_argument("--device", default=None)
    rp.add_argument("--dtype", default=None,
                    choices=("float32", "float64"))
    rp = rsub.add_parser("promote", help="point current at a release "
                                         "(atomic rename)")
    rp.add_argument("release")
    rsub.add_parser("rollback", help="re-point current at its parent")

    args = ap.parse_args(argv)
    cmd = {"warmup": _cmd_warmup, "list": _cmd_list,
           "verify": _cmd_verify, "gc": _cmd_gc,
           "release": _cmd_release}[args.cmd]
    return cmd(args)


if __name__ == "__main__":
    sys.exit(main())

"""CLI of the evaluation service (the port's counterpart of
``python -m raft_tpu.serve``, its single-server mode).

    python -m raft_tpu_torch.serve \
        --designs spar=tests/fixtures/torch_port/design_spar.json \
        [--designs semi=...] [--host 127.0.0.1] [--port 8787] \
        [--out-keys PSD,X0,status] [--no-warm] [--device cpu] \
        [--dtype float64]

Startup order is the serving contract: build + pack every registered
design, resolve the program bank through the release pointer (printed
as ``release: <id>`` when there is one), WARM every (bucket x
batch-ladder rung) on the device (:func:`raft_tpu_torch.serve.engine.
warm`: through the program bank under ``RAFT_TPU_AOT=load|require``,
the kernel library built or loaded and every rung dispatched twice),
refine the ladder by the measured walls, and only then bind the
socket.  Under ``RAFT_TPU_AOT=require`` a cold or skewed bank ends the
start-up with exit code 3 and the release preflight's diagnosis on
stderr (which programs are cold, which key component drifted, the
re-warm command).

``--device`` names the device every dispatch runs on (default: the
current CUDA device; without one the command exits 2 naming
``--device cpu``).  ``--dtype`` sets the compute-dtype policy
(``RAFT_TPU_DTYPE``; the reference's ``--x64``).  ``--port 0`` binds an
ephemeral port; the ready line on stdout (``serving N design(s) on
http://host:port ...``) reports the actual one.  SIGTERM/SIGINT drains
gracefully: in-flight requests finish, new work gets 503, metrics flush
to ``RAFT_TPU_METRICS``.

The reference's fleet options (``--fleet-dir``, ``--replica-id``,
``--takeover``) and its ``fleet``, ``router`` and ``rollout`` modes exit
2: the serving fleet is ROADMAP A15(h).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

#: the ROADMAP item that holds the serving fleet
FLEET_ITEM = "A15(h)"


def _parse_designs(specs):
    """``name=path`` (or bare path — name = file stem) from repeated /
    comma-separated ``--designs`` values."""
    out = {}
    for spec in specs:
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" in item:
                name, path = item.split("=", 1)
            else:
                name = os.path.splitext(os.path.basename(item))[0]
                path = item
            out[name.strip()] = path.strip()
    return out


def _fleet_refusal(what):
    print(f"{what}: the serving fleet (replicas, router, rollout) is not "
          f"ported yet; it is ROADMAP {FLEET_ITEM}", file=sys.stderr)
    return 2


def _serve_main(argv):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.serve")
    ap.add_argument("--designs", action="append", required=True,
                    help="name=design.json (repeatable / comma list)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="0 binds an ephemeral port (see the ready line)")
    ap.add_argument("--out-keys", default=",".join(
        ("PSD", "X0", "status")),
        help="out_keys this server dispatches (requests may ask for "
             "subsets; 'status' is always included)")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the pre-bind warm-up (first requests pay "
                         "the kernel build; testing only)")
    ap.add_argument("--device", default=None,
                    help="device every dispatch runs on (default: the "
                         "current CUDA device; 'cpu' for the CPU)")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "float64"),
                    help="compute-dtype policy (RAFT_TPU_DTYPE; default: "
                         "float64, derived from the float64 packed rows)")
    for opt in ("--fleet-dir", "--replica-id"):
        ap.add_argument(opt, default=None,
                        help=f"the serving fleet: ROADMAP {FLEET_ITEM} "
                             "(exits 2)")
    ap.add_argument("--takeover", action="store_true",
                    help=f"the serving fleet: ROADMAP {FLEET_ITEM} "
                         "(exits 2)")
    args = ap.parse_args(argv)
    for opt in ("fleet_dir", "replica_id", "takeover"):
        if getattr(args, opt):
            return _fleet_refusal("--" + opt.replace("_", "-"))

    from raft_tpu_torch.utils import config

    if args.dtype:
        os.environ[config.env_name("DTYPE")] = args.dtype

    from raft_tpu_torch.aot import bank as bank_mod
    from raft_tpu_torch.aot import release as release_mod
    from raft_tpu_torch.obs import alerts as alerts_mod
    from raft_tpu_torch.serve import engine
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.http import run_server
    from raft_tpu_torch.structure.bucketing import signature_fingerprint
    from raft_tpu_torch.utils.dtypes import resolve_device
    from raft_tpu_torch.utils.structlog import log_event

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{e} (--device cpu)", file=sys.stderr)
        return 2
    registry = engine.Registry()
    designs = _parse_designs(args.designs)
    if not designs:
        print("no designs registered (--designs name=path)", file=sys.stderr)
        return 2
    for name, path in designs.items():
        entry = registry.register(name, path)
        print(f"registered {name}: bucket "
              f"{signature_fingerprint(entry.sig)}", flush=True)

    # resolve the bank through the release pointer FIRST: the resolved
    # id is stamped into every provenance header, and a warm-up miss is
    # diagnosed against this release's manifest (releases are opt-in —
    # a pointer-less bank serves exactly as before)
    cur_release, cur_manifest = (release_mod.resolve()
                                 if bank_mod.mode() != "off"
                                 else (None, None))
    if cur_release:
        log_event("release_resolve", release=cur_release,
                  root=release_mod.releases_dir())
        print(f"release: {cur_release}", flush=True)

    out_keys = tuple(k.strip() for k in args.out_keys.split(",") if k.strip())
    batcher = Batcher(registry, out_keys=out_keys, device=device)
    entries = [registry.get(n) for n in registry.names()]
    if not args.no_warm:
        try:
            reports = engine.warm(entries, device=device,
                                  out_keys=batcher.out_keys,
                                  sizes=batcher.sizes)
        except bank_mod.BankMissError:
            # RAFT_TPU_AOT=require on a cold or stale bank: die with the
            # preflight diagnosis (which programs, which key component
            # drifted, the re-warm command) instead of one opaque key
            report = release_mod.diagnose(
                entries, device=device, out_keys=batcher.out_keys,
                sizes=batcher.sizes, manifest=cur_manifest)
            for line in release_mod.format_diagnosis(
                    report, sorted(designs.values()), dtype=args.dtype,
                    device=args.device):
                print(line, file=sys.stderr)
            return 3
        print(f"warmup: {len(reports)} (bucket x rung) program(s) "
              f"({sum(r['loaded'] for r in reports)} bank-loaded, "
              f"{sum(r['compiled'] for r in reports)} compiled) in "
              f"{sum(r['wall_s'] for r in reports):.1f}s, "
              f"{sum(r['launches'] for r in reports)} kernel launch(es)",
              flush=True)
        # cost-driven ladder refinement (RAFT_TPU_SERVE_LADDER=cost):
        # the warm-up dispatches just measured every candidate rung's
        # wall — prune the flat rungs (every kept rung was warmed)
        refined = engine.refine_ladder(entries, batcher.sizes,
                                       out_keys=batcher.out_keys,
                                       device=device)
        if tuple(refined) != tuple(batcher.sizes):
            print(f"batch ladder refined {list(batcher.sizes)} -> "
                  f"{list(refined)} (cost-flat rungs pruned)", flush=True)
            batcher.set_sizes(refined)

    # provenance stamps (x-raft-provenance on every /evaluate
    # response), computed once here, a dict lookup per request
    provenance = engine.build_provenance(
        registry, out_keys=batcher.out_keys, sizes=batcher.sizes,
        replica_id=batcher.replica_id, device=device)
    # in-process alert evaluator (RAFT_TPU_ALERT_EVAL_S > 0; served at
    # GET /alerts) — no flag, no thread
    alerts_mod.maybe_start()

    def ready(server):
        print(f"serving {len(registry)} design(s) on "
              f"http://{server.host}:{server.port} "
              f"(device {device}, tick {batcher.tick_s * 1e3:.0f}ms, "
              f"batch ladder {list(batcher.sizes)})", flush=True)

    asyncio.run(run_server(batcher, host=args.host, port=args.port,
                           ready=ready, provenance=provenance))
    alerts_mod.stop()
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("fleet", "router", "rollout"):
        return _fleet_refusal(f"python -m raft_tpu_torch.serve {argv[0]}")
    return _serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())

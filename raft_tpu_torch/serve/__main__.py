"""CLI of the evaluation service and the serving fleet (the port's
counterpart of ``python -m raft_tpu.serve``).

Single server (a fleet **replica** when ``--fleet-dir`` is set)::

    python -m raft_tpu_torch.serve \
        --designs spar=tests/fixtures/torch_port/design_spar.json \
        [--designs semi=...] [--host 127.0.0.1] [--port 8787] \
        [--out-keys PSD,X0,status] [--no-warm] [--device cpu] \
        [--dtype float64] [--fleet-dir DEPLOY_DIR] [--replica-id r0] \
        [--takeover]

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

With ``--fleet-dir`` the server additionally JOINS the serving fleet:
after the socket binds it claims a membership lease in the ``_fleet/``
ledger (port + bucket signatures + health snapshot in the lease body),
renews it from a daemon thread, and releases it at drain START — see
:mod:`raft_tpu_torch.serve.fleet`.  ``--takeover`` seizes the replica
id's existing lease instead (the rolling-upgrade replacement path).

Fleet coordinator (N replicas started from the SAME bank)::

    python -m raft_tpu_torch.serve fleet --replicas 2 \
        --fleet-dir DEPLOY_DIR --designs spar=... [--warm-bank] \
        [--no-warm] [--device cpu] [--status]

Failover router (the one endpoint clients talk to; no device work)::

    python -m raft_tpu_torch.serve router --fleet-dir DEPLOY_DIR \
        --port 8788

Canary-gated rolling upgrade to a cut release (automatic rollback on a
red canary or firing alert — see :mod:`raft_tpu_torch.serve.rollout`)::

    python -m raft_tpu_torch.serve rollout --fleet-dir DEPLOY_DIR \
        --to RELEASE_ID --designs spar=... \
        [--router-url http://127.0.0.1:8788] [--device cpu]

``--device`` names the device every dispatch runs on (default: the
current CUDA device; without one the command exits 2 naming
``--device cpu``); the ``fleet`` and ``rollout`` modes forward it to the
replicas they spawn, the ``router`` mode to the autoscaler's.
``--dtype`` sets the compute-dtype policy (``RAFT_TPU_DTYPE``; the
reference's ``--x64``).  ``--port 0`` binds an ephemeral port; the
ready line on stdout (``serving N design(s) on http://host:port ...``
/ ``routing N replica(s) ...``) reports the actual one.
SIGTERM/SIGINT drains gracefully: in-flight requests finish, new work
gets 503, metrics flush to ``RAFT_TPU_METRICS``.

Tuning flags: ``RAFT_TPU_SERVE_*`` for replicas, ``RAFT_TPU_ROUTER_*``
for the failover ladder, ``RAFT_TPU_FLEET_*`` for membership leases,
``RAFT_TPU_CANARY_*``, ``RAFT_TPU_ROLLOUT_*`` and
``RAFT_TPU_AUTOSCALE_*``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import uuid


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


def _default_fleet_dir(value):
    from raft_tpu_torch.utils import config

    return value if value is not None else (config.get("FLEET_DIR") or None)


def _fleet_dir_refusal():
    print("--fleet-dir (or RAFT_TPU_FLEET_DIR) is required",
          file=sys.stderr)
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
    ap.add_argument("--fleet-dir", default=None,
                    help="join the serving fleet whose _fleet/ ledger "
                         "lives under this directory (default: "
                         "RAFT_TPU_FLEET_DIR when set)")
    ap.add_argument("--replica-id", default=None,
                    help="fleet replica id (default: a fresh unique id)")
    ap.add_argument("--takeover", action="store_true",
                    help="SEIZE the replica id's existing fleet lease "
                         "after warm-up+bind instead of claiming fresh "
                         "(the rolling-upgrade replacement path: same "
                         "rid keeps the same ring vnodes; the previous "
                         "owner is then drained by the rollout driver)")
    args = ap.parse_args(argv)
    fleet_root = _default_fleet_dir(args.fleet_dir)
    if (args.replica_id or args.takeover) and not fleet_root:
        print("--replica-id / --takeover name a fleet replica: give "
              "--fleet-dir (or RAFT_TPU_FLEET_DIR)", file=sys.stderr)
        return 2

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

    # the replica id is fixed BEFORE anything starts: the provenance
    # stamp, the fleet lease, and the latency exemplars on /metrics
    # must all name the same replica
    rid = args.replica_id or f"replica-{uuid.uuid4().hex[:8]}"

    out_keys = tuple(k.strip() for k in args.out_keys.split(",") if k.strip())
    batcher = Batcher(registry, out_keys=out_keys, device=device,
                      replica_id=rid)
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
        replica_id=rid, device=device)
    if float(config.get("CANARY_S") or 0) > 0:
        # golden capture at warm-up: one dispatch per design at the
        # canary case (programs are already warm) — the replica's own
        # golden rows, reported at GET /alerts
        from raft_tpu_torch.serve import canary as canary_mod

        state = canary_mod.capture_goldens(entries, device=device,
                                           out_keys=batcher.out_keys)
        print(f"canary: captured {state.summary()['goldens']} golden "
              "row(s)", flush=True)
    # in-process alert evaluator (RAFT_TPU_ALERT_EVAL_S > 0; served at
    # GET /alerts) — no flag, no thread
    alerts_mod.maybe_start()

    fleet_state = {}

    def ready(server):
        print(f"serving {len(registry)} design(s) on "
              f"http://{server.host}:{server.port} "
              f"(device {device}, tick {batcher.tick_s * 1e3:.0f}ms, "
              f"batch ladder {list(batcher.sizes)})", flush=True)
        if fleet_root:
            _join_fleet(fleet_root, rid, server, registry, batcher,
                        args.takeover, fleet_state)

    def on_drain_start():
        # release the membership lease at drain START (executor
        # thread): the router stops routing here while accepted work
        # finishes — the whole point of drain = release
        renewer = fleet_state.get("renewer")
        if renewer is not None:
            renewer.stop()
        ledger = fleet_state.get("ledger")
        if ledger is not None:
            ledger.release(reason="drain")

    asyncio.run(run_server(batcher, host=args.host, port=args.port,
                           ready=ready, on_drain_start=on_drain_start,
                           provenance=provenance))
    alerts_mod.stop()
    return 0


def _join_fleet(fleet_root, rid, server, registry, batcher, takeover,
                fleet_state):
    """Join the fleet only AFTER warm-up + bind (the router must never
    route to a replica that would build on the request): claim the
    replica id's lease — or seize it under ``--takeover`` — and start
    its renewer.  A live lease under the same id is refused (another
    replica serves under it); an expired one is evicted first."""
    from raft_tpu_torch.aot import bank as bank_mod
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.serve import engine
    from raft_tpu_torch.serve import fleet as fleet_mod
    from raft_tpu_torch.structure.bucketing import signature_fingerprint
    from raft_tpu_torch.utils import config

    ledger = fleet_mod.FleetLedger(fleet_root, replica_id=rid)
    meta = {}
    for name in registry.names():
        e = registry.get(name)
        meta[name] = {"sig": signature_fingerprint(e.sig),
                      "fingerprint": e.fingerprint}

    def healthz():
        s = batcher.stats()
        # busy_s: the summed solve wall of every dispatch — the
        # autoscaler derives fleet occupancy from lease-to-lease
        # deltas of this; builds / nvcc runs: what the replica built
        return {"draining": bool(s["draining"]),
                "pending": int(s["pending"]),
                "cache": s["cache"],
                "busy_s": round(engine.busy_s(), 4),
                "builds": int(bank_mod.builds()),
                "nvcc_runs": int(linsolve.NVCC_RUNS)}

    buckets = sorted({m["sig"] for m in meta.values()})
    served_keys = list(batcher.out_keys)
    lease = dict(host=server.host, designs=meta, buckets=buckets,
                 out_keys=served_keys)
    if takeover:
        # rolling-upgrade replacement: unconditionally take the lease
        # over (same rid = same ring vnodes — zero key movement); the
        # rollout driver drains the previous owner only after this
        # succeeds, so membership never gaps
        ledger.seize(server.port, healthz=healthz(), **lease)
    elif not ledger.claim(server.port, healthz=healthz(), **lease):
        # a lease already exists under this forced id.  Only a crashed
        # predecessor's EXPIRED lease may be evicted — a live one means
        # another replica is serving under this id right now, and
        # hijacking it would silently knock that replica out of the
        # ring (its renewer fails token checks and never re-claims)
        rec, mtime = ledger.read(rid)
        ttl = float((rec or {}).get("ttl_s") or config.get("FLEET_TTL_S"))
        age = (fleet_mod.FleetLedger.lease_age(rec, mtime)
               if rec is not None else float("inf"))
        if rec is not None and age <= ttl:
            print(f"fleet: NOT joining {fleet_root} — the lease for "
                  f"{rid!r} is LIVE (age {age:.1f}s <= ttl {ttl:.1f}s); "
                  "another replica is serving under this id.  Pick a "
                  "different --replica-id (serving standalone).",
                  file=sys.stderr)
            return
        ledger.evict(rid, reason="stale_self", age_s=age)
        if not ledger.claim(server.port, healthz=healthz(), **lease):
            # lost the re-claim race to a same-id twin: joining anyway
            # would start a renewer that no-ops forever
            print(f"fleet: NOT joining {fleet_root} — lost the claim "
                  f"race for {rid!r} (serving standalone)",
                  file=sys.stderr)
            return
    renewer = fleet_mod.LeaseRenewer(ledger, healthz=healthz)
    renewer.start()
    fleet_state.update(ledger=ledger, renewer=renewer)
    print(f"fleet: joined {fleet_root} as {rid}", flush=True)


def _fleet_main(argv):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.serve fleet")
    ap.add_argument("--fleet-dir", default=None,
                    help="fleet deploy directory (the _fleet/ ledger "
                         "root; default: RAFT_TPU_FLEET_DIR)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--designs", action="append", default=[],
                    help="name=design.json, forwarded to every replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--out-keys", default=None,
                    help="forwarded to every replica")
    ap.add_argument("--no-warm", action="store_true",
                    help="replicas skip their pre-bind warm-up")
    ap.add_argument("--warm-bank", action="store_true",
                    help="warm the shared program bank ONCE in this "
                         "process before spawning; replicas then start "
                         "under RAFT_TPU_AOT=require, building nothing")
    ap.add_argument("--device", default=None,
                    help="forwarded to every replica (default: the "
                         "current CUDA device; 'cpu' for the CPU)")
    ap.add_argument("--status", action="store_true",
                    help="print the ledger summary as JSON and exit")
    args = ap.parse_args(argv)

    from raft_tpu_torch.serve import fleet as fleet_mod

    root = _default_fleet_dir(args.fleet_dir)
    if not root:
        return _fleet_dir_refusal()
    if args.status:
        print(json.dumps(fleet_mod.FleetLedger(root).summary(), indent=1,
                         default=str))
        return 0
    if not args.designs:
        print("no designs (--designs name=path)", file=sys.stderr)
        return 2
    if args.replicas < 1:
        print(f"--replicas {args.replicas}: a fleet needs at least one "
              "replica", file=sys.stderr)
        return 2
    extra = []
    if args.no_warm:
        extra.append("--no-warm")
    if args.out_keys:
        extra += ["--out-keys", args.out_keys]

    def on_ready(ports):
        print(f"fleet ready: {len(ports)} replica(s) at "
              + " ".join(f"{rid}=http://{args.host}:{p}"
                         for rid, p in ports.items()), flush=True)

    return fleet_mod.run_fleet(root, args.replicas, args.designs,
                               host=args.host, extra_args=extra,
                               warm_bank=args.warm_bank,
                               on_ready=on_ready, device=args.device)


def _router_main(argv):
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.serve router")
    ap.add_argument("--fleet-dir", default=None,
                    help="fleet deploy directory (default: "
                         "RAFT_TPU_FLEET_DIR)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8788,
                    help="0 binds an ephemeral port (see the ready line)")
    ap.add_argument("--designs", action="append", default=[],
                    help="name=design.json forwarded to replicas the "
                         "AUTOSCALER spawns (RAFT_TPU_AUTOSCALE_EVAL_S "
                         "> 0 enables the scaling daemon; without "
                         "designs it can only scale in)")
    ap.add_argument("--device", default=None,
                    help="forwarded to replicas the autoscaler spawns")
    args = ap.parse_args(argv)

    from raft_tpu_torch.obs import alerts as alerts_mod
    from raft_tpu_torch.serve.router import run_router
    from raft_tpu_torch.utils import config

    root = _default_fleet_dir(args.fleet_dir)
    if not root:
        return _fleet_dir_refusal()
    # the router runs the fleet-level alert evaluator: its registry
    # carries the ladder/breaker/membership/canary counters the default
    # rule pack watches (RAFT_TPU_ALERT_EVAL_S > 0; served at GET /alerts)
    alerts_mod.maybe_start()
    scaler = None
    if float(config.get("AUTOSCALE_EVAL_S") or 0) > 0:
        from raft_tpu_torch.serve import autoscale as autoscale_mod

        scaler = autoscale_mod.Autoscaler(root, args.designs,
                                          device=args.device)
        scaler.start()
        print(f"autoscale: [{scaler.minimum}, {scaler.maximum}] "
              f"replicas every {scaler.interval_s}s", flush=True)

    def ready(router):
        snap = router.state.snapshot()
        print(f"routing {snap['n_replicas']} replica(s) on "
              f"http://{router.host}:{router.port} "
              f"(fleet {root})", flush=True)

    asyncio.run(run_router(root, host=args.host, port=args.port,
                           ready=ready))
    if scaler is not None:
        scaler.stop()
    alerts_mod.stop()
    return 0


def _rollout_main(argv):
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.serve rollout")
    ap.add_argument("--fleet-dir", default=None,
                    help="fleet deploy directory (default: "
                         "RAFT_TPU_FLEET_DIR)")
    ap.add_argument("--to", required=True,
                    help="candidate release id (cut + verified; the "
                         "driver promotes it, then surf-replaces the "
                         "fleet replica by replica)")
    ap.add_argument("--designs", action="append", default=[],
                    help="name=design.json forwarded to the upgraded "
                         "replicas")
    ap.add_argument("--router-url", default=None,
                    help="router base URL whose GET /alerts gates each "
                         "step (canary verdicts + active alerts); "
                         "omitting it skips the canary gate — testing "
                         "only")
    ap.add_argument("--device", default=None,
                    help="forwarded to the upgraded replicas")
    args = ap.parse_args(argv)

    from raft_tpu_torch.serve import rollout as rollout_mod

    root = _default_fleet_dir(args.fleet_dir)
    if not root:
        return _fleet_dir_refusal()
    if not args.designs:
        print("no designs (--designs name=path)", file=sys.stderr)
        return 2
    try:
        record = rollout_mod.run_rollout(root, args.to, args.designs,
                                         router_url=args.router_url,
                                         device=args.device)
    except (FileNotFoundError, ValueError) as e:
        # refused before the promote: the fleet is untouched
        print(f"rollout: {e}", file=sys.stderr)
        return 2
    print(json.dumps(record, indent=1, default=str))
    print(rollout_mod.summarize_record(record), flush=True)
    return 0 if record.get("ok") else 1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "fleet":
        return _fleet_main(argv[1:])
    if argv and argv[0] == "router":
        return _router_main(argv[1:])
    if argv and argv[0] == "rollout":
        return _rollout_main(argv[1:])
    return _serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""Writer/reader schema contracts for cross-process record families
(counterpart of ``raft_tpu/analysis/schemas.py``, over the port's
writers and readers).

The coordinator, the fabric workers, the serve process and every CLI
agree on the shape of the JSON records they exchange — lease files,
done records, worker status files, ``fabric.json``, ``manifest.json``,
``quarantine.json``, run records, AOT bank sidecars — only by
convention.  Nothing enforces that a key a reader dereferences is ever
written, or that a key a reader *requires* (hard ``rec["k"]``
subscript) is written unconditionally; drift between a writer and a
reader in two different processes is silent data loss or a crash in a
process the author never ran.

This engine extracts, statically, the **written key set** and the
**read key set** of each record family from its declared write/read
sites (:data:`FAMILIES`) and fails on drift:

* ``read-never-written`` — a reader dereferences a key no writer ever
  emits (the classic typo: writer says ``renewed_t``, reader asks for
  ``renewd_t`` — both sides "work" until a steal decision reads a
  garbage default);
* ``required-but-conditional`` — a reader hard-subscripts
  (``rec["k"]``, KeyError on absence) a key that writers only emit
  conditionally (inside an ``if``, or only at some call sites of a
  kwargs-style writer);
* ``baseline-drift`` — the extracted contract differs from the
  checked-in ``analysis/schema_baseline.json``: intentional schema
  evolution must be an explicit, reviewed diff (regenerate with
  ``python -m raft_tpu_torch.analysis schemas --write``), never an accident.

Extraction handles the repo's actual idioms: dict literals (on the
record variable, returned, or passed inline to an atomic writer),
``rec["k"] = v`` / ``rec.setdefault`` / ``rec.update(...)`` mutations
(conditional when nested under ``if``/``for``/``while``/``except``;
``try``/``with`` bodies count as unconditional), kwargs-style writers
(key set = the union over call sites; a key missing from any call site
is conditional), and reads via ``rec["k"]`` (required), ``rec.get``
/ ``setdefault`` / ``in`` (optional) — including loops and
comprehensions over literal key tuples and over module-level constant
tuples (``for k in _STRICT_FINGERPRINT_KEYS: old.get(k)``).

The port keeps the reference's on-disk formats, so its families are
the reference's and its baseline carries the same keys but where the
port's records differ by design (``tests/test_torch_analysis_schemas.py``
names each difference).  Pure stdlib ``ast``: it imports neither torch
nor jax.  Run ``python -m raft_tpu_torch.analysis schemas``.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass

from raft_tpu_torch.analysis.lint import repo_root

BASELINE_NAME = "schema_baseline.json"


@dataclass(frozen=True)
class Site:
    """One write or read site of a record family.

    path : repo-relative module path
    func : function qualname ("Ledger.claim", "init_sweep")
    var : the name holding the record inside ``func`` — a local, a
        parameter, or a ``self.<attr>`` spelling.  ``None`` on writer
        sites means "every dict literal returned from, or passed
        inline to an atomic-writer call inside, this function".
    kind : writer sites only — ``create`` (authoritative full record:
        family alwaysness intersects over these), ``update``
        (read-modify-write that preserves unknown keys: only adds its
        keys), ``kwargs`` (the function collects ``**var``; the written
        keys are the union over its call sites in the family's files)
    """

    path: str
    func: str
    var: str | None = None
    kind: str = "create"


@dataclass(frozen=True)
class Family:
    """One cross-process record family: its writers and readers."""

    name: str
    help: str
    writers: tuple = ()
    readers: tuple = ()
    #: extra files scanned for call sites of kwargs-style writers
    callers: tuple = ()


# ------------------------------------------------------------ the contract

_FAB = "raft_tpu_torch/parallel/fabric.py"
_RES = "raft_tpu_torch/parallel/resilience.py"
_RUNS = "raft_tpu_torch/obs/runs.py"
_OBS_CLI = "raft_tpu_torch/obs/__main__.py"
_BANK = "raft_tpu_torch/aot/bank.py"
_FLEET = "raft_tpu_torch/serve/fleet.py"
_ROUTER = "raft_tpu_torch/serve/router.py"
_ALERTS = "raft_tpu_torch/obs/alerts.py"
_CANARY = "raft_tpu_torch/serve/canary.py"
_RELEASE = "raft_tpu_torch/aot/release.py"
_ROLLOUT = "raft_tpu_torch/serve/rollout.py"
_FLIGHT = "raft_tpu_torch/obs/flight.py"

FAMILIES: tuple[Family, ...] = (
    Family(
        "lease", "shard lease file (fabric ledger claim/renew/steal)",
        writers=(Site(_FAB, "Ledger.claim", "rec"),
                 Site(_FAB, "Ledger.renew", "rec", kind="update")),
        readers=(Site(_FAB, "Ledger.renew", "rec"),
                 Site(_FAB, "Ledger.release", "rec"),
                 Site(_FAB, "Ledger.stealable", "rec"),
                 Site(_FAB, "Ledger.summary", "rec"),
                 Site(_FAB, "Worker._try_adopt", "rec"),
                 Site(_FAB, "Worker._lease_attempt", "rec"))),
    Family(
        "done-record", "shard completion record (fabric ledger)",
        writers=(Site(_FAB, "Ledger.write_done", "rec", kind="kwargs"),),
        callers=(_FAB,),
        readers=(Site(_FAB, "assemble", "rec"),
                 # the coordinator's progress poll (run_fabric's in the
                 # reference)
                 Site(_FAB, "_wait_drained.report_progress", "rec"))),
    Family(
        "worker-status", "fabric worker status file (liveness + pooling)",
        writers=(Site(_FAB, "Ledger.write_worker_status", "rec",
                      kind="kwargs"),),
        callers=(_FAB,),
        readers=(Site(_FAB, "Ledger.pooled_walls", "st"),
                 Site(_FAB, "Ledger.summary", "st"),
                 Site(_FAB, "assemble", "st"))),
    Family(
        "fabric-spec", "fabric.json sweep spec (coordinator -> workers)",
        writers=(Site(_FAB, "init_sweep", "spec"),),
        readers=(Site(_FAB, "Worker.run", "spec"),
                 Site(_FAB, "Worker._setup_runtime", "spec"),
                 Site(_FAB, "Worker._eval_shard", "self.spec"),
                 Site(_FAB, "assemble", "spec"),
                 Site(_FAB, "main", "spec"))),
    Family(
        "manifest", "manifest.json top level (resume validation)",
        writers=(Site(_RES, "init_manifest", "manifest"),
                 Site(_FAB, "assemble", "manifest", kind="update"),),
        readers=(Site(_RES, "init_manifest", "manifest"),
                 Site(_FAB, "assemble", "manifest"))),
    Family(
        "fingerprint", "manifest config fingerprint (strict + advisory)",
        writers=(Site(_RES, "compute_fingerprint", None),),
        readers=(Site(_RES, "init_manifest", "old"),
                 Site(_RES, "validate_manifest", "old"))),
    Family(
        "quarantine-entry", "quarantine.json schema-v2 row entries",
        writers=(Site(_RES, "_quarantine_shard", "entry"),),
        readers=(Site(_RES, "record_quarantine", "e"),
                 Site(_RES, "run_checkpointed", "e"),
                 Site(_FAB, "Worker._eval_shard", "e"))),
    Family(
        "run-record", "schema-v1 longitudinal run record (obs.runs)",
        writers=(Site(_RUNS, "build_record", "record"),
                 Site(_RUNS, "ingest_bench", None)),
        readers=(Site(_RUNS, "load_record", "record"),
                 Site(_RUNS, "flatten", "record"),
                 Site(_RUNS, "env_mismatch", "a"),
                 Site(_RUNS, "env_mismatch", "b"),
                 Site(_RUNS, "regress_records", "new"),
                 Site(_RUNS, "regress_records", "base"),
                 Site(_OBS_CLI, "_cmd_runs_list", "rec"))),
    Family(
        "fleet-lease",
        "serving-fleet replica membership lease (_fleet/replicas/; "
        "claim = join, renewed = alive, expired = dead, release = "
        "drain — raft_tpu_torch.serve.fleet)",
        # the port builds the lease record in one helper, which claim
        # and seize share
        writers=(Site(_FLEET, "FleetLedger._record", None),
                 Site(_FLEET, "FleetLedger.renew", "rec", kind="update")),
        readers=(Site(_FLEET, "FleetLedger.renew", "rec"),
                 Site(_FLEET, "FleetLedger.release", "rec"),
                 Site(_FLEET, "FleetLedger.lease_age", "rec"),
                 Site(_FLEET, "FleetLedger._ttl", "rec"),
                 Site(_FLEET, "FleetLedger.live", "rec"),
                 Site(_FLEET, "FleetLedger.expired", "rec"),
                 Site(_FLEET, "FleetLedger.summary", "rec"),
                 Site(_ROUTER, "RouterState.apply_membership", "rec"),
                 Site(_ROUTER, "LedgerProber.probe_once", "rec"))),
    Family(
        "router-membership",
        "the router's published membership view (_fleet/router.json: "
        "ring replicas + breaker states, advisory)",
        writers=(Site(_ROUTER, "RouterState.membership_record", "rec"),),
        readers=(Site(_FLEET, "FleetLedger.summary", "router"),)),
    Family(
        "alert-record",
        "alert fire/resolve transition record (the RAFT_TPU_ALERTS "
        "JSONL sink + the alert_fire/alert_resolve event payload — "
        "raft_tpu_torch.obs.alerts)",
        writers=(Site(_ALERTS, "AlertEngine._record", None),),
        readers=(Site(_ALERTS, "read_sink", "rec"),
                 Site(_ALERTS, "render_sink_summary", "rec"))),
    Family(
        "canary-golden",
        "content-addressed golden row of the serving canary (design "
        "content hash + exact case bits + out_keys -> outputs + int32 "
        "status — raft_tpu_torch.serve.canary)",
        writers=(Site(_CANARY, "CanaryState.capture", "rec"),),
        readers=(Site(_CANARY, "CanaryState.compare", "golden"),
                 Site(_CANARY, "CanaryState.observe", "golden"))),
    Family(
        "aot-sidecar", "AOT bank entry .json metadata sidecar",
        writers=(Site(_BANK, "entry_key", "meta"),
                 Site(_BANK, "store", "meta", kind="update")),
        readers=(Site(_BANK, "lookup", "meta"),
                 Site(_BANK, "is_stale", "meta"),
                 Site(_BANK, "verify_bank", "meta"),
                 Site(_BANK, "gc_bank", "meta"))),
    Family(
        "release-manifest",
        "signed, content-addressed release manifest (releases/<id>."
        "json: bank entry shas + code/flags/ladder identity + parent "
        "chain + captured env — raft_tpu_torch.aot.release)",
        writers=(Site(_RELEASE, "build_manifest", "man"),
                 Site(_RELEASE, "sign_manifest", "man", kind="update")),
        readers=(Site(_RELEASE, "verify_manifest", "man"),
                 Site(_RELEASE, "verify_against_bank", "man"),
                 Site(_RELEASE, "classify_mismatch", "man"),
                 Site(_RELEASE, "walk_parents", "man"),
                 Site(_RELEASE, "list_releases", "man"),
                 Site(_RELEASE, "parity_context", "man"))),
    Family(
        "rollout-record",
        "rolling-upgrade outcome record (the run record's extra block "
        "+ the rollout CLI/drill summary — raft_tpu_torch.serve.rollout)",
        writers=(Site(_ROLLOUT, "build_record", "record"),),
        readers=(Site(_ROLLOUT, "summarize_record", "record"),)),
    Family(
        "flight-dump",
        "flight-recorder dump shard header (flight-*.jsonl first line: "
        "a proc_start clock anchor carrying the schema-versioned "
        "flight metadata block — raft_tpu_torch.obs.flight; the shard body "
        "reuses the live structlog event layout)",
        writers=(Site(_FLIGHT, "_header_record", "rec"),),
        readers=(Site(_FLIGHT, "read_shard", "hdr"),
                 Site(_FLIGHT, "show", "hdr"))),
)


# ============================================================== extraction


def _load_tree(root, path, _cache={}):
    key = os.path.join(root, path)
    if key not in _cache:
        with open(key, encoding="utf-8") as f:
            src = f.read()
        _cache[key] = (ast.parse(src, filename=key), src)
    return _cache[key]


def _find_func(tree, qualname):
    """The (Async)FunctionDef for a dotted qualname; supports one
    nesting level per dot (class method, nested closure)."""
    node = tree
    for part in qualname.split("."):
        nxt = None
        for child in ast.walk(node):
            if child is node:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) and child.name == part:
                nxt = child
                break
        if nxt is None:
            raise LookupError(f"no function {qualname!r}")
        node = nxt
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise LookupError(f"{qualname!r} is not a function")
    return node


def _module_const_tuples(tree):
    """Module-level NAME = ("a", "b", ...) string-tuple constants, for
    resolving ``for k in _STRICT_FINGERPRINT_KEYS:`` style reads."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            keys = _str_tuple(node.value)
            if keys is not None:
                out[node.targets[0].id] = keys
    return out


def _str_tuple(node):
    """The tuple of string constants a node denotes, or None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                vals.append(e.value)
            else:
                return None
        return tuple(vals)
    return None


def _matches_var(node, var):
    """Does ``node`` denote the record variable ``var`` (a bare name,
    ``self.attr``, or a defaulted spelling like ``(rec or {})``)?"""
    if isinstance(node, ast.BoolOp):  # (rec or {})
        return any(_matches_var(v, var) for v in node.values)
    if "." in var:
        base, attr = var.split(".", 1)
        return (isinstance(node, ast.Attribute) and node.attr == attr
                and isinstance(node.value, ast.Name)
                and node.value.id == base)
    return isinstance(node, ast.Name) and node.id == var


class _SiteWalker:
    """Shared conditional-context walker: visits every node of one
    function with an ``conditional`` flag that is True under ``if``/
    ``for``/``while``/``except``/ternary (``try`` and ``with`` bodies
    count as unconditional — they run unless the process dies, which
    for schema purposes is 'always')."""

    def __init__(self, func_node, consts):
        self.func = func_node
        self.consts = consts  # module constant str-tuples
        #: loop-variable name -> tuple of keys it ranges over
        self.loop_keys = {}

    def _iter_keys(self, it):
        keys = _str_tuple(it)
        if keys is None and isinstance(it, ast.Name):
            keys = self.consts.get(it.id)
        return keys

    def walk(self):
        yield from self._walk(self.func, False)

    def _register(self, node):
        """Bind literal-key loop variables BEFORE their bodies are
        visited: ``for k in ("a", "b"):`` and ``{k: rec.get(k) for k
        in (...)}`` are unrolled key sequences, not dynamic access."""
        if isinstance(node, ast.For):
            keys = self._iter_keys(node.iter)
            if keys is not None and isinstance(node.target, ast.Name):
                self.loop_keys[node.target.id] = keys
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                keys = self._iter_keys(gen.iter)
                if keys is not None and isinstance(gen.target, ast.Name):
                    self.loop_keys[gen.target.id] = keys

    def _branch_cond(self, node, fieldname, cond):
        """The conditionality of one child field: an ``if``'s TEST is
        evaluated unconditionally, its body/orelse are not; a loop over
        literal keys runs for every key (unconditional), any other loop
        body may run zero times."""
        if isinstance(node, (ast.If, ast.IfExp, ast.While)) \
                and fieldname in ("body", "orelse"):
            return True
        if isinstance(node, ast.For) and fieldname in ("body", "orelse"):
            literal = (self._iter_keys(node.iter) is not None
                       and isinstance(node.target, ast.Name))
            return cond if literal else True
        if isinstance(node, ast.Try) \
                and fieldname in ("handlers", "orelse"):
            return True
        return cond

    def _walk(self, node, cond):
        self._register(node)
        for fieldname, value in ast.iter_fields(node):
            bc = self._branch_cond(node, fieldname, cond)
            for child in (value if isinstance(value, list) else [value]):
                if not isinstance(child, ast.AST) or isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested defs are their own sites
                yield child, bc
                yield from self._walk(child, bc)

    def key_of(self, node):
        """Keys a subscript/get argument denotes: a literal string, or
        a loop variable bound to a literal tuple."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return (node.value,)
        if isinstance(node, ast.Name) and node.id in self.loop_keys:
            return self.loop_keys[node.id]
        return None


def _extract_writes(root, site, call_keys=None):
    """{key: "always" | "conditional"} written by one writer site."""
    tree, _ = _load_tree(root, site.path)
    func = _find_func(tree, site.func)
    consts = _module_const_tuples(tree)
    w = _SiteWalker(func, consts)
    out = {}

    def note(key, cond):
        if key is None:
            return
        for k in (key if isinstance(key, tuple) else (key,)):
            if out.get(k) != "always":
                out[k] = "conditional" if cond else "always"

    def note_dict(node, cond):
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                note(k.value, cond)

    for node, cond in w.walk():
        if site.var is None:
            # returned dict literals + dict literals passed to an
            # atomic-writer call
            if isinstance(node, ast.Return) and isinstance(node.value,
                                                           ast.Dict):
                note_dict(node.value, cond)
            if isinstance(node, ast.Call):
                fname = (node.func.attr if isinstance(node.func,
                                                      ast.Attribute)
                         else getattr(node.func, "id", None))
                if fname in ("_atomic_json", "dump"):
                    for a in node.args:
                        if isinstance(a, ast.Dict):
                            note_dict(a, cond)
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if _matches_var(t, site.var) and isinstance(node.value,
                                                            ast.Dict):
                    note_dict(node.value, cond)
                elif isinstance(t, ast.Subscript) \
                        and _matches_var(t.value, site.var):
                    note(w.key_of(t.slice), cond)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for e in t.elts:
                        if isinstance(e, ast.Subscript) \
                                and _matches_var(e.value, site.var):
                            note(w.key_of(e.slice), cond)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and _matches_var(node.func.value, site.var):
            if node.func.attr == "setdefault" and node.args:
                note(w.key_of(node.args[0]), cond)
            elif node.func.attr == "update":
                for kw in node.keywords:
                    if kw.arg is not None:
                        note(kw.arg, cond)
                for a in node.args:
                    if isinstance(a, ast.Dict):
                        note_dict(a, cond)
    if site.kind == "kwargs" and call_keys is not None:
        # call-site keywords: present at EVERY call site -> always
        # (within this writer), else conditional
        sites_seen = call_keys
        if sites_seen:
            every = set.intersection(*[set(s) for s in sites_seen])
            union = set.union(*[set(s) for s in sites_seen])
            for k in union:
                status = "always" if k in every else "conditional"
                if out.get(k) != "always":
                    out[k] = status
    return out


def _kwarg_call_sites(root, family, writer):
    """Keyword-name sets of every call to a kwargs-style writer within
    the family's caller files (positional-only calls contribute an
    empty set — they write no keys)."""
    fname = writer.func.split(".")[-1]
    sites = []
    for path in (family.callers or (writer.path,)):
        tree, _ = _load_tree(root, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            called = (f.attr if isinstance(f, ast.Attribute)
                      else getattr(f, "id", None))
            if called != fname:
                continue
            sites.append({kw.arg for kw in node.keywords
                          if kw.arg is not None})
    return sites


def _extract_reads(root, site):
    """{key: "required" | "optional"} read by one reader site.

    A hard subscript is ``required`` — unless every such subscript of
    the key sits in a conditional branch AND the same function also
    ``.get``-reads it: that is the presence-guard idiom (``if
    rec.get(k) is not None: use rec[k]``), which tolerates absence."""
    tree, _ = _load_tree(root, site.path)
    func = _find_func(tree, site.func)
    consts = _module_const_tuples(tree)
    w = _SiteWalker(func, consts)
    required = {}   # key -> True when any subscript is unconditional
    optional = set()
    writes = set()  # keys this function itself assigns on the var:
    #                 a read-back of one's own write is not a contract

    for node, cond in w.walk():
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and _matches_var(t.value, site.var):
                    for k in (w.key_of(t.slice) or ()):
                        writes.add(k)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _matches_var(node.value, site.var):
            for k in (w.key_of(node.slice) or ()):
                required[k] = required.get(k, False) or not cond
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "setdefault") \
                and _matches_var(node.func.value, site.var) and node.args:
            optional.update(w.key_of(node.args[0]) or ())
        elif isinstance(node, ast.Compare) \
                and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and _matches_var(node.comparators[0], site.var):
            optional.update(w.key_of(node.left) or ())
    out = {}
    for k, unconditional in required.items():
        guarded = not unconditional and k in optional
        out[k] = "optional" if guarded else "required"
    for k in optional:
        out.setdefault(k, "optional")
    for k in writes:
        out.pop(k, None)
    return out


def extract_family(family, root=None):
    """``{"written": {key: always|conditional}, "read": {key:
    required|optional}}`` for one family, merged across its sites.

    Merge rules: a key is ``always`` only when every *create* writer
    always writes it (``update``/``kwargs`` writers add keys without
    demoting other writers' alwaysness — they rewrite or extend an
    existing record); reads keep the strictest classification
    (``required`` wins)."""
    root = root or repo_root()
    create_sets, update_keys = [], set()
    for writer in family.writers:
        call_keys = (_kwarg_call_sites(root, family, writer)
                     if writer.kind == "kwargs" else None)
        keys = _extract_writes(root, writer, call_keys=call_keys)
        if writer.kind in ("create", "kwargs"):
            # a kwargs writer is create-ish: every record of the family
            # passes through it (call-site intersection already decided
            # per-key alwaysness inside _extract_writes)
            create_sets.append(keys)
        else:
            # update writers rewrite an EXISTING record: they can add
            # keys, but a record that never met them lacks those keys,
            # so update-only keys are at best conditional
            update_keys.update(keys)
    written = {}
    if create_sets:
        union = set().union(*[set(s) for s in create_sets])
        for k in sorted(union):
            statuses = [s.get(k) for s in create_sets]
            written[k] = ("always" if all(st == "always" for st in statuses)
                          else "conditional")
    for k in update_keys:
        written.setdefault(k, "conditional")
    read = {}
    for reader in family.readers:
        for k, v in _extract_reads(root, reader).items():
            if v == "required" or k not in read:
                read[k] = v
    return {"written": dict(sorted(written.items())),
            "read": dict(sorted(read.items()))}


def extract_all(families=FAMILIES, root=None):
    return {f.name: extract_family(f, root=root) for f in families}


# ================================================================ checking


def drift_violations(name, contract):
    """Writer/reader drift within one freshly-extracted contract."""
    out = []
    written, read = contract["written"], contract["read"]
    for key, how in sorted(read.items()):
        if key not in written:
            out.append(
                f"[{name}] read-never-written: readers dereference "
                f"{key!r} but no writer site ever emits it")
        elif how == "required" and written[key] == "conditional":
            out.append(
                f"[{name}] required-but-conditional: a reader hard-"
                f"subscripts {key!r} (KeyError on absence) but writers "
                "only emit it conditionally")
    return out


def baseline_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        BASELINE_NAME)


def load_baseline(path=None):
    with open(path or baseline_path(), encoding="utf-8") as f:
        return json.load(f)


def write_baseline(contracts, path=None):
    path = path or baseline_path()
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "families": contracts}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    return path


def baseline_violations(contracts, baseline):
    """Differences between the extracted contracts and the checked-in
    baseline — intentional evolution must be an explicit regen."""
    out = []
    base = baseline.get("families", {})
    for name in sorted(set(contracts) | set(base)):
        got, want = contracts.get(name), base.get(name)
        if want is None:
            out.append(f"[{name}] not in the baseline (new family?) — "
                       "regen with `schemas --write`")
            continue
        if got is None:
            out.append(f"[{name}] in the baseline but no longer "
                       "extracted — regen with `schemas --write`")
            continue
        for side, label in (("written", "writer"), ("read", "reader")):
            g, b = got.get(side, {}), want.get(side, {})
            for k in sorted(set(g) | set(b)):
                if g.get(k) != b.get(k):
                    out.append(
                        f"[{name}] {label} key {k!r}: extracted "
                        f"{g.get(k)!r}, baseline {b.get(k)!r} — schema "
                        "evolution must be an explicit `schemas --write` "
                        "diff")
    return out


def run_checks(families=FAMILIES, root=None, baseline=None,
               check_baseline=True):
    """Full engine pass: ``(violations, contracts)``."""
    contracts = extract_all(families, root=root)
    violations = []
    for name, contract in contracts.items():
        violations.extend(drift_violations(name, contract))
    if check_baseline:
        try:
            base = baseline if baseline is not None else load_baseline()
        except (OSError, ValueError) as e:
            violations.append(f"[baseline] unreadable {baseline_path()}: "
                              f"{e} — regen with `schemas --write`")
        else:
            violations.extend(baseline_violations(contracts, base))
    return violations, contracts


# ================================================================= fixture

#: the seeded drift drill: a deliberately drifted lease writer/reader
#: pair (tests/fixtures/lint/bad_schema_writer.py) that the engine must
#: catch — the CI negative `lint.sh` asserts exits EXACTLY 1
FIXTURE_PATH = os.path.join("tests", "fixtures", "torch_lint",
                            "bad_schema_writer.py")

FIXTURE_FAMILY = Family(
    "drifted-lease", "seeded drift drill (bad_schema_writer.py fixture)",
    writers=(Site(FIXTURE_PATH, "write_lease", "rec"),),
    readers=(Site(FIXTURE_PATH, "read_lease", "rec"),))


def run_fixture_checks(root=None):
    """Violations of the seeded drift fixture (baseline not consulted:
    the fixture is a negative, not part of the repo contract)."""
    return run_checks((FIXTURE_FAMILY,), root=root, check_baseline=False)

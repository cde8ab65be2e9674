"""Static protocol extraction over the fleet's filesystem state machines
(counterpart of ``raft_tpu/analysis/protocol.py``, over the port's
protocol modules).

The shared-filesystem coordination protocol (leases, release pointers,
rollout markers, canary gates) lives in six modules.  Every mutation of
the shared tree is a **protocol action**: it either goes through one of
the sanctioned atomic channels (``utils.fsops``, the lease primitives,
``resilience._atomic_*``) inside a function the model checker knows
about, or it is *unmodeled* — a write the interleaving explorer in
:mod:`raft_tpu_torch.analysis.mcheck` never exercises, and therefore a hole
in every safety argument the checker makes.

This engine walks the AST of each protocol module, finds every
mutation site, classifies it into a named action, and pins the result
in ``analysis/protocol_baseline.json``.  ``protocol check`` fails when

* a mutation site appears that the baseline has never seen (new or
  reshaped protocol surface → re-derive the model, then re-pin), or
* a site bypasses the sanctioned channels entirely (raw ``os.rename``
  / bare ``open(..., "w")`` → unmodeled mutation), or
* the explorer itself finds an interleaving/crash schedule that breaks
  an invariant (see ``mcheck.INVARIANTS``).

Like the other static engines it imports neither torch nor jax, so it
runs as a pre-commit / CI gate.
"""

from __future__ import annotations

import ast
import json
import os

from raft_tpu_torch.analysis.lint import Finding, repo_root

BASELINE_SCHEMA = "protocol-baseline/v1"
BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "protocol_baseline.json")

#: The protocol surface: every module whose writes coordinate the fleet
#: through the shared filesystem.  Keys are short names used in site
#: keys; values are repo-relative paths.
MODULES = {
    "fabric": "raft_tpu_torch/parallel/fabric.py",
    "fleet": "raft_tpu_torch/serve/fleet.py",
    "release": "raft_tpu_torch/aot/release.py",
    "rollout": "raft_tpu_torch/serve/rollout.py",
    "router": "raft_tpu_torch/serve/router.py",
    "canary": "raft_tpu_torch/serve/canary.py",
}

#: Sanctioned mutating entry points of the fsops seam.
_FSOPS_MUTATORS = frozenset({
    "create_exclusive", "write_text", "write_atomic", "replace",
    "rename", "unlink", "utime", "makedirs",
})

#: Lease primitives (imported by value into fleet.py, hence bare names).
_LEASE_PRIMS = frozenset({"lease_claim", "lease_rewrite", "lease_remove"})

#: Sanctioned atomic writers living outside fsops (tmp+replace inside).
_ATOMIC_HELPERS = frozenset({
    "_atomic_write", "_atomic_json", "atomic_savez", "init_manifest",
})

#: Raw os-level mutators.  ``makedirs``/``mkdir`` are idempotent
#: directory scaffolding (ensure-dir); everything else raw is unmodeled.
_OS_MUTATORS = frozenset({
    "rename", "replace", "unlink", "remove", "rmdir", "removedirs",
    "renames", "makedirs", "mkdir", "link", "symlink", "truncate",
    "write",
})

_SHUTIL_MUTATORS = frozenset({
    "rmtree", "move", "copy", "copy2", "copyfile", "copytree",
})

#: Enclosing protocol function (simple name) -> action, for mutations
#: that go through the core fsops/lease channels.  A core-channel write
#: inside a function NOT listed here is an unmodeled finding: the model
#: checker does not know that state machine.
ACTION_BY_FUNC = {
    # fabric lease primitives + sweep ledger
    "lease_claim": "claim",
    "lease_rewrite": "renew",
    "lease_remove": "steal",
    "claim": "claim",
    "renew": "renew",
    "release": "release",
    "steal": "steal",
    # fleet replica lifecycle
    "seize": "seize",
    "evict": "evict",
    # release pointer machine
    "promote": "promote",
    "cut": "record",
    "write_rollout_marker": "marker",
    "clear_rollout_marker": "unmark",
    # worker recovery
    "_eval_shard": "requeue",
}

#: Every action name the model may emit (kept sorted for the baseline).
ACTIONS = tuple(sorted(set(ACTION_BY_FUNC.values())
                       | {"ensure-dir", "heartbeat", "append-log",
                          "record"}))


class Site(object):
    """One static mutation site inside a protocol module."""

    __slots__ = ("module", "path", "qualname", "callee", "line", "col",
                 "action")

    def __init__(self, module, path, qualname, callee, line, col, action):
        self.module = module
        self.path = path
        self.qualname = qualname
        self.callee = callee
        self.line = line
        self.col = col
        self.action = action

    @property
    def key(self):
        return "%s::%s::%s" % (self.module, self.qualname, self.callee)

    @property
    def modeled(self):
        return self.action is not None


def _dotted(node):
    """Dotted name of a call target, or None (subscripts, lambdas...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _open_mode(call):
    """Literal mode string of an ``open()`` call, or None."""
    args = call.args
    if len(args) >= 2 and isinstance(args[1], ast.Constant) \
            and isinstance(args[1].value, str):
        return args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


class _SiteVisitor(ast.NodeVisitor):
    def __init__(self, module, path):
        self.module = module
        self.path = path
        self.stack = []
        self.sites = []

    # -- scope tracking -------------------------------------------------
    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped

    @property
    def qualname(self):
        return ".".join(self.stack) if self.stack else "<module>"

    @property
    def func(self):
        """Innermost plain-function name (classes excluded by usage)."""
        return self.stack[-1] if self.stack else "<module>"

    # -- call classification --------------------------------------------
    def _add(self, call, callee, action):
        self.sites.append(Site(
            self.module, self.path, self.qualname, callee,
            call.lineno, call.col_offset, action))

    def visit_Call(self, node):
        name = _dotted(node.func)
        if name is not None:
            head, _, tail = name.rpartition(".")
            if head == "fsops" and tail in _FSOPS_MUTATORS:
                self._classify_core(node, name, tail)
            elif head == "" and tail in _LEASE_PRIMS:
                self._classify_core(node, name, tail)
            elif tail in _ATOMIC_HELPERS and head in (
                    "resilience", "bank", ""):
                self._add(node, name, "record")
            elif head in ("os", "os.path") and tail in _OS_MUTATORS:
                action = "ensure-dir" if tail in ("makedirs", "mkdir") \
                    else None
                self._add(node, name, action)
            elif head == "shutil" and tail in _SHUTIL_MUTATORS:
                self._add(node, name, None)
            elif name == "open" or name.endswith(".open"):
                mode = _open_mode(node)
                if mode is not None and ("a" in mode):
                    self._add(node, "open[%s]" % mode, "append-log")
                elif mode is not None and any(
                        c in mode for c in "wx+"):
                    self._add(node, "open[%s]" % mode, None)
        self.generic_visit(node)

    def _classify_core(self, node, name, tail):
        if tail == "makedirs":
            self._add(node, name, "ensure-dir")
        elif tail == "utime":
            self._add(node, name, "heartbeat")
        else:
            action = ACTION_BY_FUNC.get(self.func)
            if action is None and self.func in (
                    "write_done", "write_worker_status", "init_sweep",
                    "publish_router_record", "spawn_worker",
                    "spawn_replica"):
                action = "record"
            self._add(node, name, action)


def extract_module(module, path):
    """All mutation sites in one protocol module (repo-relative path)."""
    full = path if os.path.isabs(path) else os.path.join(repo_root(), path)
    with open(full) as f:
        tree = ast.parse(f.read(), filename=path)
    v = _SiteVisitor(module, path)
    v.visit(tree)
    return v.sites


def extract_all(modules=None):
    """Extract every module; returns ``(sites, unmodeled)`` lists."""
    sites = []
    for module, path in sorted((modules or MODULES).items()):
        sites.extend(extract_module(module, path))
    unmodeled = [s for s in sites if not s.modeled]
    return sites, unmodeled


def sites_to_model(sites):
    """Collapse modeled sites into the baseline mapping: site key ->
    ``{"action": ..., "count": n}`` (count disambiguates repeated calls
    of the same channel inside one function)."""
    model = {}
    for s in sites:
        if not s.modeled:
            continue
        ent = model.setdefault(s.key, {"action": s.action, "count": 0})
        ent["count"] += 1
        if ent["action"] != s.action:
            # same key, conflicting classification: surface as drift by
            # recording the lexically-last action (diff will flag it).
            ent["action"] = s.action
    return model


def load_baseline(path=BASELINE_PATH):
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError("unexpected baseline schema: %r"
                         % data.get("schema"))
    return data


def write_baseline(path=BASELINE_PATH):
    """Re-pin the baseline.  Refuses while unmodeled sites exist — an
    unmodeled mutation must be routed through fsops (and given an
    action) before it can be pinned, otherwise the pin would bless a
    write the explorer never exercises."""
    from raft_tpu_torch.analysis import mcheck

    sites, unmodeled = extract_all()
    if unmodeled:
        raise ValueError(
            "refusing to pin baseline over %d unmodeled mutation "
            "site(s); run `protocol extract` and route them through "
            "utils.fsops first" % len(unmodeled))
    data = {
        "schema": BASELINE_SCHEMA,
        "invariants": list(mcheck.INVARIANTS),
        "sites": {k: dict(v) for k, v in
                  sorted(sites_to_model(sites).items())},
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return data


def _site_finding(site, rule, message):
    return Finding(path=site.path, line=site.line, col=site.col,
                   rule=rule, message=message)


def diff_against_baseline(sites, unmodeled, baseline):
    """Static findings: unmodeled sites + drift vs the pinned model."""
    findings = []
    for s in unmodeled:
        sanctioned = (s.callee.startswith("fsops.")
                      or s.callee.split(".")[-1] in _LEASE_PRIMS)
        hint = ("teach ACTION_BY_FUNC the enclosing protocol action"
                if sanctioned else "route through utils.fsops and "
                "classify it") + " (then re-pin the baseline)"
        findings.append(_site_finding(
            s, "protocol-unmodeled",
            "unmodeled fs mutation %s in %s::%s — %s"
            % (s.callee, s.module, s.qualname, hint)))

    model = sites_to_model(sites)
    pinned = baseline.get("sites", {})
    first_by_key = {}
    for s in sites:
        if s.modeled:
            first_by_key.setdefault(s.key, s)

    for key in sorted(set(model) - set(pinned)):
        s = first_by_key[key]
        findings.append(_site_finding(
            s, "protocol-drift",
            "new protocol mutation site %s (action %s) not in "
            "baseline — extend the mcheck model, then re-pin with "
            "`protocol baseline --write`" % (key, model[key]["action"])))
    for key in sorted(set(pinned) - set(model)):
        ent = pinned[key]
        mod = key.split("::", 1)[0]
        findings.append(Finding(
            path=MODULES.get(mod, "raft_tpu_torch/analysis/protocol_baseline.json"),
            line=1, col=0, rule="protocol-drift",
            message="pinned mutation site %s (action %s) vanished — "
                    "the protocol surface shrank; re-pin the baseline"
                    % (key, ent.get("action"))))
    for key in sorted(set(model) & set(pinned)):
        got, want = model[key], pinned[key]
        if (got["action"], got["count"]) != (
                want.get("action"), want.get("count")):
            s = first_by_key[key]
            findings.append(_site_finding(
                s, "protocol-drift",
                "mutation site %s reshaped: baseline pinned action=%s "
                "count=%s, extraction found action=%s count=%s"
                % (key, want.get("action"), want.get("count"),
                   got["action"], got["count"])))
    return findings


def explorer_findings(patches=None, scenarios=None):
    """Run the interleaving explorer; map violations to findings."""
    from raft_tpu_torch.analysis import mcheck

    violations, stats = mcheck.run_all(patches=patches,
                                       scenarios=scenarios)
    findings = []
    for name, v in violations:
        findings.append(Finding(
            path="raft_tpu_torch/analysis/mcheck.py", line=1, col=0,
            rule="protocol-" + v.invariant,
            message="scenario %s: %s | trace: %s"
                    % (name, v.detail, " -> ".join(v.trace[-12:]))))
    return findings, stats


def check(baseline_path=BASELINE_PATH, explore=True, scenarios=None):
    """Full gate: extraction diff + invariant check of the baseline
    + (optionally) the exhaustive interleaving exploration."""
    from raft_tpu_torch.analysis import mcheck

    sites, unmodeled = extract_all()
    try:
        baseline = load_baseline(baseline_path)
    except (OSError, ValueError) as e:
        findings = [Finding(
            path="raft_tpu_torch/analysis/protocol_baseline.json", line=1,
            col=0, rule="protocol-baseline",
            message="cannot load protocol baseline (%s); pin it with "
                    "`python -m raft_tpu_torch.analysis protocol baseline "
                    "--write`" % e)]
        return findings, {}
    findings = diff_against_baseline(sites, unmodeled, baseline)

    if sorted(baseline.get("invariants", [])) != sorted(mcheck.INVARIANTS):
        findings.append(Finding(
            path="raft_tpu_torch/analysis/protocol_baseline.json", line=1,
            col=0, rule="protocol-drift",
            message="invariant set drifted from baseline: pinned %s vs "
                    "mcheck %s — re-pin after reviewing"
                    % (sorted(baseline.get("invariants", [])),
                       sorted(mcheck.INVARIANTS))))

    stats = {}
    if explore and not findings:
        more, stats = explorer_findings(scenarios=scenarios)
        findings.extend(more)
    return findings, stats


def _static_fixture_module(src, path):
    """``PROTOCOL_MODULE = "name"`` constant from a static fixture's
    AST, or None.  Read without executing: static fixtures deliberately
    contain raw mutation calls and must only ever be *scanned*."""
    for node in ast.parse(src, filename=path).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "PROTOCOL_MODULE" \
                and isinstance(node.value, ast.Constant):
            return node.value.value
    return None


def run_fixture(path):
    """Drive the engines against a seeded-bug fixture module.

    Two fixture shapes are supported:

    * ``PATCHES`` — a dict ``"module.path:attr" -> replacement``; the
      explorer re-runs with the buggy behaviour patched over the real
      protocol functions (optionally restricted via ``SCENARIOS``).
    * ``PROTOCOL_MODULE`` — the static engine scans the fixture file
      itself as if it were that protocol module, diffing its mutation
      sites against the pinned baseline.
    """
    from raft_tpu_torch.analysis import mcheck

    src = open(path).read()
    module = _static_fixture_module(src, path)
    if module is not None:
        modules = dict(MODULES)
        modules[module] = os.path.abspath(path)
        sites, unmodeled = extract_all(modules)
        baseline = load_baseline()
        return diff_against_baseline(sites, unmodeled, baseline), {}

    mod = mcheck.load_fixture(path)
    names = getattr(mod, "SCENARIOS", None)
    scenarios = None
    if names:
        scenarios = [s for s in mcheck.SCENARIOS if s.name in names]
    return explorer_findings(patches=mod.PATCHES, scenarios=scenarios)

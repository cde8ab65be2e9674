"""Declarative alert-rule engine over the metrics registry (the port's
copy of ``raft_tpu/obs/alerts.py``: the same rules, predicates, state
machine, sink records and replay on the same inputs).

**Rules** declare conditions over the live registry in the namespaced
metric form the run store flattens to — ``counter:<name>``,
``gauge:<name>:value``, ``hist:<name>:p95``, ``window:<name>:p95``,
``waste:<axis>``, ``derived:<name>`` — so one selector grammar spans
live processes and stored run records.  A named daemon thread
evaluates them every ``RAFT_TPU_ALERT_EVAL_S`` seconds against
:func:`raft_tpu_torch.obs.metrics.snapshot`, and firing/resolving

* emits the registered ``alert_fire`` / ``alert_resolve`` events,
* maintains the ``alerts_active`` gauge (+ ``alerts_fired`` /
  ``alerts_resolved`` counters),
* appends one JSON record per transition to the ``RAFT_TPU_ALERTS``
  JSONL sink (single-line ``"a"``-mode append under the engine lock),
* is served live at ``GET /alerts`` on the serving process.

Rule grammar (one dict per rule, YAML or JSON)::

    name:       breaker-storm            # unique id
    metric:     counter:router_breaker_opens
    predicate:  rate_above               # above | below | rate_above
                                         # | absent
    threshold:  0.0                      # per-second for rate_above
    for_s:      0.0                      # condition must hold this long
    clear_s:    10.0                     # resolve hysteresis: condition
                                         # must stay clean this long
    severity:   critical                 # info | warning | critical
    replay_above: 0.0                    # `eval --record` total-value
                                         # threshold for rate rules
    context:    canary_parity            # context-registry key attached
                                         # to the fire payload

``rate_above`` compares the metric's per-second rate of increase
between consecutive evaluations (counter resets are treated as
no-rate, never a negative spike); ``absent`` fires when the metric is
missing from the snapshot.  A rule whose metric is absent (other than
``absent`` rules) does not apply that tick — a cold process must not
page about metrics it has not minted yet.

The default rule pack (:func:`default_rules`) is the reference's:
SLO-breach storms, breaker-open storms, membership lease churn,
result-cache hit-rate collapse, compile-budget burn and canary
failures/parity splits.  Three of its inputs have no live source in the
port yet: the router's breaker counter and the fleet's evictions come
with the fleet (ROADMAP A15(h)), the canary's with ``serve/canary.py``
(A15(h)), and ``compile-budget-burn`` reads ``counter:xla_real_compiles``
— the reference's XLA recompile sentinel, which the port has no
counterpart of (it compiles its kernels with ``nvcc`` ahead of the
first launch and traces nothing at run time).  The rule and the fold of
a record's ``compiles`` block are kept as they are, so records written
by the reference replay the same; a port record's ``compiles`` is
empty and the rule does not apply to it.

``python -m raft_tpu_torch.obs alerts {list,check,eval}`` are the
offline verbs; ``eval --record`` replays the rules against a stored run
record (rate rules gate on their cumulative total vs ``replay_above``)
with no live process and no torch import.

This module also owns the **provenance wire format** (:func:`
format_provenance` / :func:`parse_provenance` for the
``x-raft-provenance`` response header) and the cross-replica
consistency verdict (:func:`provenance_consistency`): the serve client
and ``obs report``'s consistency line read them without touching the
device.

Pure stdlib; zero overhead when ``RAFT_TPU_ALERT_EVAL_S`` is unset (no
thread, no state, :func:`maybe_start` returns None).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

SEVERITIES = ("info", "warning", "critical")

PREDICATES = ("above", "below", "rate_above", "absent")

#: selector prefixes of the flattened metric namespace (the run
#: store's :func:`raft_tpu_torch.obs.runs.flatten` names, plus the live-only
#: ``gauge:<name>:value`` and the counter-ratio ``derived:`` family)
_SELECTOR_RE = re.compile(
    r"^(counter|gauge|hist|window|stage|waste|derived|extra):.+|^wall_s$")


# ------------------------------------------------------------------- rules


@dataclass(frozen=True)
class Rule:
    """One declarative alert rule (see the module docstring grammar)."""

    name: str
    metric: str
    predicate: str
    threshold: float = 0.0
    for_s: float = 0.0
    clear_s: float = 0.0
    severity: str = "warning"
    replay_above: float = 0.0
    context: str | None = None
    help: str = ""


def parse_rule(obj):
    """Validate one rule dict into a :class:`Rule`; raises
    ``ValueError`` naming the offending field (the ``alerts check``
    CLI surfaces these)."""
    if not isinstance(obj, dict):
        raise ValueError(f"rule must be a mapping, got {type(obj).__name__}")
    name = obj.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("rule needs a non-empty string 'name'")
    metric = obj.get("metric")
    if not isinstance(metric, str) or not _SELECTOR_RE.match(metric or ""):
        raise ValueError(
            f"rule {name!r}: 'metric' must be a namespaced selector "
            "(counter:<n> | gauge:<n>:value|max | hist:<n>:p50|p95|mean | "
            f"window:<n>:p50|p95 | waste:<axis> | derived:<n> | "
            f"extra:<path> | wall_s), got {metric!r}")
    predicate = obj.get("predicate")
    if predicate not in PREDICATES:
        raise ValueError(f"rule {name!r}: predicate must be one of "
                         f"{'/'.join(PREDICATES)}, got {predicate!r}")
    severity = obj.get("severity", "warning")
    if severity not in SEVERITIES:
        raise ValueError(f"rule {name!r}: severity must be one of "
                         f"{'/'.join(SEVERITIES)}, got {severity!r}")
    unknown = set(obj) - {"name", "metric", "predicate", "threshold",
                          "for_s", "clear_s", "severity", "replay_above",
                          "context", "help", "disabled"}
    if unknown:
        raise ValueError(f"rule {name!r}: unknown field(s) "
                         f"{sorted(unknown)}")

    def num(field, default=0.0, lo=None):
        v = obj.get(field, default)
        try:
            v = float(v)
        except (TypeError, ValueError):
            raise ValueError(f"rule {name!r}: {field!r} must be a number, "
                             f"got {obj.get(field)!r}")
        if lo is not None and v < lo:
            raise ValueError(f"rule {name!r}: {field!r} must be >= {lo}")
        return v

    return Rule(name=name, metric=metric, predicate=predicate,
                threshold=num("threshold"),
                for_s=num("for_s", lo=0.0), clear_s=num("clear_s", lo=0.0),
                severity=severity,
                replay_above=num("replay_above"),
                context=obj.get("context") or None,
                help=str(obj.get("help") or ""))


def default_rules():
    """The default rule pack: the fleet's known failure classes, each
    grounded in a metric the reference already records.  Thresholds
    are deliberately conservative — steady state on a healthy fleet
    fires nothing (drill-asserted).  Re-checked against the adaptive
    serve tick + cost-pruned batch ladder: light-load requests now
    dispatch solo (lower occupancy, MORE dispatches), which moves no
    rule input — cache keys, compile counts and breaker/lease signals
    are all window-independent, and `cache-hit-collapse` gates on the
    0.05 floor precisely so legitimate low-dup workloads (every light-
    load probe is a distinct case) cannot page anyone."""
    return [
        Rule("slo-breach", "counter:serve_slo_breaches", "rate_above",
             threshold=0.1, for_s=5.0, clear_s=30.0, severity="warning",
             help="sustained RAFT_TPU_SERVE_SLO_MS breaches (>0.1/s for "
                  "5s) — the sliding-window SLO is being missed"),
        Rule("breaker-storm", "counter:router_breaker_opens", "rate_above",
             threshold=0.0, clear_s=10.0, severity="critical",
             help="router circuit breakers are opening: a replica is "
                  "dead, hung or erroring (the kill-a-replica signal)"),
        Rule("lease-churn", "counter:fleet_evictions", "rate_above",
             threshold=0.0, clear_s=30.0, severity="warning",
             help="fleet membership leases are expiring and being "
                  "evicted — replicas are dying faster than they renew"),
        Rule("cache-hit-collapse", "derived:serve_cache_hit_rate", "below",
             threshold=0.05, for_s=30.0, clear_s=30.0, severity="warning",
             help="the content-addressed result cache stopped hitting "
                  "(routing affinity broken, or a flag flip changed "
                  "every cache key)"),
        Rule("compile-budget-burn", "counter:xla_real_compiles",
             "rate_above", threshold=0.0, clear_s=60.0, severity="critical",
             help="REAL XLA compilations at steady state — the AOT "
                  "bank/warmup contract (0 steady-state compiles) is "
                  "broken"),
        Rule("canary-failure", "counter:canary_fail", "rate_above",
             threshold=0.0, clear_s=60.0, severity="critical",
             context="canary_parity",
             help="golden-answer canary probes are failing: a replica "
                  "returns numbers that differ from the captured golden"),
        Rule("canary-parity", "gauge:canary_parity_ok:value", "below",
             threshold=1.0, clear_s=5.0, severity="critical",
             context="canary_parity",
             help="cross-replica parity is broken: replicas disagree on "
                  "golden outputs or serve from divergent provenance "
                  "(stale bank, env skew, flag divergence)"),
    ]


def load_rules(path=None):
    """The effective rule pack: :func:`default_rules`, overridden and
    extended by the YAML/JSON rule file at ``path`` (same-name rules
    replace, ``disabled: true`` removes, top-level ``default_pack:
    false`` starts from empty).  ``path=None`` returns the default
    pack."""
    rules = {r.name: r for r in default_rules()}
    if not path:
        return list(rules.values())
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"{path}: not JSON and pyyaml is unavailable for YAML")
        data = yaml.safe_load(text)
    if isinstance(data, dict):
        if data.get("default_pack") is False:
            rules = {}
        entries = data.get("rules")
        if not isinstance(entries, list):
            raise ValueError(f"{path}: expected a top-level 'rules' list")
        extra_top = set(data) - {"rules", "default_pack"}
        if extra_top:
            raise ValueError(f"{path}: unknown top-level field(s) "
                             f"{sorted(extra_top)}")
    elif isinstance(data, list):
        entries = data
    else:
        raise ValueError(f"{path}: rule file must be a list of rules or a "
                         "mapping with a 'rules' list")
    for e in entries:
        if isinstance(e, dict) and e.get("disabled"):
            name = e.get("name")
            if not name:
                raise ValueError(f"{path}: 'disabled' entry needs a 'name'")
            rules.pop(name, None)
            continue
        r = parse_rule(e)
        rules[r.name] = r
    return list(rules.values())


# -------------------------------------------------- flattened metric view


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v == v


def _derived_metrics(counters):
    """Counter-ratio metrics rules can gate on directly: cache hit
    rates from the exact hit/miss counter pairs every
    :class:`~raft_tpu_torch.serve.cache.ResultCache` maintains."""
    out = {}
    for name in counters or {}:
        m = re.fullmatch(r"(\w+)_hits", name)
        if not m:
            continue
        prefix = m.group(1)
        hits = counters.get(f"{prefix}_hits", 0)
        misses = counters.get(f"{prefix}_misses")
        if misses is None:
            continue
        total = hits + misses
        if total:
            out[f"derived:{prefix}_hit_rate"] = hits / total
    return out


def flatten_record(record):
    """One flat ``{selector: float}`` view of a run record — the rule
    evaluation domain.  Delegates to the run store's
    :func:`raft_tpu_torch.obs.runs.flatten` (so rule selectors and ``obs
    runs regress`` watch patterns share one namespace) and adds the
    alerting extras: current gauge values (``gauge:<name>:value``),
    the ``derived:`` counter ratios, and the record's recompile-
    sentinel counts (``compiles.xla_compiles/xla_real_compiles`` live
    OUTSIDE the metrics snapshot — folding them in as ``counter:`` is
    what lets ``compile-budget-burn`` fire on a reference record)."""
    from raft_tpu_torch.obs import runs

    flat = runs.flatten(record)
    snap = record.get("snapshot") or {}
    for name, g in (snap.get("gauges") or {}).items():
        if isinstance(g, dict) and _num(g.get("value")):
            flat[f"gauge:{name}:value"] = float(g["value"])
    flat.update(_derived_metrics(snap.get("counters") or {}))
    for name, v in (record.get("compiles") or {}).items():
        if _num(v):
            flat.setdefault(f"counter:{name}", float(v))
    return flat


def flatten_snapshot(snap):
    """Flatten a live :func:`raft_tpu_torch.obs.metrics.snapshot` (what
    the evaluator daemon feeds the engine every tick).  The reference
    folds its recompile sentinel's counts in here; the port has none
    (see the module docstring), so its ``compiles`` block is empty."""
    return flatten_record({"snapshot": snap, "compiles": {}})


# -------------------------------------------------------- context registry

_CONTEXT_LOCK = threading.Lock()
#: rule-context payloads published by subsystems (e.g. the canary's
#: offending-provenance detail) and attached to fire records/events of
#: rules declaring ``context: <key>``
_CONTEXT: dict[str, dict] = {}  # raft-lint: guarded-by=_CONTEXT_LOCK


def set_context(key, payload):
    """Publish the detail payload a firing rule should carry (the
    canary names the offending replica/provenance here)."""
    with _CONTEXT_LOCK:
        if payload is None:
            _CONTEXT.pop(key, None)
        else:
            _CONTEXT[key] = dict(payload)


def get_context(key):
    if key is None:
        return None
    with _CONTEXT_LOCK:
        payload = _CONTEXT.get(key)
        return dict(payload) if payload else None


# ------------------------------------------------------------------ engine


class _RuleState:
    __slots__ = ("pending_since", "firing_since", "clear_since",
                 "last_value", "last_t", "fires", "value")

    def __init__(self):
        self.pending_since = None
        self.firing_since = None
        self.clear_since = None
        self.last_value = None   # rate_above: previous sample
        self.last_t = None
        self.fires = 0
        self.value = None        # last evaluated metric value


class AlertEngine:
    """Evaluates a rule pack against flattened metric views and owns
    the fire/resolve lifecycle (for-duration, resolve hysteresis,
    events, counters, the ``alerts_active`` gauge and the
    ``RAFT_TPU_ALERTS`` JSONL sink).

    ``clock`` is injectable (monotonic seconds) so the for-duration /
    hysteresis state machine is deterministic under test."""

    def __init__(self, rules=None, sink_path=None, clock=time.monotonic):
        self.rules = list(rules if rules is not None else default_rules())
        self.sink_path = sink_path
        self._clock = clock
        self._lock = threading.Lock()
        self._states = {r.name: _RuleState()
                        for r in self.rules}  # raft-lint: guarded-by=self._lock
        #: end time of the previous evaluate() pass (None before the
        #: first): lets a counter MINTED mid-life — breaker opens,
        #: evictions, canary failures all create their counter on
        #: first increment — register as a rate from 0 instead of
        #: silently becoming the baseline
        self._last_eval_t = None  # raft-lint: guarded-by=self._lock

    # ---------------------------------------------------------- evaluate

    def _condition(self, rule, st, flat, now):
        """(applies, condition) of one rule this tick.  A metric absent
        from the view makes every predicate but ``absent`` not-apply."""
        v = flat.get(rule.metric)
        st.value = v
        if rule.predicate == "absent":
            return True, v is None
        if v is None:
            return False, False
        if rule.predicate == "above":
            return True, v > rule.threshold
        if rule.predicate == "below":
            return True, v < rule.threshold
        # rate_above: per-second increase between consecutive samples.
        # A counter reset (value went DOWN: process restart) re-
        # baselines without firing.  A metric first seen AFTER the
        # engine's first pass was MINTED mid-life (counters are created
        # on their first increment — breaker opens, evictions, canary
        # failures), so it counts as a rate from 0 since the previous
        # pass; on the engine's first pass everything baselines
        # silently (pre-existing totals, e.g. warmup compiles, are not
        # a storm).
        prev_v, prev_t = st.last_value, st.last_t
        if prev_v is None and self._last_eval_t is not None:
            prev_v, prev_t = 0.0, self._last_eval_t
        st.last_value, st.last_t = v, now
        if prev_v is None or prev_t is None or now <= prev_t or v < prev_v:
            return True, False
        rate = (v - prev_v) / (now - prev_t)
        return True, rate > rule.threshold

    def evaluate(self, flat, now=None):
        """One evaluation pass over a flattened metric view; returns
        the list of transition records (fires + resolves) this pass
        produced.  Thread-safe: the daemon and ad-hoc callers share
        the engine."""
        now = self._clock() if now is None else float(now)
        transitions = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                applies, cond = self._condition(rule, st, flat, now)
                if not applies:
                    continue
                if cond:
                    st.clear_since = None
                    if st.firing_since is not None:
                        continue
                    if st.pending_since is None:
                        st.pending_since = now
                    if now - st.pending_since >= rule.for_s:
                        st.firing_since = now
                        st.pending_since = None
                        st.fires += 1
                        transitions.append(self._record(
                            "fire", rule, st.value,
                            context=get_context(rule.context)))
                else:
                    st.pending_since = None
                    if st.firing_since is None:
                        continue
                    if st.clear_since is None:
                        st.clear_since = now
                    if now - st.clear_since >= rule.clear_s:
                        duration = round(now - st.firing_since, 3)
                        st.firing_since = None
                        st.clear_since = None
                        transitions.append(self._record(
                            "resolve", rule, st.value, duration_s=duration))
            n_active = sum(1 for s in self._states.values()
                           if s.firing_since is not None)
            for rec in transitions:
                self._sink_write(rec)
            self._last_eval_t = now
        metrics.gauge("alerts_active").set(n_active)
        for rec in transitions:
            if rec["kind"] == "fire":
                metrics.counter("alerts_fired").inc()
                log_event("alert_fire", rule=rec["rule"],
                          severity=rec["severity"], metric=rec["metric"],
                          value=rec["value"], threshold=rec["threshold"],
                          context=rec["context"])
                # black-box the moments before the fire: the triggering
                # rule lands in the dump filename (alert-<rule>), so a
                # fleet's FLIGHT_DIR reads as a postmortem index
                from raft_tpu_torch.obs import flight

                flight.dump(trigger=f"alert-{rec['rule']}")
            else:
                metrics.counter("alerts_resolved").inc()
                log_event("alert_resolve", rule=rec["rule"],
                          severity=rec["severity"], metric=rec["metric"],
                          duration_s=rec["duration_s"], value=rec["value"])
        return transitions

    def _record(self, kind, rule, value, duration_s=None, context=None):
        """One sink/transition record (the ``alert-record`` schema
        family — every key below is written unconditionally)."""
        return {
            "t_unix": round(time.time(), 3),
            "kind": kind,
            "rule": rule.name,
            "severity": rule.severity,
            "metric": rule.metric,
            "predicate": rule.predicate,
            "threshold": rule.threshold,
            "value": value,
            "for_s": rule.for_s,
            "duration_s": duration_s,
            "context": context,
            "pid": os.getpid(),
        }

    def _sink_write(self, rec):
        """Append one record to the ``RAFT_TPU_ALERTS`` JSONL sink:
        a single-line ``"a"``-mode append (one write syscall) under
        the engine lock — the bounded-append idiom the structlog sink
        established; a torn multi-process interleave cannot occur
        inside one line."""
        path = self.sink_path
        if not path:
            return
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        except OSError:
            pass  # the sink is telemetry; losing a line must not crash

    # ----------------------------------------------------------- queries

    def active(self):
        """Currently-firing rules: ``[{rule, severity, metric, since_s,
        value}]``."""
        now = self._clock()
        out = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                if st.firing_since is None:
                    continue
                out.append({"rule": rule.name, "severity": rule.severity,
                            "metric": rule.metric, "value": st.value,
                            "since_s": round(now - st.firing_since, 3),
                            "context": get_context(rule.context)})
        return out

    def summary(self):
        """JSON-ready engine state (the ``GET /alerts`` payload body)."""
        with self._lock:
            rules = [{"name": r.name, "metric": r.metric,
                      "predicate": r.predicate, "threshold": r.threshold,
                      "for_s": r.for_s, "clear_s": r.clear_s,
                      "severity": r.severity,
                      "firing": self._states[r.name].firing_since
                      is not None,
                      "fires": self._states[r.name].fires,
                      "value": self._states[r.name].value}
                     for r in self.rules]
        return {"rules": rules, "active": self.active()}


# ------------------------------------------------------------------ replay


def replay_rules(rules, record):
    """Replay a rule pack against one stored run record (``alerts eval
    --record``): no daemon, no live registry, no torch.

    A record is ONE snapshot, so time-domain semantics collapse:
    ``for_s`` is ignored, and ``rate_above`` rules gate on the
    counter's cumulative TOTAL exceeding the rule's ``replay_above``
    (a whole-session total of zero breaches/opens/compiles is the
    clean bar the fixtures pin).  Returns ``(fired, checked)``."""
    flat = flatten_record(record)
    fired, checked = [], 0
    for rule in rules:
        v = flat.get(rule.metric)
        if rule.predicate == "absent":
            checked += 1
            cond = v is None
        elif v is None:
            continue
        elif rule.predicate == "above":
            checked += 1
            cond = v > rule.threshold
        elif rule.predicate == "below":
            checked += 1
            cond = v < rule.threshold
        else:  # rate_above
            checked += 1
            cond = v > rule.replay_above
        if cond:
            fired.append({"rule": rule.name, "severity": rule.severity,
                          "metric": rule.metric, "value": v,
                          "threshold": (rule.replay_above
                                        if rule.predicate == "rate_above"
                                        else rule.threshold),
                          "help": rule.help})
    return fired, checked


# -------------------------------------------------------------- sink reads


def read_sink(path):
    """Parse one ``RAFT_TPU_ALERTS`` JSONL sink; returns ``(records,
    n_bad_lines)`` — damaged lines counted, never fatal."""
    records, bad = [], 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            # both keys the renderer hard-subscripts must be present —
            # a foreign/truncated record counts as unparseable, it
            # must not crash `alerts list --sink`
            if isinstance(rec, dict) and "rule" in rec and "kind" in rec:
                records.append(rec)
            else:
                bad += 1
    return records, bad


def render_sink_summary(records):
    """Human-readable lines over parsed sink records (``alerts list
    --sink``)."""
    out = []
    for rec in records:
        t = time.strftime("%Y-%m-%d %H:%M:%S",
                          time.localtime(rec.get("t_unix") or 0))
        line = (f"{t}  {rec['kind']:8s} {rec['rule']:24s} "
                f"[{rec.get('severity') or '?'}] "
                f"{rec.get('metric') or '?'} = {rec.get('value')}")
        if rec.get("duration_s") is not None:
            line += f" (fired {rec.get('duration_s')}s)"
        if rec.get("context"):
            line += f"  context={json.dumps(rec.get('context'), default=str)}"
        out.append(line)
    return out


# ----------------------------------------------------- provenance codec

#: field order of the ``x-raft-provenance`` header (fixed, so the
#: header is byte-stable for a given provenance dict); ``release`` is
#: last — pre-release replicas simply omit it and old parsers ignore it
PROVENANCE_FIELDS = ("bank_key", "bank_sha", "code", "flags", "replica",
                     "release")


def format_provenance(prov):
    """``x-raft-provenance`` header value from a provenance dict:
    ``bank_key=..;bank_sha=..;code=..;flags=..;replica=..`` (known
    fields in fixed order; values sanitized to header-safe chars)."""
    parts = []
    for k in PROVENANCE_FIELDS:
        v = prov.get(k)
        if v is None:
            continue
        v = re.sub(r"[;=\s]", "_", str(v))
        parts.append(f"{k}={v}")
    return ";".join(parts)


def parse_provenance(value):
    """Parse an ``x-raft-provenance`` header into a dict, or None when
    the value is empty/garbled (a consumer must never crash on a
    foreign header)."""
    if not value or not isinstance(value, str):
        return None
    out = {}
    for part in value.split(";"):
        k, sep, v = part.partition("=")
        if sep and k.strip():
            out[k.strip()] = v.strip()
    return out or None


def provenance_consistency(by_design, releases=None):
    """Cross-replica provenance verdict over ``{design: {replica:
    prov_dict}}``: two replicas serving the SAME design must agree on
    the bank payload sha, bank key, code hash and flags key (replica
    id legitimately differs).  Returns ``{"consistent": bool,
    "splits": [{design, field, values: {replica: value}}]}`` — the
    canary feeds this into the ``canary_parity`` rule context so the
    alert payload names the offending provenance.

    ``releases`` makes the verdict VERSION-AWARE (:func:`raft_tpu_torch.
    aot.release.parity_context`): ``{"allowed": [release ids
    legitimately in the fleet], "entries": {release_id: [16-char
    payload sha prefixes]}}``.  A mid-rollout fleet spans two release
    ids, so cross-replica comparison happens *within* a release group
    (mixed-version skew is expected, not an alarm), while a replica
    stamping an id outside ``allowed`` — or a bank sha its own
    release's manifest never shipped — is a genuine skew even when it
    is the lone replica on that release (the seeded
    ``provenance_skew`` drill).  ``releases=None`` is exactly the
    pre-release behavior."""
    allowed = set((releases or {}).get("allowed") or ())
    manifest_shas = {rid: set(shas) for rid, shas in
                     ((releases or {}).get("entries") or {}).items()}
    splits = []
    for design in sorted(by_design or {}):
        provs = {rid: p for rid, p in (by_design[design] or {}).items()
                 if p}
        if releases:
            groups = {}
            for rid, p in provs.items():
                rel = p.get("release") or "none"
                if allowed and rel not in allowed:
                    splits.append({"design": design, "field": "release",
                                   "values": {rid: rel}})
                    continue
                sha = p.get("bank_sha") or "none"
                shipped = manifest_shas.get(rel)
                if shipped is not None and sha not in shipped \
                        and sha != "none":
                    splits.append({"design": design, "field": "bank_sha",
                                   "values": {rid: sha}})
                    continue
                groups.setdefault(rel, {})[rid] = p
        else:
            groups = {None: provs}
        for group in groups.values():
            if len(group) < 2:
                continue
            for field in ("bank_sha", "bank_key", "code", "flags"):
                values = {rid: (p.get(field) or "none")
                          for rid, p in group.items()}
                if len(set(values.values())) > 1:
                    splits.append({"design": design, "field": field,
                                   "values": dict(sorted(values.items()))})
    return {"consistent": not splits, "splits": splits}


# ------------------------------------------------------ process lifecycle


class AlertDaemon(threading.Thread):
    """Daemon thread evaluating the engine against the live metrics
    registry every ``interval_s`` seconds (``RAFT_TPU_ALERT_EVAL_S``)."""

    def __init__(self, engine, interval_s=None):
        super().__init__(name="raft-alert-eval", daemon=True)
        self.engine = engine
        self.interval_s = float(interval_s if interval_s is not None
                                else config.get("ALERT_EVAL_S"))
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.engine.evaluate(flatten_snapshot(metrics.snapshot()))
            except Exception:
                pass  # a bad pass must never kill alerting

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)


_INSTALL_LOCK = threading.Lock()
#: the process-wide (engine, daemon) pair, installed at most once
_INSTALLED: list = []  # raft-lint: guarded-by=_INSTALL_LOCK


def maybe_start():
    """Start the in-process alert evaluator when
    ``RAFT_TPU_ALERT_EVAL_S`` > 0 (idempotent; returns the daemon or
    None).  With the flag unset this is a float compare and nothing
    else — the zero-overhead invariant."""
    interval = float(config.get("ALERT_EVAL_S") or 0)
    if interval <= 0:
        return None
    with _INSTALL_LOCK:
        if _INSTALLED:
            return _INSTALLED[1]
        rules = load_rules(config.get("ALERT_RULES") or None)
        engine = AlertEngine(rules, sink_path=config.get("ALERTS") or None)
        daemon = AlertDaemon(engine, interval)
        daemon.start()
        _INSTALLED[:] = [engine, daemon]
    return daemon


def installed_engine():
    with _INSTALL_LOCK:
        return _INSTALLED[0] if _INSTALLED else None


def stop():
    """Stop + uninstall the process evaluator (idempotent)."""
    with _INSTALL_LOCK:
        if not _INSTALLED:
            return
        _engine, daemon = _INSTALLED
        _INSTALLED[:] = []
    daemon.stop()


def endpoint_payload():
    """The ``GET /alerts`` body: engine state when the evaluator is
    installed, an explicit ``enabled: false`` otherwise."""
    engine = installed_engine()
    if engine is None:
        return {"ok": True, "enabled": False, "active": [], "rules": []}
    return {"ok": True, "enabled": True, **engine.summary()}

"""Op contracts of the hot-path entries (the port's counterpart of
``raft_tpu/analysis/jaxpr_contracts.py``, with the repeat check of
``raft_tpu/analysis/recompile.py``).

An eager port has no jaxpr: each aten op an entry runs on a CUDA tensor
is a launch.  So the contracts are checked on the ops themselves, which
a ``TorchDispatchMode`` (:class:`OpRecorder`) records while an entry
runs once on the spar demo (``tests/fixtures/torch_port/
design_spar.json``, one sea state): each op's name, its output dtypes,
and whether it ran inside the drag fixed point's trips
(:data:`raft_tpu_torch.models.dynamics.TRIP_SCOPE`).
:func:`raft_tpu_torch.ops.linsolve.solve` is recorded as one op,
``raft.solve``, and the ops inside it are not: on the CPU it runs its
plain version, on the card it is one kernel launch, and a count means
the same on both.  The sums of ``ops/scatter.py`` take the card's form
(one-hot products) on the CPU too, so one baseline holds for both
devices; a copy of host data to the card (``h2d``, a Python scalar
made a CUDA tensor) is counted apart.

The entries are the reference's seven: ``drag_lin_iter``,
``system_response``, ``solve_dynamics_fowt``, the design evaluator,
the bucket evaluator, the case evaluator (``fused_case``) and the
status fold (``health_status``, :func:`raft_tpu_torch.api._case_status`
over :mod:`raft_tpu_torch.utils.health`).  The contracts:

* **structure** — ``drag_lin_iter`` runs at most one gather-class op
  (``index_select`` / ``gather`` / ``index``: the node-response
  lookup; the geometry gathers belong to ``drag_lin_precompute``);
  ``system_response`` and the status fold run none; an entry with
  trips runs at most one gather per trip inside them;
* **host isolation** — no host sync (``_local_scalar_dense``,
  ``is_nonzero``, ``nonzero``, a device-to-host copy) in
  ``drag_lin_iter``, ``system_response`` or the status fold; inside the
  trips exactly one per ``RAFT_TPU_SCAN_CHUNK`` trips of each fixed
  point (the stop test), and in ``solve_dynamics_fowt`` no other;
* **dtype** — under ``RAFT_TPU_DTYPE=float32`` no op produces a
  float64 / complex128 value: anywhere in the flat entries, inside the
  trips of the composite ones (their statics and build-side prefix
  work at build precision, as in the reference);
* **budget** — each entry's total and per-op counts within the
  reference's slack of ``op_baseline.json``, counted on the CPU in
  float64 and float32, with ``RAFT_TPU_FUSED`` on and off for the
  evaluators.  Regenerate after an intentional change with ``python -m
  raft_tpu_torch.analysis baseline --write``;
* **repeat** — a second identical call builds no program and runs
  ``nvcc`` no time (:mod:`raft_tpu_torch.utils.budget`,
  :data:`raft_tpu_torch.ops.linsolve.NVCC_RUNS`) and runs the same ops.

The port has one fixed-point driver, so there are no while / scan
variants.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from collections import Counter
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raft_tpu_torch.analysis.lint import repo_root

#: ops that index a tensor by another (a gather on the card)
GATHER_OPS = frozenset({"index_select", "gather", "index", "take"})
#: ops that wait for the device and bring a value to the host
SYNC_OPS = frozenset({"_local_scalar_dense", "is_nonzero", "nonzero",
                      "item"})
#: the copy ops, told apart by their source and target devices
_COPY_OPS = frozenset({"_to_copy", "copy_", "copy"})
_WIDE = (torch.float64, torch.complex128)
#: the name under which one call of linsolve.solve is recorded
SOLVE_OP = "raft.solve"

DEFAULT_DESIGN = os.path.join(repo_root(), "tests", "fixtures",
                              "torch_port", "design_spar.json")
SPAR_CASE = dict(Hs=6.0, Tp=12.0, beta=0.0)

# budget slack (the reference's): small refactors must not flap the
# gate, a re-gather per trip or an unrolled loop must fail it
PRIM_RATIO, PRIM_ABS = 1.25, 4
TOTAL_RATIO, TOTAL_ABS = 1.15, 16


@dataclass(frozen=True)
class Contract:
    """Declarative limits of one entry.

    max_gathers : gather-class ops allowed in the whole entry (None: no
        cap; an entry with trips is held to one per trip there).
    host : ``"none"`` (no host sync at all), ``"stop-test"`` (the stop
        tests in the trips and no other sync) or ``"trips"`` (the stop
        tests in the trips; syncs elsewhere only budgeted).
    dtype_clean : where no 64-bit value may be produced under float32:
        ``"all"``, ``"trips"`` or ``""``.
    fused : the ``RAFT_TPU_FUSED`` modes recorded (``()``: the flag
        does not reach the entry).
    """

    name: str
    max_gathers: int | None = None
    host: str = "none"
    dtype_clean: str = "all"
    fused: tuple = ()


CONTRACTS = {
    # one gather: the per-trip node-response lookup
    "drag_lin_iter": Contract("drag_lin_iter", max_gathers=1),
    "system_response": Contract("system_response", max_gathers=0),
    "solve_dynamics_fowt": Contract("solve_dynamics_fowt",
                                    host="stop-test", dtype_clean="trips"),
    "design_evaluator": Contract("design_evaluator", host="trips",
                                 dtype_clean="trips", fused=("on", "off")),
    # the spar packed into its bucket (default ladders): growth means
    # the padded chain picked up per-design work
    "bucket_evaluator": Contract("bucket_evaluator", host="trips",
                                 dtype_clean="trips", fused=("on", "off")),
    # the case evaluator; with FUSED=on its response is the fixed
    # point's final solve, so its count must stay below the staged one
    "fused_case": Contract("fused_case", host="trips", dtype_clean="trips",
                           fused=("on", "off")),
    # the status fold: elementwise bit arithmetic
    "health_status": Contract("health_status", max_gathers=0),
}


def baseline_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "op_baseline.json")


# ------------------------------------------------------------ recording

#: overload -> (``index_select.default``-style name, kind): kind 1 a
#: copy, 2 a host sync, 0 any other op
_KINDS = {}


def _kind(func):
    hit = _KINDS.get(func)
    if hit is None:
        name = getattr(func, "__name__", str(func))
        packet = getattr(getattr(func, "overloadpacket", None), "__name__",
                         name.split(".")[0])
        hit = _KINDS[func] = (name, 1 if packet in _COPY_OPS
                              else 2 if packet in SYNC_OPS else 0)
    return hit


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _first_device(args, kwargs):
    for t in _tensors((args, kwargs)):
        return t.device
    return None


class OpRecorder(TorchDispatchMode):
    """Records every aten op run under it (see the module docstring).

    ``ops`` counts ops by name, ``raft.solve`` included, the ops inside
    a solve excluded; ``trip_ops`` the part of them inside the trips;
    ``syncs`` and ``wide`` list ``(op, in_trips)`` / ``(op, dtype,
    in_trips)``; ``fixed_points`` holds each fixed point's trips (the
    solves inside its trip scope) and its syncs there; ``h2d`` counts
    copies of host data to another device."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()
        self.trip_ops = Counter()
        self.syncs = []
        self.wide = []
        self.h2d = 0
        self.fixed_points = []
        self._solve_depth = 0
        self._trip = None

    # -- the two scopes the recorder is told about

    @contextlib.contextmanager
    def trip_scope(self):
        outer, self._trip = self._trip, {"trips": 0, "syncs": 0}
        try:
            yield
        finally:
            self.fixed_points.append(self._trip)
            self._trip = outer

    def solve(self, fn):
        """``fn`` (linsolve.solve) recorded as one op."""
        def wrapped(*args, **kwargs):
            self._solve_depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._solve_depth -= 1
            if not self._solve_depth:
                self._note(SOLVE_OP, out)
                if self._trip is not None:
                    self._trip["trips"] += 1
            return out

        return wrapped

    # -- the dispatch hook

    def _note(self, name, out):
        in_trips = self._trip is not None
        self.ops[name] += 1
        if in_trips:
            self.trip_ops[name] += 1
        for t in ((out,) if isinstance(out, torch.Tensor) else _tensors(out)):
            if t.dtype in _WIDE:
                self.wide.append((name, str(t.dtype).replace("torch.", ""),
                                  in_trips))

    def _sync(self, name):
        in_trips = self._trip is not None
        self.syncs.append((name, in_trips))
        if in_trips:
            self._trip["syncs"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._solve_depth:
            return out
        name, kind = _kind(func)
        if kind == 1:
            if name.startswith("copy_"):   # copy_(dst, src)
                dst, src = args[0].device, _first_device(args[1:], {})
            else:
                src = _first_device(args, kwargs)
                dst = next(iter(_tensors(out)), None)
                dst = dst.device if dst is not None else src
            if src is not None and src.type == "cpu" and dst.type != "cpu":
                self.h2d += 1
                return out
            if src is not None and src.type != "cpu" and dst.type == "cpu":
                self._sync(name)
        elif kind == 2:
            self._sync(name)
        self._note(name, out)
        return out

    # -- the summary

    def summary(self):
        gathers = sum(n for k, n in self.ops.items()
                      if k.split(".")[0] in GATHER_OPS)
        trip_gathers = sum(n for k, n in self.trip_ops.items()
                           if k.split(".")[0] in GATHER_OPS)
        return dict(
            total=sum(self.ops.values()), ops=dict(sorted(self.ops.items())),
            gathers=gathers, trip_gathers=trip_gathers,
            syncs=len(self.syncs),
            trip_syncs=sum(1 for _, t in self.syncs if t),
            wide=len(self.wide), trip_wide=sum(1 for w in self.wide if w[2]),
            wide_sample=sorted({f"{op}->{dt}" for op, dt, _ in self.wide})[:6],
            trips=[fp["trips"] for fp in self.fixed_points], h2d=self.h2d)


@contextlib.contextmanager
def recording():
    """An :class:`OpRecorder` over the block, with ``linsolve.solve``
    recorded as one op, the fixed point's trips marked and the scatter
    sums in the card's form on any device."""
    from raft_tpu_torch.models import dynamics
    from raft_tpu_torch.ops import linsolve, scatter

    rec = OpRecorder()
    saved = (linsolve.solve, dynamics.TRIP_SCOPE, scatter._card_form)
    linsolve.solve = rec.solve(linsolve.solve)
    dynamics.TRIP_SCOPE = rec.trip_scope
    scatter._card_form = lambda t: True
    try:
        with rec:
            yield rec
    finally:
        linsolve.solve, dynamics.TRIP_SCOPE, scatter._card_form = saved


@contextlib.contextmanager
def _flag_env(**flags):
    """Pin ``RAFT_TPU_*`` flags for the block (None unsets one)."""
    from raft_tpu_torch.utils import config

    old = {}
    try:
        for k, v in flags.items():
            env = config.env_name(k)
            old[env] = os.environ.get(env)
            if v is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = str(v)
        yield
    finally:
        for env, v in old.items():
            if v is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = v


# ---------------------------------------------------------------- entries

class EntryRunner:
    """Builds the spar demo once and, per entry and variant, the entry's
    inputs (outside the recording) and a call of the entry."""

    def __init__(self, design=None, device="cpu"):
        from raft_tpu_torch.models.model import Model

        self.design = design or DEFAULT_DESIGN
        with open(self.design, encoding="utf-8") as f:
            self.model = Model(json.load(f))
        self.device = torch.device(device)
        self._capture = {}

    @staticmethod
    def variants(entry, dtype_modes):
        """``float64``, ``float32+fused``, ``float32+staged``, ..."""
        fused = CONTRACTS[entry].fused
        names = {"on": "fused", "off": "staged"}
        return [d + ("+" + names[f] if f else "")
                for d in dtype_modes for f in (fused or ("",))]

    @staticmethod
    def flags(variant):
        """The flags a variant pins (the rest at their defaults)."""
        dtype, _, fused = variant.partition("+")
        return dict(DTYPE=dtype, FUSED={"fused": "on", "staged": "off",
                                        "": None}[fused],
                    SOLVER="native", SCAN_CHUNK=None, COND_CHECK=None,
                    COND_THRESHOLD=None, ITER_SCALE=None, BUCKET_ROWS=None)

    def _captured(self):
        """The arguments of the case evaluator's solve_dynamics_fowt
        call on the spar under the pinned flags (one call per dtype
        policy)."""
        from raft_tpu_torch.api import make_case_evaluator
        from raft_tpu_torch.structure import bucketing
        from raft_tpu_torch.utils import config

        policy = config.get("DTYPE")
        if policy in self._capture:
            return self._capture[policy]
        got = {}
        inner = bucketing.solve_dynamics_fowt

        def capture(*args, **kwargs):
            got["args"], got["kwargs"] = args, dict(kwargs, timer=None)
            return inner(*args, **kwargs)

        bucketing.solve_dynamics_fowt = capture
        try:
            with torch.no_grad():
                make_case_evaluator(self.model, self.device)(**SPAR_CASE)
        finally:
            bucketing.solve_dynamics_fowt = inner
        self._capture[policy] = got["args"], got["kwargs"]
        return self._capture[policy]

    def prepare(self, entry):
        """A zero-argument call of ``entry`` on inputs made here (call it
        under the variant's flags)."""
        from raft_tpu_torch import api
        from raft_tpu_torch.models import dynamics
        from raft_tpu_torch.physics import morison
        from raft_tpu_torch.structure import bucketing
        from raft_tpu_torch.utils.dtypes import compute_dtypes

        dev = self.device
        if entry == "fused_case":
            ev = api.make_case_evaluator(self.model, dev)
            return lambda: ev(**SPAR_CASE)
        if entry == "design_evaluator":
            ev = api.make_design_evaluator(self.model, dev)
            return lambda: ev(**SPAR_CASE, Cd_scale=1.0, Ca_scale=1.0,
                              L_moor_scale=1.0)
        if entry == "bucket_evaluator":
            sig = bucketing.bucket_signature(self.model)
            d = bucketing.packed_from_numpy(bucketing.stack_packed(
                [bucketing.pack_design(self.model, sig)]), dev)
            ev = bucketing.BucketEvaluator(sig, device=dev)
            rdt = d["K_h"].dtype
            case = {k: torch.full((1,), v, dtype=rdt, device=dev)
                    for k, v in SPAR_CASE.items()}
            return lambda: ev(d, **case)
        args, kwargs = self._captured()
        fs, ss, hc, u0, M, B, C, F, w, Tn, r_nodes = args
        rdt, cdt = compute_dtypes(M, F, w)
        R, n, nw = F.shape
        if entry == "solve_dynamics_fowt":
            return lambda: dynamics.solve_dynamics_fowt(*args, **kwargs)
        if entry == "drag_lin_iter":
            pre = morison.drag_lin_precompute(
                fs, ss, hc, u0.to(cdt), Tn, r_nodes, w.to(rdt),
                dtype=(rdt, cdt))
            Xi0 = torch.full((R, n, nw), 0.1, dtype=cdt, device=dev)
            return lambda: morison.drag_lin_iter(pre, Xi0)
        if entry == "system_response":
            Z = torch.eye(n, dtype=cdt, device=dev).expand(R, 1, nw, n, n)
            Fw = torch.ones((R, 2, n, nw), dtype=cdt, device=dev)
            return lambda: dynamics.system_response(Z, Fw)
        if entry == "health_status":
            st = torch.zeros(R, dtype=torch.int32, device=dev)
            diag = {"status": torch.zeros(R, dtype=torch.int32, device=dev)}
            X0 = torch.zeros((R, n), dtype=rdt, device=dev)
            Xi = torch.zeros((R, n, nw), dtype=cdt, device=dev)
            clipped = torch.zeros(R, dtype=torch.bool, device=dev)
            return lambda: api._case_status(st, diag, X0, Xi,
                                            input_clipped=clipped)
        raise KeyError(f"unknown entry {entry!r}")

    def record(self, entry, variant, repeat=False):
        """Record one call of ``entry`` under ``variant`` (see
        :func:`recording`): the recorder's summary plus the solve
        kernel's forward launches, the program builds and ``nvcc`` runs
        of the call and its ``outputs``; with ``repeat``, a second
        identical call's as ``repeat``."""
        from raft_tpu_torch.utils import config

        with _flag_env(**self.flags(variant)):
            fn = self.prepare(entry)
            out = self._one(fn)
            if repeat:
                out["repeat"] = self._one(fn)
            out["chunk"] = max(1, int(config.get("SCAN_CHUNK")))
        return out

    @staticmethod
    def _one(fn):
        from raft_tpu_torch.ops import linsolve
        from raft_tpu_torch.utils import budget

        launches0, builds0 = linsolve.KERNEL_LAUNCHES, budget.builds()
        nvcc0 = linsolve.NVCC_RUNS
        with torch.no_grad(), recording() as rec:
            result = fn()
        out = rec.summary()
        out.update(launches=linsolve.KERNEL_LAUNCHES - launches0,
                   builds=budget.builds() - builds0,
                   nvcc=linsolve.NVCC_RUNS - nvcc0, outputs=result)
        return out


# --------------------------------------------------------------- checking

def check_structure(entry, variant, s):
    """Contract violations (strings) of one recorded variant ``s`` (an
    :meth:`EntryRunner.record`)."""
    c = CONTRACTS[entry]
    tag = f"{entry}[{variant}]"
    out = []
    if c.max_gathers is not None and s["gathers"] > c.max_gathers:
        out.append(f"{tag}: {s['gathers']} gather-class op(s) (contract "
                   f"allows {c.max_gathers}) — hoist the lookup into the "
                   "precompute stage")
    trips = sum(s["trips"])
    if s["trips"] and s["trip_gathers"] > trips:
        out.append(f"{tag}: {s['trip_gathers']} gather-class op(s) in "
                   f"{trips} trip(s) — a gather re-done in every trip "
                   "belongs in drag_lin_precompute")
    chunk = s["chunk"]
    stops = sum(math.ceil(t / chunk) for t in s["trips"])
    if c.host == "none" and s["syncs"]:
        out.append(f"{tag}: {s['syncs']} host sync(s) in an entry that "
                   "must run none")
    elif c.host in ("stop-test", "trips") and s["trip_syncs"] != stops:
        out.append(f"{tag}: {s['trip_syncs']} host sync(s) in the trips, "
                   f"want {stops} (one stop test per {chunk} trips of "
                   f"{s['trips']})")
    if c.host == "stop-test" and s["syncs"] != s["trip_syncs"]:
        out.append(f"{tag}: {s['syncs'] - s['trip_syncs']} host sync(s) "
                   "outside the trips")
    if c.dtype_clean and variant.startswith("float32"):
        n = s["wide"] if c.dtype_clean == "all" else s["trip_wide"]
        if n:
            where = "" if c.dtype_clean == "all" else " inside the trips"
            out.append(f"{tag}: {n} op(s) produce 64-bit values under "
                       f"RAFT_TPU_DTYPE=float32{where} "
                       f"({', '.join(s['wide_sample'])})")
    return out


def check_budget(entry, variant, s, baseline):
    """Budget violations against the stored counts, with an op-level
    diff in the message."""
    base = baseline.get("entries", {}).get(entry, {}).get(variant)
    tag = f"{entry}[{variant}]"
    if base is None:
        return [f"{tag}: no baseline entry — run `python -m "
                "raft_tpu_torch.analysis baseline --write`"]
    out = []
    cap = int(base["total"] * TOTAL_RATIO + TOTAL_ABS)
    if s["total"] > cap:
        grew = [(p, base["ops"].get(p, 0), n) for p, n in
                sorted(s["ops"].items(), key=lambda kv: -kv[1])
                if n > base["ops"].get(p, 0)]
        diff = ", ".join(f"{p}: {b}->{n}" for p, b, n in grew[:8])
        out.append(f"{tag}: total op count {s['total']} exceeds budget "
                   f"{cap} (baseline {base['total']}); grew: {diff}")
    for p, n in s["ops"].items():
        b = base["ops"].get(p, 0)
        if n > int(b * PRIM_RATIO + PRIM_ABS):
            out.append(f"{tag}: {p} x{n} exceeds budget "
                       f"{int(b * PRIM_RATIO + PRIM_ABS)} (baseline {b})")
    return out


def check_repeat(entry, variant, s):
    """The repeat call: no build, no nvcc, the same ops."""
    r = s.get("repeat")
    if r is None:
        return []
    tag = f"{entry}[{variant}]"
    out = []
    if r["builds"] or r["nvcc"]:
        out.append(f"{tag}: the repeat call built {r['builds']} "
                   f"program(s) and ran nvcc {r['nvcc']} time(s)")
    if r["ops"] != s["ops"]:
        diff = sorted(k for k in set(r["ops"]) | set(s["ops"])
                      if r["ops"].get(k) != s["ops"].get(k))
        out.append(f"{tag}: the repeat call ran other ops ({diff[:6]})")
    return out


def load_baseline(path=None):
    path = path or baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def run_checks(design=None, dtype_modes=("float64", "float32"),
               update_baseline=False, runner=None, repeat=True):
    """Record every entry variant on the CPU and check every contract.

    Returns ``{"violations": [...], "log": [...], "counts": {...}}``.
    With ``update_baseline`` the measured counts replace the stored
    baseline (budgets are not checked then, and nothing is written over
    a structure, host, dtype or repeat violation).  ``repeat`` calls
    each entry a second time in its first variant.  ``runner`` reuses
    an :class:`EntryRunner` (tests share one model build)."""
    runner = runner or EntryRunner(design)
    baseline = load_baseline()
    design_name = os.path.basename(runner.design)
    if (not update_baseline and baseline
            and baseline.get("design") != design_name):
        return {"violations": [
            f"op baseline was recorded for {baseline.get('design')!r}, "
            f"not {design_name!r}; run `python -m raft_tpu_torch.analysis "
            f"baseline --write --design ...` or check the spar demo"],
            "log": [], "counts": {}}
    violations, log, measured = [], [], {}
    for entry in CONTRACTS:
        measured[entry] = {}
        for i, variant in enumerate(runner.variants(entry,
                                                    tuple(dtype_modes))):
            s = runner.record(entry, variant, repeat=repeat and not i)
            measured[entry][variant] = s
            log.append(f"{entry}[{variant}]: {s['total']} ops "
                       f"({s['ops'].get(SOLVE_OP, 0)} x {SOLVE_OP}, "
                       f"{s['syncs']} host syncs, trips {s['trips']})")
            violations += check_structure(entry, variant, s)
            violations += check_repeat(entry, variant, s)
            if not update_baseline:
                violations += check_budget(entry, variant, s, baseline)
    if update_baseline and not violations:
        payload = dict(
            design=design_name, torch=torch.__version__.split("+")[0],
            pinned_flags=dict(SOLVER="native", SCAN_CHUNK="default",
                              COND_CHECK="default", ITER_SCALE="default",
                              BUCKET_ROWS="default"),
            slack=dict(prim_ratio=PRIM_RATIO, prim_abs=PRIM_ABS,
                       total_ratio=TOTAL_RATIO, total_abs=TOTAL_ABS),
            entries={e: {v: {k: s[k] for k in
                             ("total", "ops", "syncs", "trips")}
                         for v, s in vs.items()}
                     for e, vs in measured.items()})
        with open(baseline_path(), "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
    return {"violations": violations, "log": log, "counts": measured}


# ---------------------------------------------------------------- fixtures

def load_fixture(path):
    """A seeded contract negative (``tests/fixtures/torch_contracts/``):
    its ``PATCHES`` map ``"module:attr"`` to the faulty function, its
    ``ENTRIES`` the ``(entry, variant)`` pairs that must catch it."""
    import importlib.util

    name = "_raft_contract_fixture_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_fixture(path, runner=None):
    """Structure, host and dtype violations of the fixture's entries
    with its patches applied (and removed again)."""
    import importlib

    mod = load_fixture(path)
    runner = runner or EntryRunner()
    saved = []
    try:
        for spec, fn in mod.PATCHES.items():
            target, attr = spec.split(":")
            m = importlib.import_module(target)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, fn)
        out = []
        for entry, variant in mod.ENTRIES:
            out += check_structure(entry, variant,
                                   runner.record(entry, variant))
        return out
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)

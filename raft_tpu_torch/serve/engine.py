"""Design registry + packed-row dispatch of the evaluation service (the
port's counterpart of ``raft_tpu/serve/engine.py``).

The engine resolves designs into packed bucket rows
(:func:`raft_tpu_torch.api.pack_for_serving`) and dispatches coalesced
request groups through the process-cached
:class:`~raft_tpu_torch.structure.bucketing.BucketEvaluator` of their
signature — the same evaluator ``sweep_heterogeneous`` runs — on the
serving device, passed explicitly to every call (torch keeps its
current device per thread, and the batcher dispatches from a thread of
its own).

Batch sizes are a **ladder**: every dispatch pads its rows up to the
next ladder size with masked repeat rows (dropped on fan-out).  Rung
selection is cost-driven by default (``RAFT_TPU_SERVE_LADDER=cost``):
the pow2 candidates ``1, 2, 4, ... <= RAFT_TPU_SERVE_MAX_BATCH`` are
warmed, then :func:`refine_ladder` prunes the rungs whose measured
dispatch wall is flat vs the next rung and keeps the rungs where the
wall scales.  The walls come from a small in-process ledger that every
dispatch fills with its solve wall per (program identity), read after
``torch.cuda.synchronize`` on a card so a wall times the solve and not
the launches.

Every dispatch goes through the program bank (:mod:`raft_tpu_torch.
aot.bank`, armed by ``RAFT_TPU_AOT``) under the bucket program key that
``sweep_heterogeneous`` uses, so serving, sweeps and warm-up share bank
entries; the provenance stamps carry the entry's payload sha and the
release the pointer resolves to.

Nothing here falls back: a dispatch that raises is the caller's error
(the batcher fans it out as a 500), and the only way a served row
reaches the CPU on a card is :func:`escalate_row`, which a request asks
for by name.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time

import numpy as np

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import current_ids, span
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

#: the default dispatched out_keys — ``status`` is NON-OPTIONAL (the
#: per-request error semantics read it), :func:`normalize_out_keys`
#: enforces it
DEFAULT_OUT_KEYS = ("PSD", "X0", "status")


def normalize_out_keys(out_keys):
    """The dispatched out_keys tuple: caller order preserved, ``status``
    appended when missing.  The out_keys tuple is part of the result
    cache key and of the program identity, so every caller normalizes
    through here."""
    keys = tuple(out_keys or DEFAULT_OUT_KEYS)
    return keys if "status" in keys else keys + ("status",)


class DesignEntry:
    """One registered design: the built model resolved into its bucket
    routing key, packed batch row and cache fingerprint."""

    __slots__ = ("name", "model", "sig", "packed", "fingerprint", "axes")

    def __init__(self, name, model):
        from raft_tpu_torch.api import pack_for_serving
        from raft_tpu_torch.structure import bucketing

        self.name = name
        self.model = model
        self.sig, self.packed, self.fingerprint = pack_for_serving(model)
        # per-axis (real, padded) counts for the waste-attribution
        # metrics every serving dispatch feeds
        self.axes = bucketing.axis_counts(model, self.sig)

    def __repr__(self):
        from raft_tpu_torch.structure import bucketing

        return (f"DesignEntry({self.name!r}, "
                f"bucket={bucketing.signature_fingerprint(self.sig)})")


class Registry:
    """Named design registry + content-addressed inline-design cache.

    ``register`` builds the model once at startup (host work, paid
    before the socket binds); inline per-request designs go through
    :meth:`resolve_inline`, which caches built entries by design-content
    fingerprint so a tenant re-posting the same design pays the build
    once.  The inline cache is LRU-bounded (``max_inline``): a model and
    its packed row are megabytes, and an optimizer tenant posting a
    slightly different design every iterate must recycle slots, not
    grow the server's RSS without limit."""

    def __init__(self, max_inline=32):
        self._by_name: dict[str, DesignEntry] = {}
        self._max_inline = int(max_inline)
        self._inline: dict[str, DesignEntry] = {}  # fingerprint -> entry

    def register(self, name, design):
        """Build + pack one design (path or dict) under ``name`` (named
        registrations are permanent — startup designs)."""
        entry = self._build(name, design)
        self._by_name[entry.name] = entry
        return entry

    def _build(self, name, design):
        from raft_tpu_torch.models.model import Model

        base_dir = (os.path.dirname(os.path.abspath(design))
                    if isinstance(design, str) else None)
        return DesignEntry(str(name), Model(design, base_dir=base_dir))

    def get(self, name):
        return self._by_name.get(str(name))

    def resolve_inline(self, design_dict):
        """Entry for an inline design dict: built + LRU-cached by content
        fingerprint (repeat posts hit; the least-recently-used inline
        entry is dropped past ``max_inline``)."""
        from raft_tpu_torch.aot.bank import content_fingerprint

        fp = content_fingerprint(design_dict)
        for named in self._by_name.values():   # inline post of a
            if named.fingerprint == fp:        # registered design
                return named
        entry = self._inline.get(fp)
        if entry is not None:
            self._inline.pop(fp)       # refresh recency (insert order)
            self._inline[fp] = entry
            return entry
        metrics.counter("serve_inline_designs").inc()
        entry = self._build(f"inline-{fp[:12]}", design_dict)
        while len(self._inline) >= self._max_inline:
            self._inline.pop(next(iter(self._inline)))
            metrics.counter("serve_inline_evictions").inc()
        self._inline[fp] = entry
        return entry

    def names(self):
        return sorted(self._by_name)

    def __len__(self):
        return len(self._by_name)


# --------------------------------------------------------------- ladder


def batch_ladder(max_batch=None, policy=None):
    """The padded batch sizes the service dispatches (and warms), per
    ``RAFT_TPU_SERVE_LADDER``:

    * ``pow2`` — ``1, 2, 4, ...`` up to ``RAFT_TPU_SERVE_MAX_BATCH`` (at
      least one rung);
    * ``cost`` (default) — the same pow2 CANDIDATES here; after warm-up
      has measured every rung's dispatch wall, :func:`refine_ladder`
      prunes the rungs whose wall is flat vs the next rung;
    * an explicit ascending comma list (e.g. ``1,4,16,64``) — rungs used
      verbatim.

    One serving process dispatches on one device, so the reference's
    dp-axis multiple is 1 here."""
    if max_batch is None:
        max_batch = int(config.get("SERVE_MAX_BATCH"))
    if policy is None:
        policy = str(config.get("SERVE_LADDER") or "cost").strip().lower()
    if policy in ("pow2", "cost"):
        sizes = [1]
        while sizes[-1] * 2 <= max(max_batch, 1):
            sizes.append(sizes[-1] * 2)
        return tuple(sizes)
    try:
        sizes = tuple(int(s) for s in policy.split(",") if s.strip())
    except ValueError:
        raise ValueError(
            f"RAFT_TPU_SERVE_LADDER={policy!r}: expected 'pow2', 'cost' "
            "or an ascending comma list of rung sizes")
    if not sizes or any(b <= a for a, b in zip(sizes, sizes[1:])) or \
            any(s < 1 for s in sizes):
        raise ValueError(
            f"RAFT_TPU_SERVE_LADDER={policy!r}: rungs must be strictly "
            "ascending positive sizes")
    return sizes


def prune_ladder(sizes, walls, tol=None):
    """Cost-driven rung selection: keep a rung only where it measurably
    saves dispatch wall over the next kept rung.

    ``walls`` maps rung -> measured seconds per dispatch (missing rungs
    are kept — never prune on ignorance).  Walking from the top rung
    (always kept: it is the tick's chunk cap) downward, rung ``r``
    survives only if ``wall(next_kept) > tol * wall(r)``; where the wall
    is flat (fixed dispatch-overhead floor, an under-filled device) the
    rung is dropped: fewer programs to warm, the same latency."""
    if tol is None:
        tol = float(config.get("SERVE_LADDER_TOL"))
    sizes = sorted(sizes)
    keep = [sizes[-1]]
    for r in reversed(sizes[:-1]):
        w_r, w_next = walls.get(r), walls.get(keep[-1])
        if w_r is None or w_next is None or w_next > tol * w_r:
            keep.append(r)
    return tuple(sorted(keep))


_WALL_LOCK = threading.Lock()
#: program identity -> {"dispatches", "wall_s", "wall_min_s"}: the solve
#: walls :func:`dispatch` measured in this process
_WALLS: dict = {}  # raft-lint: guarded-by=_WALL_LOCK


def _record_wall(key, wall_s):
    with _WALL_LOCK:
        st = _WALLS.setdefault(key, {"dispatches": 0, "wall_s": 0.0,
                                     "wall_min_s": None})
        st["dispatches"] += 1
        st["wall_s"] += wall_s
        if st["wall_min_s"] is None or wall_s < st["wall_min_s"]:
            st["wall_min_s"] = wall_s


def program_stats(key):
    """The wall ledger's row of one program identity (empty when nothing
    dispatched it): ``dispatches``, ``wall_s`` (their sum) and
    ``wall_min_s`` (the best)."""
    with _WALL_LOCK:
        return dict(_WALLS.get(key) or {})


def busy_s():
    """The summed solve wall of every dispatch this process ran (warm-up
    included): a fleet replica's lease health snapshot carries it, and
    the autoscaler reads its lease-to-lease rate as the replica's
    occupancy."""
    with _WALL_LOCK:
        return sum(st["wall_s"] for st in _WALLS.values())


def ladder_walls(entries, sizes, out_keys=DEFAULT_OUT_KEYS, device=None):
    """Measured dispatch wall per ladder rung, from the in-process wall
    ledger that :func:`dispatch` fills (warm-up dispatches and serving
    load).  Per program the BEST observed wall is taken — one scheduler
    hiccup during a warm-up dispatch must not mis-shape the ladder for
    the server's lifetime, which is also why :func:`warm` dispatches
    every rung twice.  Each rung then reports the WORST of that across
    the served bucket signatures, so a rung is only pruned when it is
    flat for every tenant.  Rungs nothing has measured map to None."""
    out_keys = normalize_out_keys(out_keys)
    by_sig = {}
    for e in entries:
        by_sig.setdefault(e.sig, e)
    walls = {}
    for rung in sizes:
        worst = None
        for e in by_sig.values():
            key, _ = program_identity(e, out_keys=out_keys, rows=rung,
                                      device=device)
            st = program_stats(key)
            if st.get("dispatches") and st.get("wall_s", 0) > 0:
                w = st.get("wall_min_s") or (st["wall_s"]
                                             / st["dispatches"])
                worst = w if worst is None else max(worst, w)
        walls[rung] = worst
    return walls


def refine_ladder(entries, sizes, out_keys=DEFAULT_OUT_KEYS, device=None):
    """Post-warm-up ladder refinement (``RAFT_TPU_SERVE_LADDER=cost``):
    prune the warmed candidate rungs whose measured dispatch wall is
    flat vs the next rung.  Under any other policy — or with no
    measurements — the candidates come back unchanged.  Every returned
    rung was warmed (pruning only drops rungs)."""
    policy = str(config.get("SERVE_LADDER") or "cost").strip().lower()
    if policy != "cost" or len(sizes) <= 1:
        return tuple(sizes)
    walls = ladder_walls(entries, sizes, out_keys=out_keys, device=device)
    pruned = prune_ladder(sizes, walls)
    if tuple(pruned) != tuple(sizes):
        log_event("serve_ladder", candidates=list(sizes),
                  sizes=list(pruned),
                  walls_ms={str(r): (round(w * 1e3, 3) if w else None)
                            for r, w in walls.items()})
    return pruned


def pick_padded(n, sizes):
    """Smallest ladder size holding ``n`` rows (callers chunk to
    ``sizes[-1]`` first)."""
    for s in sizes:
        if s >= n:
            return s
    return sizes[-1]


def _pad1(a, rows):
    a = np.asarray(a, dtype=float)
    if len(a) == rows:
        return a
    return np.concatenate([a, np.full(rows - len(a), a[-1])])


def flags_extra():
    """The state that shapes served numbers beyond the design + case —
    folded into every result-cache key so a flag flip (solver, dtype
    policy, escalation iteration scale) never serves stale rows: the
    evaluator flags (:func:`raft_tpu_torch.utils.config.flags_key`) and
    the real dtype the packed rows are computed in (the reference folds
    in ``jax_enable_x64`` here)."""
    from raft_tpu_torch.utils.dtypes import compute_dtypes

    rdt, _ = compute_dtypes()
    return config.flags_key() + (str(rdt).replace("torch.", ""),)


def padded_group(entries, Hs, Tp, beta, padded, device):
    """The evaluator inputs of one request group padded to ``padded``
    rows on ``device``: the stacked packed rows (masked repeats of the
    last) and the (padded,) sea-state tensors.  A direct
    :class:`~raft_tpu_torch.structure.bucketing.BucketEvaluator` call on
    these is the dispatch itself."""
    import torch

    from raft_tpu_torch.structure import bucketing

    design = bucketing.packed_from_numpy(
        bucketing.stack_packed([e.packed for e in entries], padded), device)
    seas = tuple(torch.as_tensor(_pad1(x, padded), device=device)
                 for x in (Hs, Tp, beta))
    return design, seas


def _on_device(device):
    import torch

    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def dispatch(entries, Hs, Tp, beta, out_keys=DEFAULT_OUT_KEYS, device=None,
             padded=None, record_metrics=True, timings=None):
    """Evaluate one coalesced request group (ONE bucket signature).

    entries : per-row :class:`DesignEntry` (repeat an entry to evaluate
        it under several sea states)
    Hs/Tp/beta : per-row scalars, aligned with ``entries``
    device : the device the group runs on (default: the current CUDA
        device; raises without one)
    padded : the batch size (a :func:`batch_ladder` rung); default: the
        smallest rung holding the rows
    record_metrics : False for non-serving traffic (warm-up) so the
        occupancy/dispatch metrics describe only real request load
    timings : optional dict the call fills with ``solve_s`` (evaluator
        call, device synchronize and result fetch) and ``launches`` (the
        solve kernel's forward launches the call made) — an out-param so
        concurrent callers cannot misattribute each other's walls

    Returns ``{out_key: host numpy array}`` of length ``len(entries)``
    (padding rows dropped).
    """
    import torch

    from raft_tpu_torch.aot import bank
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.structure import bucketing
    from raft_tpu_torch.utils.devices import to_host
    from raft_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    n = len(entries)
    if n == 0:
        raise ValueError("empty dispatch group")
    sig = entries[0].sig
    if any(e.sig != sig for e in entries):
        raise ValueError("dispatch group mixes bucket signatures — the "
                         "batcher groups by signature before dispatching")
    if padded is None:
        padded = pick_padded(n, batch_ladder())
    if padded < n:
        raise ValueError(f"padded batch {padded} cannot hold {n} rows")
    out_keys = tuple(out_keys)
    memo, args, key = _bucket_program(entries[0], out_keys, padded, device)
    with _on_device(device), torch.no_grad():
        ev = bucketing.get_bucket_evaluator(sig, device)
        design, seas = padded_group(entries, Hs, Tp, beta, padded, device)
        with span("sweep_dispatch", kind="serve", rows=n,
                  bucket=bucketing.signature_fingerprint(sig)), \
                bank.consult("bucket", memo, args, device):
            l0 = linsolve.forward_launches()
            t_solve0 = time.perf_counter()
            out = ev(design, *seas)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res = {k: to_host(out[k][:n]) for k in out_keys}
            solve_s = time.perf_counter() - t_solve0
            launches = linsolve.forward_launches() - l0
    _record_wall(key, solve_s)
    if timings is not None:
        timings["solve_s"] = solve_s
        timings["launches"] = launches
    if record_metrics:
        metrics.counter("serve_dispatches").inc()
        metrics.counter("serve_rows_dispatched").inc(n)
        metrics.counter("serve_kernel_launches").inc(launches)
        # batch-shape exemplar: WHICH bucket produced the biggest (or
        # emptiest) dispatch, joinable to its span tree
        ex = {"sig": bucketing.signature_fingerprint(sig),
              "rows": int(n), "padded": int(padded)}
        ids = current_ids()
        if ids is not None:
            ex["trace_id"], ex["span_id"] = ids
        metrics.histogram("serve_batch_rows").observe(n, exemplar=ex)
        metrics.histogram("serve_batch_occupancy").observe(n / padded,
                                                           exemplar=ex)
        # waste attribution: the same per-axis pad accounting the
        # bucketed sweeps feed, here weighted by served request rows
        bucketing.observe_axis_waste([e.axes for e in entries],
                                     rows_valid=n, rows_padded=padded)
    return res


def escalate_row(entry, Hs, Tp, beta, out_keys=DEFAULT_OUT_KEYS):
    """Quarantine-style float64 re-solve of ONE request (per-request
    opt-in): the row alone, on the CPU, under the escalation ladder's
    ``f64_cpu`` rung flags (float64 policy, a scaled iteration budget —
    :func:`raft_tpu_torch.parallel.resilience._rung_flags`).  This is
    the one way a served row reaches the CPU, and only because the
    request named it.  Returns ``(row, status_after)``; adoption policy
    is the caller's (the batcher only adopts a HEALTHY re-solve)."""
    from raft_tpu_torch.parallel import resilience

    metrics.counter("serve_escalations").inc()
    with resilience._rung_flags("f64_cpu"):
        out = dispatch([entry], [Hs], [Tp], [beta], out_keys, device="cpu",
                       padded=1, record_metrics=False)
    row = {kk: out[kk][0] for kk in out_keys}
    return row, int(np.asarray(row["status"]))


# ------------------------------------------------------------- provenance


#: (signature, rows, out_keys, device, flags key) -> (memo_key, args,
#: entry_key) of :func:`_bucket_program`; get / setdefault need no lock
_PROGRAMS: dict = {}


def _bucket_program(entry, out_keys, rows, device):
    """``(memo_key, args, entry_key)`` of the bucket program serving
    ``entry`` at ``rows`` padded rows on ``device`` — the key
    :func:`raft_tpu_torch.parallel.sweep.sweep_heterogeneous` banks the
    same program under on a one-device mesh.  Memoised per process (the
    rest of the entry key, the version and the environment, is fixed
    per process but for the dtype policy, which the flags key holds),
    so a dispatch pays a dict lookup."""
    from raft_tpu_torch.aot import bank
    from raft_tpu_torch.parallel.sweep import bucket_program

    name = bank.device_name(device)
    out_keys = normalize_out_keys(out_keys)
    ck = (entry.sig, int(rows), out_keys, name, config.flags_key())
    hit = _PROGRAMS.get(ck)
    if hit is None:
        memo, args = bucket_program(entry.sig, entry.packed, rows, out_keys,
                                    (("dp",), (1,), (name,)))
        key, _ = bank.entry_key("bucket", memo, args, device)
        hit = _PROGRAMS.setdefault(ck, (memo, args, key))
    return hit


def program_identity(entry, out_keys=DEFAULT_OUT_KEYS, rows=None,
                     device=None):
    """The program-bank identity of the program that serves ``entry`` at
    ``rows`` padded rows (default: the smallest ladder rung) on
    ``device`` (default: the current CUDA device, else the CPU; nothing
    runs): ``(entry_key, sidecar | None)`` — the key :func:`dispatch`
    consults the bank under, derived without dispatching anything, and
    the entry's sidecar when the bank holds it (None under
    ``RAFT_TPU_AOT=off``, which reads no file).  The wall ledger of
    the cost ladder is keyed by it too."""
    from raft_tpu_torch.aot import bank

    device = bank.fingerprint_device(device)
    rows = int(rows) if rows else batch_ladder()[0]
    key = _bucket_program(entry, out_keys, rows, device)[2]
    side = bank.read_meta(key) if bank.mode() != "off" else None
    return key, side


def flags_fingerprint():
    """Short content hash of :func:`flags_extra` — the ``flags``
    component of the provenance stamp: two replicas under divergent
    solver/dtype flags carry different fingerprints even when both are
    individually healthy."""
    return hashlib.sha256(repr(flags_extra()).encode()).hexdigest()[:12]


def build_provenance(registry, out_keys=DEFAULT_OUT_KEYS, sizes=None,
                     replica_id=None, device=None):
    """Per-design provenance stamps for the ``x-raft-provenance``
    response header: ``{design_name: {bank_key, bank_sha, code, flags,
    replica, release?}}`` plus a ``"*"`` base entry (code/flags/replica/
    release only) for inline designs.  Computed ONCE at startup — per
    request the stamp is a dict lookup.  ``bank_key`` is
    :func:`program_identity`'s key at the first rung on ``device``;
    ``bank_sha`` the first 16 hex of its entry's payload sha (``none``
    when the bank holds no entry, or under ``RAFT_TPU_AOT=off``);
    ``release`` the id the release pointer resolves to
    (:func:`raft_tpu_torch.aot.release.current_release`), when there is
    one and the bank is armed.

    The deterministic ``provenance_skew`` fault kind
    (:mod:`raft_tpu_torch.utils.faults`, site ``serve_provenance``)
    perturbs the reported identity — the stand-in for a stale or
    env-skewed replica."""
    from raft_tpu_torch.aot import bank, release
    from raft_tpu_torch.aot.bank import code_fingerprint
    from raft_tpu_torch.utils import faults

    code = code_fingerprint()
    flags = flags_fingerprint()
    rid = str(replica_id or f"pid-{os.getpid()}")
    skewed = faults.take("provenance_skew", "serve_provenance")
    base = {"code": code, "flags": flags, "replica": rid}
    rel = release.current_release() if bank.mode() != "off" else None
    if rel:
        # the release id resolved through the current pointer — the
        # version-aware canary groups replicas by this stamp
        base["release"] = rel
    out = {"*": dict(base)}
    for name in registry.names():
        key, side = program_identity(registry.get(name), out_keys=out_keys,
                                     rows=(sizes[0] if sizes else None),
                                     device=device)
        d = dict(base)
        d["bank_key"] = key
        d["bank_sha"] = ((side or {}).get("payload_sha256") or "none")[:16]
        if skewed:
            d["bank_sha"] = ("skew" + d["bank_sha"])[:16]
            d["bank_key"] = "skew-" + d["bank_key"]
        out[name] = d
    return out


# ----------------------------------------------------------------- warmup


def warm(entries, device=None, out_keys=DEFAULT_OUT_KEYS, sizes=None):
    """Warm every (bucket signature x ladder size) the service will
    dispatch for ``entries``: one dispatch with synthetic sea states
    (the kernel library is built or loaded on the first, the
    evaluators are created), then a second, timed one for the cost
    ladder — the ladder tuner reads the BEST wall per rung, and a first
    dispatch carries one-time costs.  Each dispatch ends in a device
    synchronize (:func:`dispatch`).  Through the production funnel:
    under ``RAFT_TPU_AOT=load`` each program is loaded from the bank or
    built and stored; under ``require`` a cold bank fails here, before
    any client is waiting.  Returns per-(signature x rung) report dicts:
    ``kind``, ``rows``, ``bucket``, ``wall_s``, ``loaded`` and
    ``compiled`` (bank entries loaded / programs built) and
    ``launches`` (the solve kernel's launches of both dispatches)."""
    from raft_tpu_torch.aot.warmup import ProgramReport
    from raft_tpu_torch.structure import bucketing
    from raft_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    if sizes is None:
        sizes = batch_ladder()
    out_keys = normalize_out_keys(out_keys)
    by_sig: dict = {}
    for e in entries:
        by_sig.setdefault(e.sig, []).append(e)
    reports = []
    rng = np.random.default_rng(0)
    for sig, group in by_sig.items():
        for rows in sizes:
            row_entries = [group[i % len(group)] for i in range(rows)]
            rep = ProgramReport("serve", rows,
                                bucket=bucketing.signature_fingerprint(sig))
            for _ in range(2):
                dispatch(row_entries, rng.uniform(2.0, 8.0, rows),
                         rng.uniform(6.0, 14.0, rows),
                         rng.uniform(-0.5, 0.5, rows), out_keys=out_keys,
                         device=device, padded=rows, record_metrics=False)
            reports.append(rep.done())
    return reports

"""Warm the program bank before anyone is waiting on it (the port's
counterpart of ``raft_tpu/aot/warmup.py``).

Builds a model once and dispatches each requested kind through the
SAME funnel production uses (:mod:`raft_tpu_torch.parallel.sweep`, the
serving engine), with ``RAFT_TPU_AOT`` forced to at least ``load`` — so
every program the funnels would run is built, run and stored now, and
a fresh serving or worker process later loads it: on the card the
bank's copy of the kernel library, with no ``nvcc`` run.

The kinds:

* ``cases``  — :func:`raft_tpu_torch.api.make_case_evaluator` through
  :func:`~raft_tpu_torch.parallel.sweep.sweep_cases`;
* ``full``   — :func:`raft_tpu_torch.api.make_full_evaluator` through
  :func:`~raft_tpu_torch.parallel.sweep.sweep_cases_full`;
* ``design`` — :func:`raft_tpu_torch.api.make_design_evaluator` through
  ``sweep_cases_full``;
* ``bucketed`` — :func:`~raft_tpu_torch.parallel.sweep.
  sweep_heterogeneous` over the bundled design trio, ``n`` rows of every
  bucket signature;
* ``serve`` — the serving engine's bucket programs at the batcher's
  candidate ladder (:func:`raft_tpu_torch.serve.engine.warm`; set
  ``RAFT_TPU_SERVE_MAX_BATCH`` / ``RAFT_TPU_SERVE_LADDER`` and
  ``--out-keys`` / ``--dtype`` to EXACTLY what the server will run;
  ``--n`` is ignored for it).

Batch sizes are per program: the bank keys on the padded inputs'
signature, so warm the sizes you will dispatch (a fabric worker warms
its shard size).  What the bank cannot carry stays per process: the
torch import, the CUDA context, the lazy loading of the library's and
torch's kernels, the host build of a model; a warm-up moves them ahead
of the first request or claim.

Fabric workers (:mod:`raft_tpu_torch.parallel.fabric`) call
:func:`warmup_model` before their first claim when the sweep spec names
a warm-up block and ``RAFT_TPU_AOT`` is armed.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

DEFAULT_OUT_KEYS = ("PSD", "X0", "status")
DEFAULT_KINDS = ("cases", "full", "design")
ALL_KINDS = DEFAULT_KINDS + ("bucketed", "serve")

_DESIGNS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "fixtures", "torch_port")
#: the default design (the reference's bundled spar demo, in the JSON
#: form the port reads)
DEFAULT_DESIGN = os.path.join(_DESIGNS_DIR, "design_spar.json")
#: ``bucketed`` warms the bucket programs of the bundled design trio
BUCKET_WARMUP_DESIGNS = tuple(
    os.path.join(_DESIGNS_DIR, f"design_{n}.json")
    for n in ("spar", "semi", "mhk"))


@contextlib.contextmanager
def _force_load_mode():
    """Arm the bank for the duration of the warm-up (a warm-up under
    ``RAFT_TPU_AOT=off`` would store nothing; ``require`` would refuse
    the very misses it exists to fill)."""
    from raft_tpu_torch.utils import config

    env = config.env_name("AOT")
    old = os.environ.get(env)
    if config.get("AOT") != "load":
        os.environ[env] = "load"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old


def _round_up(n, multiple):
    return int(-(-n // multiple) * multiple)


def _model(path):
    from raft_tpu_torch.models.model import Model

    base_dir = (os.path.dirname(os.path.abspath(path))
                if isinstance(path, str) else None)
    return Model(path, base_dir=base_dir)


class ProgramReport:
    """The report of one warmed program (here and in
    :func:`raft_tpu_torch.serve.engine.warm`): started before its
    dispatches, :meth:`done` after them returns the reference's report
    dict — ``kind``, ``rows``, ``wall_s``, ``loaded`` and ``compiled``
    (the bank counters' growth) — plus ``launches`` (the solve
    kernel's), and logs the ``aot_warmup`` event."""

    def __init__(self, kind, rows, **extra):
        from raft_tpu_torch.obs import metrics
        from raft_tpu_torch.ops import linsolve

        self._metrics, self._linsolve = metrics, linsolve
        self.rep = dict(kind=kind, rows=rows, **extra)
        self._c0 = self._counts()
        self._l0 = linsolve.forward_launches()
        self._t0 = time.perf_counter()

    def _counts(self):
        return [self._metrics.counter(k).value for k in
                ("aot_programs_loaded", "aot_programs_compiled")]

    def done(self):
        from raft_tpu_torch.utils.structlog import log_event

        wall = time.perf_counter() - self._t0
        c1 = self._counts()
        self.rep.update(wall_s=round(wall, 2),
                        loaded=c1[0] - self._c0[0],
                        compiled=c1[1] - self._c0[1],
                        launches=self._linsolve.forward_launches() - self._l0)
        kw = {"n_buckets": self.rep["n_buckets"]} \
            if "n_buckets" in self.rep else {}
        log_event("aot_warmup", kind=self.rep["kind"], n=self.rep["rows"],
                  loaded=self.rep["loaded"], compiled=self.rep["compiled"],
                  wall_s=self.rep["wall_s"], **kw)
        return self.rep


def warmup_model(design=None, sizes=(8,), kinds=DEFAULT_KINDS,
                 out_keys=DEFAULT_OUT_KEYS, mesh=None, designs=None,
                 device=None):
    """Warm the bank for one design (a path or dict; default
    :data:`DEFAULT_DESIGN`); ``designs`` — a list of paths — warms the
    ``serve`` kind for SEVERAL, deduplicated by bucket signature.
    ``mesh`` (default: one entry of ``device``, else every CUDA device;
    raises without CUDA and without ``device``) is where the programs
    run.  Returns a list of per-program report dicts: ``kind``,
    ``rows``, ``wall_s``, ``loaded`` / ``compiled`` (bank entries loaded
    / programs built) and ``launches`` (the solve kernel's)."""
    from raft_tpu_torch import api
    from raft_tpu_torch.parallel.sweep import (make_mesh, sweep_cases,
                                               sweep_cases_full)

    unknown = set(kinds) - set(ALL_KINDS)
    if unknown:
        # a typo'd kind must not report a successful no-op warm-up — the
        # serving process would discover the cold bank as BankMissError
        raise ValueError(f"unknown warmup kind(s) {sorted(unknown)}; "
                         f"choose from {list(ALL_KINDS)}")
    if mesh is None:
        mesh = make_mesh(device=device) if device is not None \
            else make_mesh()
    dev = mesh.devices.flat[0]
    dp = mesh.shape.get("dp", mesh.devices.size)

    # the single-design model feeds the cases/full/design kinds, and the
    # serve kind only when no `designs` list supplies its entries
    evaluators = {}
    model = None
    need_model = bool(set(kinds) - {"bucketed", "serve"}) \
        or ("serve" in kinds and not designs)
    if need_model:
        model = _model(design if design is not None else DEFAULT_DESIGN)
        for kind, factory in (("cases", api.make_case_evaluator),
                              ("full", api.make_full_evaluator),
                              ("design", api.make_design_evaluator)):
            if kind in kinds:
                evaluators[kind] = factory(model, device=dev)

    reports = []
    with _force_load_mode():
        for kind, evaluate in evaluators.items():
            for n in sizes:
                rows = _round_up(int(n), dp)
                rng = np.random.default_rng(0)
                Hs = rng.uniform(2.0, 8.0, rows)
                Tp = rng.uniform(6.0, 14.0, rows)
                beta = rng.uniform(-0.5, 0.5, rows)
                r = ProgramReport(kind, rows)
                if kind == "cases":
                    sweep_cases(evaluate, Hs, Tp, beta, mesh=mesh,
                                out_keys=out_keys)
                elif kind == "full":
                    sweep_cases_full(
                        evaluate,
                        {"wind_speed": rng.uniform(4.0, 24.0, rows),
                         "Hs": Hs, "Tp": Tp, "beta_deg": beta * 57.3},
                        mesh=mesh, out_keys=out_keys)
                else:  # design
                    sweep_cases_full(
                        evaluate,
                        {"Hs": Hs, "Tp": Tp, "beta": beta,
                         "Cd_scale": rng.uniform(0.9, 1.1, rows)},
                        mesh=mesh, out_keys=out_keys)
                reports.append(r.done())

        if "bucketed" in kinds:
            # n rows of EVERY bundled bucket signature: the bank keys on
            # the padded inputs, so each bucket is warmed at the group
            # size a mixed sweep dispatches
            from raft_tpu_torch.parallel.sweep import sweep_heterogeneous
            from raft_tpu_torch.structure import bucketing

            by_sig = {}
            for p in BUCKET_WARMUP_DESIGNS:
                bm = _model(p)
                by_sig.setdefault(bucketing.bucket_signature(bm),
                                  []).append(bm)
            for n in sizes:
                rows = _round_up(int(n), dp)
                models_row = []
                for group in by_sig.values():
                    models_row += [group[i % len(group)]
                                   for i in range(rows)]
                total = len(models_row)
                rng = np.random.default_rng(0)
                r = ProgramReport("bucketed", rows, n_buckets=len(by_sig))
                sweep_heterogeneous(
                    models_row, rng.uniform(2.0, 8.0, total),
                    rng.uniform(6.0, 14.0, total),
                    rng.uniform(-0.5, 0.5, total), mesh=mesh,
                    out_keys=out_keys)
                reports.append(r.done())

        if "serve" in kinds:
            # the serving engine's programs: each design's bucket program
            # at every rung of the batcher's ladder (RAFT_TPU_SERVE_*,
            # not --n); engine.warm groups entries by bucket signature
            from raft_tpu_torch.serve import engine as serve_engine

            entries = []
            if designs:
                for i, path in enumerate(designs):
                    m = (model if model is not None and path == design
                         else _model(path))
                    entries.append(serve_engine.DesignEntry(
                        f"warmup{i}", m))
            else:
                entries.append(serve_engine.DesignEntry("warmup", model))
            reports += serve_engine.warm(entries, device=dev,
                                         out_keys=tuple(out_keys))
    return reports

"""The port's design-axis and case evaluators against JAX.

Fast tier: the design evaluator (``make_design_evaluator``) on the CPU
against the JAX design goldens (``golden_design_*.npz``, 8 rows of sea
state and drag / added-mass / mooring-length scales) under FUSED on and
off; rows whose mooring lengths differ, so the statics Newton runs a
different number of iterations per row; chunking; the case evaluator
(``make_case_evaluator``) against the JAX bucket goldens
(``golden_*.npz``), the gate at which the JAX package holds its own case
and bucket evaluators to each other; the sweep over models; one live
JAX design-evaluator comparison on mhk.  Slow tier: the live comparison
on spar and semi.

Every model is built by the port from ``design_*.json``.  Tolerances:
float64 outputs within 1e-10 x each key's max magnitude, ``status`` and
``n_iter_drag`` bit-equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.api import make_case_evaluator, make_design_evaluator
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.models.statics_solve import solve_equilibrium
from raft_tpu_torch.parallel.sweep import sweep_heterogeneous
from raft_tpu_torch.structure import bucketing as tb

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "torch_port")
DESIGNS = ("spar", "semi", "mhk")
DESIGN_KEYS = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
TOL = 1e-10
EXACT = ("status", "n_iter_drag", "drag_converged")

_MODELS = {}


def model(name):
    if name not in _MODELS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _MODELS[name] = Model(json.load(f))
    return _MODELS[name]


def fixture(kind, name):
    return dict(np.load(os.path.join(FIX, f"{kind}_{name}.npz")))


def hold(out, ref, tol=TOL):
    for k in tb.OUT_KEYS:
        a = out[k].cpu().numpy() if torch.is_tensor(out[k]) else out[k]
        b = ref[k]
        assert a.shape == b.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert a.dtype == b.dtype, k
            continue
        err = np.max(np.abs(a - b))
        assert err <= tol * np.max(np.abs(b)), f"{k}: {err:.3e}"


def design_rows(name, rows=None):
    g = fixture("golden_design", name)
    rows = slice(None) if rows is None else list(rows)
    return g, {k: g[k][rows] for k in DESIGN_KEYS}


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", DESIGNS)
def test_design_matches_goldens(name, fused, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    g, p = design_rows(name)
    out = make_design_evaluator(model(name), "cpu")(**p)
    hold(out, {k: g[f"{fused}_{k}"] for k in tb.OUT_KEYS})


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", DESIGNS)
def test_case_matches_bucket_goldens(name, fused, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    g = fixture("golden", name)
    out = make_case_evaluator(model(name), "cpu")(g["Hs"], g["Tp"],
                                                  g["beta"])
    hold(out, {k: g[f"{fused}_{k}"] for k in tb.OUT_KEYS})


def test_float32_policy(monkeypatch):
    """Under RAFT_TPU_DTYPE=float32 every leaf and all compute are
    float32/complex64, within the bucket path's float32 gates of the
    float64 goldens (2e-4 x max, drag_resid 1e-2), status and trip
    counts equal."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    monkeypatch.setenv("RAFT_TPU_DTYPE", "float32")
    g, p = design_rows("mhk")
    out = make_design_evaluator(model("mhk"), "cpu")(**p)
    assert out["X0"].dtype == torch.float32
    assert out["Xi"].dtype == torch.complex64
    ref = {k: g[f"on_{k}"].astype(out[k].cpu().numpy().dtype)
           for k in tb.OUT_KEYS}
    resid = out.pop("drag_resid").numpy()
    err = np.max(np.abs(resid - ref.pop("drag_resid")))
    assert err <= 1e-2 * np.max(np.abs(g["on_drag_resid"]))
    for k in ref:
        a, b = out[k].numpy(), ref[k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 2e-4 * np.max(np.abs(b)), k


def test_rows_with_different_mooring_lengths(monkeypatch):
    """Spar rows whose line lengths differ take 6, 2 and 2 statics Newton
    iterations (the short one hits the step cap); evaluated in one batch,
    each row equals its evaluation alone."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    m = model("spar")
    L_s = np.array([0.95, 1.0, 1.02])
    st = m.statics()
    ms = m.ms.to("cpu")
    ms = dataclasses.replace(ms, L=ms.L * torch.as_tensor(L_s)[:, None])
    K = torch.as_tensor(st["C_struc"] + st["C_hydro"]).expand(3, 6, 6)
    F = torch.as_tensor(st["W_struc"] + st["W_hydro"]
                        + st["f0_additional"]).expand(3, 6)
    _, _, it, _, status, _ = solve_equilibrium(m.fowtList[0], ms, K, F,
                                               torch.zeros_like(F))
    assert it.tolist() == [6, 2, 2]
    assert status.tolist() == [2, 0, 0]             # STATICS_STEP_CAPPED

    ev = make_design_evaluator(m, "cpu")
    p = dict(Hs=np.full(3, 6.0), Tp=np.full(3, 11.0), beta=np.zeros(3),
             Cd_scale=np.ones(3), Ca_scale=np.ones(3), L_moor_scale=L_s)
    batch = ev(**p)
    assert batch["status"].tolist() == [2, 0, 0]
    for i in (0, 1):
        solo = ev(**{k: v[i:i + 1] for k, v in p.items()})
        hold({k: v[i:i + 1] for k, v in batch.items()},
             {k: v.numpy() for k, v in solo.items()}, tol=1e-13)


def test_chunks_equal_one_batch(monkeypatch):
    """BUCKET_ROWS = 3 splits the 8 golden rows into chunks of 3, 3, 2
    with the same results."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    g, p = design_rows("mhk")
    monkeypatch.setenv("RAFT_TPU_BUCKET_ROWS", "3")
    marks = []
    out = make_design_evaluator(model("mhk"), "cpu")(**p, timer=marks.append)
    assert marks.count("start") == 3
    hold(out, {k: g[f"on_{k}"] for k in tb.OUT_KEYS})


def test_scalar_parameters_broadcast():
    out = make_design_evaluator(model("mhk"), "cpu")(
        [6.0, 3.0], 12.0, 0.0, Cd_scale=2.0)
    assert out["X0"].shape == (2, 6) and out["Xi"].shape == (2, 6, 40)


def test_sweep_over_models(monkeypatch):
    """sweep_heterogeneous packs each distinct model once and matches the
    bucket goldens."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    G = {n: fixture("golden", n) for n in DESIGNS}
    rows = [(n, j) for j in (0, 3, 6) for n in DESIGNS]
    out = sweep_heterogeneous([model(n) for n, _ in rows],
                              [G[n]["Hs"][j] for n, j in rows],
                              [G[n]["Tp"][j] for n, j in rows],
                              [G[n]["beta"][j] for n, j in rows],
                              device="cpu", out_keys=tb.OUT_KEYS)
    hold(out, {k: np.stack([G[n][f"on_{k}"][j] for n, j in rows])
               for k in tb.OUT_KEYS})


def _jax_design(name, rows, fused):
    """The reference: JAX's design evaluator, vmapped, float64, CPU."""
    import jax

    import raft_tpu
    from raft_tpu.api import make_design_evaluator as jmake

    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        jm = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                         f"{name}_demo.yaml"))
        _, p = design_rows(name, rows)
        out = jax.jit(jax.vmap(jmake(jm)))(p)
        return {k: np.asarray(out[k]) for k in tb.OUT_KEYS}
    finally:
        os.environ.pop("RAFT_TPU_FUSED", None)


def test_live_jax_mhk_design(monkeypatch):
    """The port against a live trace of the JAX design evaluator on mhk
    over three rows with scales below and above 1."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    rows = [1, 2, 6]
    ref = _jax_design("mhk", rows, "on")
    _, p = design_rows("mhk", rows)
    hold(make_design_evaluator(model("mhk"), "cpu")(**p), ref)


@pytest.mark.slow
@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", ["spar", "semi"])
def test_live_jax_design(name, fused, monkeypatch):
    rows = list(range(8))
    ref = _jax_design(name, rows, fused)
    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    _, p = design_rows(name, rows)
    hold(make_design_evaluator(model(name), "cpu")(**p), ref)


@pytest.mark.slow
@pytest.mark.parametrize("name", DESIGNS)
def test_doe_box_corners_are_healthy(name):
    """At the 64 corners of chip_smoke.py's design DoE box, JAX's design
    evaluator sets no status bit on any demo design, and the port agrees
    with it."""
    import itertools

    import chip_smoke

    corners = np.array(list(itertools.product(*chip_smoke.DOE_BOX.values())))
    p = {k: corners[:, i] for i, k in enumerate(chip_smoke.DOE_BOX)}
    import jax

    import raft_tpu
    from raft_tpu.api import make_design_evaluator as jmake

    jm = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                     f"{name}_demo.yaml"))
    ref = {k: np.asarray(v) for k, v in
           jax.jit(jax.vmap(jmake(jm)))(p).items()}
    assert not ref["status"].any()
    hold(make_design_evaluator(model(name), "cpu")(**p), ref)


@pytest.mark.slow
@pytest.mark.parametrize("name", DESIGNS)
def test_design_fixtures_regenerate(name):
    """Re-running the generator reproduces design_<name>.json byte for
    byte and golden_design_<name>.npz within 1e-12 (status and iteration
    counts exactly)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixtures",
        os.path.join(HERE, "make_torch_port_fixtures.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        assert f.read() == gen.design_json(name)
    gd = gen.build_design_golden(name)
    with np.load(os.path.join(FIX, f"golden_design_{name}.npz")) as z:
        assert sorted(z.files) == sorted(gd)
        for k in z.files:
            if k.split("_", 1)[-1] in EXACT or k in DESIGN_KEYS:
                np.testing.assert_array_equal(z[k], gd[k], err_msg=k)
            else:
                err = np.max(np.abs(z[k] - gd[k]))
                assert err <= 1e-12 * np.max(np.abs(gd[k])), k

"""The port's external-QTF second-order path against JAX: the WAMIT
``.12d`` reader and writer, the host force oracle, the QTF on the model
grid, the batched force of the full evaluator, the full evaluator with
its mean-drift equilibrium, and the refusals.

Fast tier (CPU):

* ``read_qtf_12d`` gives JAX's arrays bit for bit, ``write_qtf_12d``
  writes JAX's bytes;
* ``hydro_force_2nd`` and ``qtf_model_grid`` against JAX's (1e-15 x
  max), and the batched ``_hydro_force_2nd_rows`` against JAX's
  ``_hydro_force_2nd_traced`` at seeded headings inside and outside the
  QTF's span (1e-13 x max);
* the full evaluator on ``design_semi_wind_qtf.json`` (one and two
  headings, the geometry axis) and on the coarse potential-flow design
  with the same file, against the JAX goldens (``golden_semi_wind_qtf``,
  ``golden_semi_wind_bem_coarse_qtf``), FUSED on and off: every output
  key within 1e-10 x max, ``status``, ``n_iter_drag`` and
  ``drag_converged`` bit-equal;
* the forces and the drift equilibrium enter the evaluator (X0, Xi,
  F_2nd_mean, the drift stage); the refusals of the bucket,
  farm and flexible paths, none of which reads the file.

Slow tier: the second-order fixtures rebuilt from the JAX package equal
the checked-in files.
"""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.physics import secondorder as so

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
QTF_FILE = os.path.join(FIX, "semi_wind_qtf.12d")
JAX_CACHE = os.path.join(FIX, "bem_cache_jax")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
TOL = 1e-10
GRID_TOL = 1e-15
EXACT = ("status", "n_iter_drag", "drag_converged")
DESIGNS = {"semi_wind_qtf": "design_semi_wind_qtf.json",
           "semi_wind_bem_coarse_qtf": "design_semi_wind_bem_coarse_qtf.json"}

_MODELS = {}


def model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(os.path.join(FIX, DESIGNS[name]))
    return _MODELS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_{name}.npz")))


def near(a, b, tol, what=""):
    """max |a - b| <= tol x max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def hold(out, ref, pfx):
    assert sorted(out) == sorted(tapi.FULL_OUT_KEYS)
    for k in tapi.FULL_OUT_KEYS:
        a = out[k].cpu().numpy()
        b = ref[pfx + k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            near(a, b, TOL, k)


def jax_qtf():
    from raft_tpu.physics.secondorder import read_qtf_12d

    return read_qtf_12d(QTF_FILE)


@pytest.fixture(scope="module")
def bem_dir(tmp_path_factory):
    """The coefficient cache of the coarse potential-flow design (the
    JAX files beside it, which the port does not serve)."""
    d = tmp_path_factory.mktemp("bem_cache")
    for f in os.listdir(JAX_CACHE):
        shutil.copy(os.path.join(JAX_CACHE, f), d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_BEM_DIR", str(d))
        yield d


# ------------------------------------------------------------ file I/O

def test_read_qtf_12d_bit_equal_to_jax():
    got = so.read_qtf_12d(QTF_FILE)
    ref = jax_qtf()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["qtf"].shape == (40, 40, 5, 6)
    np.testing.assert_allclose(np.rad2deg(got["heads_rad"]),
                               [0, 45, 90, 135, 180])


@pytest.mark.parametrize("which", ["file", "seeded"])
def test_write_qtf_12d_writes_jax_bytes(which, tmp_path):
    """The fixture's QTF and a seeded one (two headings, 7 bins), written
    by both packages: the same bytes, and the port's reader reads back
    what JAX's reads."""
    from raft_tpu.physics.secondorder import read_qtf_12d, write_qtf_12d

    if which == "file":
        q = jax_qtf()
        args = (q["qtf"], q["w_2nd"], q["heads_rad"])
    else:
        rng = np.random.default_rng(9)
        shape = (7, 7, 2, 6)
        qtf = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        args = (qtf * 1e5, np.linspace(0.05, 1.2, 7), np.deg2rad([-15, 40]))
    for pkg, fn in (("port", so.write_qtf_12d), ("jax", write_qtf_12d)):
        fn(str(tmp_path / f"{pkg}.12d"), *args, rho=1025.0, g=9.81)
    assert ((tmp_path / "port.12d").read_bytes()
            == (tmp_path / "jax.12d").read_bytes())
    got = so.read_qtf_12d(str(tmp_path / "port.12d"))
    ref = read_qtf_12d(str(tmp_path / "jax.12d"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------- force spectrum

BETAS_DEG = (-20.0, 0.0, 17.5, 30.0, 45.0, 60.0, 95.0, 180.0, 215.0)


@pytest.mark.parametrize("beta_deg", BETAS_DEG)
def test_hydro_force_2nd_matches_jax(beta_deg):
    """The host oracle at headings on, between and outside the QTF's
    heading nodes (clipped), on the semi_wind grid."""
    from raft_tpu.physics.secondorder import hydro_force_2nd

    from raft_tpu_torch.ops.waves import jonswap

    m = model("semi_wind_qtf")
    w = torch.as_tensor(m.w)
    S = jonswap(w, torch.tensor([8.0], dtype=torch.float64),
                torch.tensor([11.0], dtype=torch.float64))[0].numpy()
    q = jax_qtf()
    fm, f = so.hydro_force_2nd(so.read_qtf_12d(QTF_FILE),
                               np.deg2rad(beta_deg), S, m.w)
    rfm, rf = hydro_force_2nd(q, np.deg2rad(beta_deg), S, m.w)
    near(fm, rfm, GRID_TOL, "f_mean")
    near(f, rf, GRID_TOL, "f")
    assert np.all(f[:, -1] == 0) and np.any(fm != 0)


def test_qtf_model_grid_matches_jax():
    from raft_tpu.api import _qtf_model_grid

    m = model("semi_wind_qtf")
    got = so.qtf_model_grid(so.read_qtf_12d(QTF_FILE), m.w)
    ref = _qtf_model_grid(jax_qtf(), m.w)
    near(got, ref, GRID_TOL, "Qm")
    assert got.shape == (5, m.nw, m.nw, 6)


@pytest.mark.parametrize("nh", [1, 3, 5])
def test_hydro_force_2nd_rows_matches_jax(nh):
    """The batched force of 6 rows x 2 headings at seeded headings over
    -40 to 220 deg (clipped on both sides with the file's first ``nh``
    heading nodes: one, 0-90 deg or 0-180 deg)
    and seeded spectra, against JAX's traced twin (vmapped) and the
    host oracle."""
    import jax

    from raft_tpu.api import _hydro_force_2nd_traced, _qtf_model_grid

    m = model("semi_wind_qtf")
    q = jax_qtf()
    if nh == 1:
        q = dict(q, qtf=q["qtf"][:, :, 1:2], heads_rad=q["heads_rad"][1:2])
    else:
        q = dict(q, qtf=q["qtf"][:, :, :nh], heads_rad=q["heads_rad"][:nh])
    rng = np.random.default_rng(41)
    beta = np.deg2rad(rng.uniform(-40.0, 220.0, (6, 2)))
    beta[0] = np.deg2rad([-40.0, 220.0])
    S = rng.uniform(0.0, 3.0, (6, 2, m.nw))
    dw = m.w[1] - m.w[0]
    qm = tapi._qtf_model_grid(q, m.w, torch.device("cpu"), torch.complex128)
    fm, f = tapi._hydro_force_2nd_rows(qm, torch.as_tensor(beta),
                                       torch.as_tensor(S), dw)
    Qm = _qtf_model_grid(q, m.w)
    one = jax.vmap(jax.vmap(lambda b, s: _hydro_force_2nd_traced(
        Qm, q["heads_rad"], b, s, dw)))
    rfm, rf = (np.asarray(x) for x in one(beta, S))
    near(fm.numpy(), rfm, 1e-13, "f_mean")
    near(f.numpy(), rf, 1e-13, "f")
    hm, h = so.hydro_force_2nd(q, beta[2, 1], S[2, 1], m.w)
    near(fm[2, 1].numpy(), hm, 1e-13, "oracle f_mean")
    near(f[2, 1].numpy(), h, 1e-13, "oracle f")


# ----------------------------------------------------------- evaluator

#: evaluator golden sets: (design, rows tag, headings, geometry)
CASES = {"h1": ("semi_wind_qtf", "h1", 1, False),
         "h2": ("semi_wind_qtf", "h2", 2, False),
         "geometry": ("semi_wind_qtf", "geo", 1, True),
         "bem_h1": ("semi_wind_bem_coarse_qtf", "h1", 1, False)}


def golden_rows(g, tag):
    return {k: g[f"{tag}_{k}"] for k in ROW_KEYS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_goldens(case, bem_dir, monkeypatch):
    """FUSED on and off; the geometry rows carry every geometry key (the
    QTF stays the design's)."""
    name, tag, nW, geometry = CASES[case]
    g = golden(name)
    ev = tapi.make_full_evaluator(model(name), nWaves=nW, device="cpu",
                                  geometry=geometry)
    kw = golden_rows(g, tag)
    if geometry:
        kw["geom"] = {k[len(tag) + 6:]: v for k, v in g.items()
                      if k.startswith(f"{tag}_geom_")}
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        hold(ev(**kw), g, f"{tag}_{fused}_")


def test_drift_and_forces_enter_the_evaluator():
    """With the QTF the mean drift is nonzero, the reported X0 is the
    drifted pose and the forces change every row's response; the timer
    gets the second-order stage after the excitation and the drift
    stage last; the design's QTF is read once, at build."""
    m = model("semi_wind_qtf")
    g = golden("semi_wind_qtf")
    kw = golden_rows(g, "h1")
    ev = tapi.make_full_evaluator(m, device="cpu")
    assert ev.stages == ("aero", "statics", "excitation",
                         tapi.SECOND_ORDER_STAGE, "fixed_point", "response",
                         tapi.DRIFT_STAGE)
    marks = []
    out = ev(timer=marks.append, **kw)
    assert marks == ["start"] + list(ev.stages)
    assert bool(torch.all(out["F_2nd_mean"].abs().amax(-1) > 0))
    first = tapi.make_full_evaluator(m, device="cpu")
    first.qtf = None
    out1 = first(**kw)
    assert bool(torch.all(out1["F_2nd_mean"] == 0))
    assert bool(torch.all((out["X0"] - out1["X0"]).abs()[:, 0] > 0))
    diff = (out["Xi"] - out1["Xi"]).abs().flatten(1).amax(1)
    assert bool(torch.all(diff > 0))
    # surge drift pushes the platform down-wave in head seas
    assert float(out["F_2nd_mean"][0, 0, 0]) > 0


def test_missing_file_means_no_qtf(tmp_path):
    """A potSecOrder 2 design whose .12d is absent runs first order, as
    in the reference; the file is read only when asked for."""
    with open(os.path.join(FIX, DESIGNS["semi_wind_qtf"])) as f:
        d = json.load(f)
    m = Model(copy.deepcopy(d), base_dir=str(tmp_path))
    assert m.qtf_path() is None and m.qtf is None
    shutil.copy(QTF_FILE, tmp_path)
    m = Model(copy.deepcopy(d), base_dir=str(tmp_path))
    assert not hasattr(m, "_qtf")
    assert m.qtf_path() == str(tmp_path / "semi_wind_qtf.12d")
    assert m.qtf["qtf"].shape == (40, 40, 5, 6)


def test_refusals_read_no_file():
    """Where the reference refuses an external QTF: the bucket, case and
    design paths (UnbucketableDesignError), the farm and flexible
    evaluators (NotImplementedError), each naming ROADMAP A13, none
    reading the .12d."""
    from raft_tpu_torch.structure import bucketing as tb

    m = Model(os.path.join(FIX, DESIGNS["semi_wind_qtf"]))
    for mk in (lambda: tb.bucket_signature(m),
               lambda: tapi.make_case_evaluator(m, device="cpu"),
               lambda: tapi.make_design_evaluator(m, device="cpu")):
        with pytest.raises(tb.UnbucketableDesignError,
                           match=r"QTF.*ROADMAP A13"):
            mk()
    assert not hasattr(m, "_qtf")
    with open(os.path.join(FIX, "design_farm_semi_wind.json")) as f:
        farm = json.load(f)
    for p in farm.get("platforms", [farm.get("platform")]):
        if p is not None:
            p.update(potSecOrder=2, hydroPath="semi_wind_qtf")
    fm = Model(farm, base_dir=FIX)
    with pytest.raises(NotImplementedError, match=r"QTF.*ROADMAP A13"):
        tapi.make_farm_evaluator(fm, device="cpu")
    assert not hasattr(fm, "_qtf")
    with open(os.path.join(FIX, "design_semi_wind_flex.json")) as f:
        flex = json.load(f)
    flex["platform"].update(potSecOrder=2, hydroPath="semi_wind_qtf")
    xm = Model(flex, base_dir=FIX)
    with pytest.raises(NotImplementedError, match=r"QTF.*ROADMAP A13"):
        tapi.make_flexible_evaluator(xm, device="cpu")
    assert not hasattr(xm, "_qtf")


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_qtf_fixtures_regenerate(tmp_path, monkeypatch):
    """The second-order designs, the .12d file and the golden files,
    rebuilt from the JAX package, equal the checked-in ones."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for name, fn in mk.QTF_DESIGNS.items():
        with open(os.path.join(FIX, mk.QTF_DESIGN_FILES[name])) as f:
            assert fn() == json.load(f), name
    monkeypatch.setattr(mk, "OUT_DIR", str(tmp_path))
    for f in mk.QTF_DESIGN_FILES.values():
        shutil.copy(os.path.join(FIX, f), tmp_path)
    mk.write_qtf_12d_fixture()
    assert (tmp_path / "semi_wind_qtf.12d").read_bytes() == open(
        QTF_FILE, "rb").read()
    shutil.copy(os.path.join(FIX, "golden_full_semi_wind.npz"), tmp_path)
    news = {"qtf_slender": mk.build_slender_golden()}
    monkeypatch.setenv("RAFT_TPU_BEM_DIR", str(tmp_path / "bem"))
    for name in DESIGNS:
        news[name] = mk.build_qtf_golden(name)
    for name, new in news.items():
        old = golden(name)
        assert sorted(new) == sorted(old), name
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)

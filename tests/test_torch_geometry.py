"""The port's geometry design axis against JAX.

Fast tier: the batched member inertia elements
(``raft_tpu_torch.structure.members_traced``) against the JAX package's
``members_traced`` on every member of the five designs; ``apply_geometry``
and the batched ``calc_statics`` at unit scales against the builder; the
MacCamy-Fuchs tables in torch against numpy; the geometry rows of
``make_full_evaluator(geometry=True)`` against the JAX goldens
(``golden_geometry_*.npz``: 8 rows per design with every geometry key
drawn over its range), every output key within 1e-10 x its max,
``status``, ``n_iter_drag`` and ``drag_converged`` bit-equal, FUSED on
and off; unit scales against the plain full evaluator within 1e-12 x
max; precomputed ``geom_const``; the refusals.  Slow tier: the live JAX
geometry evaluator and the regeneration of the geometry goldens.

Every model is built by the port from ``design_*.json``.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.structure import members_traced as jmt
from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.physics import morison
from raft_tpu_torch.physics.statics import calc_statics
from raft_tpu_torch.structure import members_traced as tmt

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
SETS = {"semi_wind": 1, "mhk_tidal": 2, "spar": 2, "semi": 2, "mhk": 2}
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
TOL = 1e-10
EXACT = ("status", "n_iter_drag", "drag_converged")

_MODELS, _EVS = {}, {}


def design(name):
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        return json.load(f)


def model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(design(name))
    return _MODELS[name]


def evaluator(name, geometry=True):
    if (name, geometry) not in _EVS:
        _EVS[name, geometry] = tapi.make_full_evaluator(
            model(name), nWaves=SETS[name], device="cpu", geometry=geometry)
    return _EVS[name, geometry]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_geometry_{name}.npz")))


def rows_of(g, n=None):
    return {k: g[k][:n] for k in ROW_KEYS}


def geom_of(g, n=None):
    return {k[5:]: g[k][:n] for k in g if k.startswith("geom_")}


def hold(out, ref, pfx, tol=TOL):
    for k in tapi.FULL_OUT_KEYS:
        a = out[k].detach().cpu().numpy()
        b = ref[pfx + k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("name", sorted(SETS))
def test_inertia_elements_match_jax(name):
    """Every member's elements at two rows of random scales against the
    JAX package's members_traced, called on the same member geometry."""
    rng = np.random.default_rng(7)
    for mem in model(name).fowtList[0].members:
        n = len(mem.stations)
        sc = rng.uniform(0.85, 1.15, (2, 4))
        d = np.asarray(mem.d) * sc[:, 0, None, None]
        t = np.asarray(mem.t) * sc[:, 1, None]
        lf = np.asarray(mem.l_fill) * sc[:, 2, None]
        rf = np.asarray(mem.rho_fill) * sc[:, 3, None]
        got = tmt.traced_inertia_elements(
            mem, *(torch.as_tensor(a) for a in (d, t, lf, rf)))
        for r in range(2):
            ref = jmt.traced_inertia_elements(
                mem, jnp.asarray(d[r]), jnp.asarray(t[r]),
                jnp.asarray(lf[r]), jnp.asarray(rf[r]))
            for a, b in zip(got, ref):
                b = np.asarray(b)
                assert a[r].shape == b.shape, (mem.name, n)
                np.testing.assert_allclose(a[r].numpy(), b, rtol=1e-13,
                                           atol=1e-13 * np.max(np.abs(b)))


@pytest.mark.parametrize("name", sorted(SETS))
def test_unit_scales_reproduce_the_builder(name):
    """apply_geometry at unit scales gives the builder's inertia elements
    and strips, and the batched calc_statics at R = 2 gives the
    build-time statics on both rows."""
    m = model(name)
    fs = m.fowtList[0]
    ss = m.hydro[0].strips
    fs2, ss2 = tmt.apply_geometry(fs, ss, {}, 2, k=m.k)
    for mem, mem2 in zip(fs.members, fs2.members):
        for k in ("elem_mass", "elem_s", "elem_Ixx", "elem_Iyy", "elem_Izz"):
            b = np.asarray(getattr(mem, k))
            for r in range(2):
                np.testing.assert_allclose(
                    getattr(mem2, k)[r].numpy(), b, rtol=1e-13,
                    atol=1e-13 * max(np.max(np.abs(b)), 1.0), err_msg=k)
        np.testing.assert_allclose(float(mem2.mshell[0]), mem.mshell,
                                   rtol=1e-13)
    for k in ("ds", "drs", "Cd_q", "Cd_End", "Ca_p1", "Ca_End"):
        np.testing.assert_array_equal(getattr(ss2, k)[1].numpy(),
                                      getattr(ss, k), err_msg=k)
    np.testing.assert_array_equal(ss2.Cm_p1_w[0].numpy(), ss.Cm_p1_w)
    st = calc_statics(fs2, rows=2)
    ref = m.statics()
    for k in ("M_struc", "C_struc", "C_hydro", "W_struc", "W_hydro",
              "f0_additional", "rCG", "rCB", "V", "m"):
        b = np.asarray(ref[k])
        for r in range(2):
            np.testing.assert_allclose(
                st[k][r].numpy(), b, rtol=1e-12,
                atol=1e-12 * max(float(np.max(np.abs(b))), 1.0), err_msg=k)


def test_mcf_tables_in_torch_match_numpy():
    """mcf_cm / mcf_blend on tensors (the geometry axis' MacCamy-Fuchs
    re-evaluation) equal the numpy build path's."""
    kR = np.concatenate([[0.0, 1e-3, np.pi / 5], np.linspace(0.01, 90.0, 97)])
    a1, a2 = morison.mcf_blend(torch.as_tensor(kR), 1.6, 1.8)
    b1, b2 = morison.mcf_blend(kR, 1.6, 1.8)
    np.testing.assert_allclose(a1.numpy(), b1, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(a2.numpy(), b2, rtol=1e-15, atol=1e-15)


def test_mcf_member_strips_reproduce_the_builder():
    """A MacCamy-Fuchs member at unit scales: the re-evaluated Cm tables
    equal the builder's baked ones; at d_scale 1.1 they equal the
    builder's tables of the scaled design."""
    d = design("spar")
    d["platform"]["members"][0]["MCF"] = True
    m = Model(d)
    fs, ss = m.fowtList[0], m.hydro[0].strips
    assert ss.mcf.any()
    _, ss2 = tmt.apply_geometry(fs, ss, {}, 1, k=m.k)
    np.testing.assert_allclose(ss2.Cm_p1_w[0].numpy(), ss.Cm_p1_w,
                               rtol=1e-14, atol=1e-14)
    d2 = json.loads(json.dumps(d))
    mem = d2["platform"]["members"][0]
    mem["d"] = (np.asarray(mem["d"], dtype=float) * 1.1).tolist()
    ss_scaled = Model(d2).hydro[0].strips
    _, ss3 = tmt.apply_geometry(fs, ss, {"d_scale": 1.1}, 1, k=m.k)
    np.testing.assert_allclose(ss3.Cm_p2_w[0].numpy(), ss_scaled.Cm_p2_w,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(SETS))
def test_geometry_rows_match_goldens(name, monkeypatch):
    """FUSED on and off.  With two wave headings the response is the
    staged one under either flag (the goldens agree), so one evaluation
    is held against both."""
    g = golden(name)
    for fused in ("on", "off") if SETS[name] == 1 else ("on",):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        out = evaluator(name)(geom=geom_of(g), **rows_of(g))
        hold(out, g, f"{fused}_")
        if SETS[name] > 1:
            hold(out, g, "off_")


@pytest.mark.parametrize("name", ["semi_wind", "mhk_tidal", "spar"])
def test_unit_scales_match_the_plain_evaluator(name):
    """Geometry rows at unit scales (the statics and hydro constants
    recomputed per row) against the plain full evaluator's rows (the
    builder's): every key within 1e-12 x max, status equal."""
    g = dict(np.load(os.path.join(FIX, f"golden_full_{name}.npz")))
    rows = rows_of(g, 4)
    ref = evaluator(name, geometry=False)(**rows)
    out = evaluator(name)(geom={}, **rows)
    hold(out, {k: v.numpy() for k, v in ref.items()}, "", tol=1e-12)


def test_precomputed_geometry_constants():
    """geom_const of one row serves every row, and of R rows equals
    passing geom; the timer sees the geometry stage first."""
    g = golden("spar")
    ev = evaluator("spar")
    geom = geom_of(g, 3)
    rows = rows_of(g, 3)
    marks = []
    out = ev(geom=geom, timer=marks.append, **rows)
    assert marks == ["start"] + list(tapi.GEOMETRY_STAGES)
    gc = ev.geometry_constants(geom)
    hold(ev(geom_const=gc, **rows), {k: v.numpy() for k, v in out.items()},
         "", tol=0.0)
    one = ev.geometry_constants({k: v[:1] for k, v in geom.items()})
    both = ev(geom_const=one, **rows_of(g, 2))
    ref = ev(geom={k: np.repeat(v[:1], 2, axis=0) for k, v in geom.items()},
             **rows_of(g, 2))
    hold(both, {k: v.numpy() for k, v in ref.items()}, "", tol=0.0)


def test_refusals(tmp_path, monkeypatch):
    """geom needs geometry=True; unknown keys raise; a potential-flow
    design builds, and its geometry axis refuses a d_scale that differs
    between members; one that requires grad (refused before the d_scale
    gradient was ported) gives at 1 the design's own response and a
    finite, nonzero gradient (the interpolation's derivative)."""
    with pytest.raises(TypeError):
        evaluator("spar", geometry=False)(geom={"d_scale": 1.0}, Hs=6, Tp=12)
    with pytest.raises(TypeError):
        evaluator("spar")(geom={"diameter": 1.0}, Hs=6, Tp=12)
    d = design("spar")
    d["platform"]["potModMaster"] = 2      # every member potential flow
    # a small mesh at three BEM frequencies
    d["settings"].update(nAz_BEM=6, dz_BEM=12.0, dw_BEM=0.4, wMax_BEM=1.2)
    monkeypatch.setenv("RAFT_TPU_BEM_DIR", str(tmp_path))
    geo = tapi.make_full_evaluator(Model(d, base_dir=str(tmp_path)),
                                   device="cpu", geometry=True)
    assert geo.bem is not None
    ds = np.ones((1, geo.n_members))
    ds[0, -1] = 1.05
    with pytest.raises(ValueError, match="uniform d_scale"):
        geo(geom={"d_scale": ds}, Hs=6, Tp=12)
    s = torch.ones(1, dtype=torch.float64, requires_grad=True)
    out = geo(geom={"d_scale": s}, Hs=6, Tp=12)
    ref = geo(geom={"d_scale": 1.0}, Hs=6, Tp=12)
    for k in ("X0", "Xi"):
        assert torch.equal(out[k].detach(), ref[k]), k
    g, = torch.autograd.grad((out["Xi"][:, 0].abs() ** 2).sum(), s)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", ["spar", "semi_wind"])
def test_geometry_rows_match_live_jax(name):
    """The live JAX geometry evaluator on the golden rows."""
    import jax

    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    g = golden(name)
    _, ev = mk._geometry_evaluator(name)
    ref = jax.jit(jax.vmap(ev))(dict(rows_of(g), geom=geom_of(g)))
    hold(evaluator(name)(geom=geom_of(g), **rows_of(g)),
         {k: np.asarray(v) for k, v in ref.items()}, "")


@pytest.mark.slow
def test_geometry_fixtures_regenerate():
    """Every geometry golden, rebuilt from the JAX package, equals the
    checked-in file."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for name in SETS:
        new = mk.build_geometry_golden(name)
        old = golden(name)
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)

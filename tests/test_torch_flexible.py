"""The port's flexible (N-DOF beam) path against JAX.

Two designs with a steel beam tower (``tests/make_torch_port_fixtures.py``):
``spar_flex`` (nDOF 108 over 22 nodes, aero off) and ``semi_wind_flex``
(nDOF 168 over 38 nodes, the 15 MW-class rotor).  Build-time pieces
against the JAX functions on the same inputs within 1e-12 x max: the
beam member fields, the FE matrices, the topology (T, its derivative,
displacements and the one-lag self-consistent pose), the general statics
at the reference pose and at a displaced one, the zero-pose hydro
constants, the batched ``TracedTopology`` at 4 seeded rows, the strip
frames of a displaced pose and the N-DOF drag linearisation at n = 108.

Then ``make_flexible_evaluator`` against the JAX goldens
(``golden_flex_*.npz``), the geometry axis on three host-rebuilt tower
designs, and the refusals.  ``status``, ``n_iter_drag`` and
``drag_converged`` are bit-equal.  The keys downstream of the N = 108-168
solves (``torch.linalg.solve`` here, ``jnp.linalg.solve`` in the
reference: pivoted LU of two libraries) are held at the rounding those
solves are entitled to: X0 at kappa(K) eps (the statics stiffness,
:data:`X0_GATE`), Xi, PSD and drag_resid at kappa(Z) eps
(:data:`SOLVE_GATE`); :func:`test_solve_gap_is_library_rounding` and
:func:`test_statics_gap_is_library_rounding` show the gaps are that
rounding.  S and zeta are held at 1e-10 x their max.  Slow tier: the
flexible fixtures regenerated by the live JAX evaluator.
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
SETS = {"spar": 2, "semi_wind": 1}
BUILD_TOL = 1e-12
TOL = 1e-10
#: the largest 2-norm condition number of the response impedance Z
#: (nw, n, n) over the golden rows of both sets (2.58e10 spar_flex,
#: 2.71e10 semi_wind_flex, measured by torch.linalg.cond on the CPU)
KAPPA_Z = 2.72e10
#: the largest 2-norm condition number of the statics stiffness
#: K_h + C_elast + C_moor at the golden equilibria (1.13e9 spar_flex,
#: 2.71e9 semi_wind_flex, 2.79e9 its geometry designs)
KAPPA_K = 2.80e9
EPS = float(np.finfo(np.float64).eps)
#: the gate of the keys that pass the response solves: kappa(Z) eps
SOLVE_GATE = KAPPA_Z * EPS
SOLVE_KEYS = ("Xi", "PSD", "drag_resid")
#: the gate of X0, the statics Newton's solves: kappa(K) eps
X0_GATE = KAPPA_K * EPS
EXACT = ("status", "n_iter_drag", "drag_converged")
#: (tower d scale, tower t scale) of the geometry goldens, as written
GEOMETRY_SCALES = ((0.9, 1.1), (1.1, 0.9), (1.05, 0.95))

_MODELS, _JMODELS, _EVS = {}, {}, {}


def design(name, d_scale=1.0, t_scale=1.0):
    with open(os.path.join(FIX, f"design_{name}_flex.json")) as f:
        d = json.load(f)
    tw = d["turbine"]["tower"]
    tw["d"] = [x * d_scale for x in tw["d"]]
    tw["t"] = [x * t_scale for x in tw["t"]]
    return d


def model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(design(name))
    return _MODELS[name]


def jmodel(name):
    import raft_tpu

    if name not in _JMODELS:
        _JMODELS[name] = raft_tpu.Model(design(name))
    return _JMODELS[name]


def evaluator(name, geometry=False):
    key = (name, geometry)
    if key not in _EVS:
        _EVS[key] = tapi.make_flexible_evaluator(
            model(name), nWaves=SETS[name], device="cpu", geometry=geometry)
    return _EVS[key]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_{name}.npz")))


def rows_of(g):
    return {k: g[k] for k in tapi.ENV_KEYS + tapi.SEA_KEYS if k in g}


def close(a, b, tol=BUILD_TOL, what=""):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    err = float(np.max(np.abs(a - b))) if b.size else 0.0
    assert err <= tol * max(scale, 1e-300), \
        f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def hold(out, ref, x0_tol=X0_GATE):
    assert sorted(out) == sorted(tapi.FLEX_OUT_KEYS)
    for k in tapi.FLEX_OUT_KEYS:
        a = out[k].cpu().numpy()
        b = ref["on_" + k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        tol = SOLVE_GATE if k in SOLVE_KEYS else x0_tol if k == "X0" else TOL
        close(a, b, tol, k)


# ----------------------------------------------------------- build time

NAMES = ("spar", "semi_wind")


@pytest.mark.parametrize("name", NAMES)
def test_beam_member_matches_jax(name):
    """The beam tower's every field against JAX's build_member."""
    from raft_tpu.structure.members import build_member as jbuild

    from raft_tpu_torch.structure.members import build_member

    mi = design(name)["turbine"]["tower"]
    mem = build_member(copy.deepcopy(mi), part_of="tower")
    jmem = jbuild(copy.deepcopy(mi), part_of="tower")
    assert mem.mtype == "beam" and (mem.E, mem.G) == (200.0e9, 79.3e9)
    for f in dataclasses.fields(jmem):
        a, b = getattr(mem, f.name), getattr(jmem, f.name)
        if isinstance(b, np.ndarray):
            close(a, b, what=f.name)
        elif isinstance(b, list):
            close(np.asarray(a, float), np.asarray(b, float), what=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", NAMES)
def test_fe_matrices_match_jax(name):
    """fe_stiffness, fe_inertia and mass_and_center of the tower at its
    reference nodes and at displaced ones."""
    from raft_tpu.physics import beams as jbeams

    from raft_tpu_torch.physics import beams

    fs = model(name).fowtList[0]
    jfs = jmodel(name).fowtList[0]
    im = [m.mtype for m in fs.members].index("beam")
    mem, jmem = fs.members[im], jfs.members[im]
    n0 = int(fs.member_node[im])
    r = fs.node_r0[n0:n0 + mem.ns]
    rng = np.random.default_rng(3)
    for node_r in (r, r + 0.05 * rng.standard_normal(r.shape)):
        K, M = beams.fe_stiffness(mem, node_r), beams.fe_inertia(mem, node_r)
        close(K, jbeams.fe_stiffness(jmem, node_r), what="K")
        close(M, jbeams.fe_inertia(jmem, node_r), what="M")
        m, c = beams.mass_and_center(M, node_r)
        jm_, jc = jbeams.mass_and_center(M, node_r)
        close(m, jm_, what="mass")
        close(c, jc, what="center")
        assert np.allclose(K, K.T, rtol=0, atol=1e-6 * np.abs(K).max())


@pytest.mark.parametrize("name", NAMES)
def test_topology_matches_jax(name):
    """The reduction (T, its derivative, the DOF list, the node map),
    the nonlinear displacements and the one-lag and iterated
    self-consistent poses against the JAX topology."""
    fs = model(name).fowtList[0]
    jfs = jmodel(name).fowtList[0]
    assert fs.nDOF == {"spar": 108, "semi_wind": 168}[name]
    assert fs.n_nodes == {"spar": 22, "semi_wind": 38}[name]
    assert not fs.is_single_body and fs.reducedDOF == jfs.reducedDOF
    assert fs.root_id == jfs.root_id
    for k in ("T", "dT", "node_r0", "member_node", "rotor_node"):
        close(getattr(fs, k), getattr(jfs, k), what=k)
    rng = np.random.default_rng(5)
    Xi0 = 0.02 * rng.standard_normal(fs.nDOF)
    close(fs.topology.displacements(fs.T, fs.reducedDOF, fs.root_id, Xi0),
          jfs.topology.displacements(jfs.T, jfs.reducedDOF, jfs.root_id,
                                     Xi0), what="displacements")
    for n_iter in (1, 3):
        d, T = fs.topology.self_consistent_displacements(
            fs.T, fs.reducedDOF, fs.root_id, Xi0, n_iter=n_iter)
        jd, jT = jfs.topology.self_consistent_displacements(
            jfs.T, jfs.reducedDOF, jfs.root_id, Xi0, n_iter=n_iter)
        close(d, jd, what=f"disp {n_iter}")
        close(T, jT, what=f"T {n_iter}")
    # the traversal state is the reference pose's again
    T, _, _ = fs.topology.reduce()
    close(T, fs.T, what="restored")


STATICS_KEYS = ("M_struc", "M_struc_sub", "C_struc", "C_struc_sub",
                "C_hydro", "C_elast", "W_struc", "W_hydro", "f0_additional",
                "rCG", "rCG_sub", "rCB", "m", "m_sub", "V", "AWP", "rM",
                "M_all6", "M_sub6", "m_ballast", "r_nodes")


@pytest.mark.parametrize("name,pose", [(n, p) for n in NAMES
                                       for p in ("zero", "displaced")])
def test_statics_general_matches_jax(name, pose):
    """calc_statics_general at the reference pose (Model.statics) and at
    golden row 0's equilibrium against the JAX function."""
    from raft_tpu.physics.statics_general import calc_statics_general

    m = model(name)
    jfs = jmodel(name).fowtList[0]
    X = None if pose == "zero" else golden(f"flex_{name}")["on_X0"][0]
    st = m.statics(Xi0=X)
    jst = calc_statics_general(jfs, Xi0=X)
    for k in STATICS_KEYS:
        close(st[k], jst[k], what=k)
    assert st["pb"] == jst["pb"]
    for a, b in zip(st["mtower"], jst["mtower"]):
        close(a, b, what="mtower")


@pytest.mark.parametrize("name", NAMES)
def test_zero_pose_hydro_matches_jax(name):
    hc = model(name).hydro[0].hc0
    jhc = jmodel(name).hydro[0].hc0
    for k in ("A_hydro", "Amat", "Imat", "a_i", "r", "q", "p1", "p2"):
        close(hc[k], jhc[k], what=k)
    ss, jss = model(name).hydro[0].strips, jmodel(name).hydro[0].strips
    for k in ("node", "mnode0", "ls", "ds", "Cm_p1_w"):
        close(getattr(ss, k), getattr(jss, k), what=k)


@pytest.mark.parametrize("name", NAMES)
def test_traced_topology_matches_jax(name):
    """TracedTopology.kinematics at 4 seeded rows against the JAX traced
    topology row by row and against the numpy topology."""
    from raft_tpu.structure.topology_traced import TracedTopology as JTT

    from raft_tpu_torch.structure.topology_traced import TracedTopology

    fs = model(name).fowtList[0]
    jtt = JTT(jmodel(name).fowtList[0])
    tt = TracedTopology(fs)
    rng = np.random.default_rng(7)
    Xi0 = 0.05 * rng.standard_normal((4, fs.nDOF))
    r, rot, Tn = tt.kinematics(torch.as_tensor(Xi0))
    assert r.shape == (4, fs.n_nodes, 3) and rot.shape == (4, fs.n_nodes, 3)
    assert Tn.shape == (4, fs.n_nodes, 6, fs.nDOF)
    for i in range(4):
        jr, jrot, jTn = jtt.kinematics(Xi0[i])
        close(r[i], jr, what="r_nodes")
        close(rot[i], jrot, what="node_rot")
        close(Tn[i], jTn, what="Tn")
        disp = fs.topology.displacements(fs.T, fs.reducedDOF, fs.root_id,
                                         Xi0[i])
        T, _, _ = fs.topology.reduce(positions=fs.node_r0 + disp[:, :3])
        fs.topology.reduce()
        close(Tn[i].reshape(-1, fs.nDOF), T, what="numpy T")


def _jax_hydro_at(name, X0, case):
    """JAX FOWTHydro at pose X0 with case's sea state: (hc, u, Tn,
    r_nodes, node_rot) as numpy."""
    jfh = jmodel(name).hydro[0]
    jfh.set_position(X0)
    jfh.hydro_excitation(case)
    out = ({k: np.asarray(v) for k, v in jfh.hc.items()},
           np.asarray(jfh.u), np.asarray(jfh.Tn), np.asarray(jfh.r_nodes),
           np.asarray(jfh._node_rot))
    jfh.set_position(np.zeros(X0.shape))
    return out


def test_strip_frames_and_drag_lin_iter_n108_match_jax():
    """At spar_flex's golden row 0 equilibrium: the strip frames of the
    displaced pose (members rotated with their first node), and one
    N-DOF drag linearisation (n = 108, the general node reduction) at a
    seeded response, against JAX's."""
    from raft_tpu.physics import morison as jmor

    from raft_tpu_torch.models.hydro import site_rows
    from raft_tpu_torch.physics import morison

    name = "spar"
    fs, m = model(name).fowtList[0], model(name)
    jfs = jmodel(name).fowtList[0]
    X0 = golden("flex_spar")["on_X0"][0]
    case = dict(wave_heading=30.0, wave_spectrum="JONSWAP", wave_period=10.0,
                wave_height=4.0)
    hc, u, Tn, r_nodes, node_rot = _jax_hydro_at(name, X0, case)
    assert fs.nDOF == 108 and np.any(node_rot)

    t = lambda a: torch.as_tensor(np.array(a))[None]        # noqa: E731
    ss = morison.strips_to_rows(m.hydro[0].strips, "cpu")
    r, q, p1, p2 = morison.strip_frames(ss, None, t(r_nodes),
                                        node_rot=t(node_rot))
    for k, v in (("r", r), ("q", q), ("p1", p1), ("p2", p2)):
        close(v[0], hc[k], what=k)

    rng = np.random.default_rng(9)
    w = np.asarray(m.w)
    Xi = 0.1 * (rng.standard_normal((fs.nDOF, len(w)))
                + 1j * rng.standard_normal((fs.nDOF, len(w))))
    jss = jmodel(name).hydro[0].strips
    jout = jmor.drag_lin_iter(jmor.drag_lin_precompute(
        jfs, jss, hc, u[0], Tn, r_nodes, w), Xi)
    thc = {k: t(v) for k, v in hc.items()}
    pre = morison.drag_lin_precompute(site_rows(fs, "cpu"), ss, thc, t(u[0]),
                                      t(Tn), t(r_nodes), torch.as_tensor(w))
    assert "Gq" not in pre and "H" in pre
    out = morison.drag_lin_iter(pre, t(Xi))
    for k in ("B_hydro_drag", "Bmat", "F_hydro_drag"):
        close(out[k][0], jout[k], what=k)


# ------------------------------------------------------------ evaluator

@pytest.mark.parametrize("name", NAMES)
def test_flexible_evaluator_matches_goldens(name):
    g = golden(f"flex_{name}")
    hold(evaluator(name)(**rows_of(g)), g)


def test_goldens_cover_the_status_bits():
    """semi_wind_flex's rows hold INPUT_CLIPPED (wind 0.05) and
    STATICS_STEP_CAPPED (rated wind with current) rows, and 0s."""
    from raft_tpu_torch.utils import health

    st = golden("flex_semi_wind")["on_status"]
    assert (st == 0).any()
    assert health.any_bit(st, health.INPUT_CLIPPED).any()
    assert health.any_bit(st, health.STATICS_STEP_CAPPED).any()


def test_solve_gap_is_library_rounding(monkeypatch):
    """The keys past the N-DOF solves miss 1e-10 on spar_flex because the
    two libraries' pivoted LU round differently: kappa(Z) stays under
    KAPPA_Z, the gap is far inside kappa(Z) eps, and one step of
    iterative refinement of the port's own response moves it by a
    figure of the same order as the gap (the solve's own rounding).

    The gap itself depends on the host's LAPACK: the same goldens gave
    4.9e-9 and 6.8e-9 of max|Xi| on two x86 hosts (MKL's blocking and
    vector width choose the rounding of the N = 108 LU).  So the gap is
    held at 1e-2 x SOLVE_GATE, a hundred times inside the gate every
    other flexible key is held at, and the argument that it is rounding
    rests on the comparison with the port's own refinement step."""
    from raft_tpu_torch.models import dynamics

    seen = {}
    real = dynamics.system_response

    def spy(Z, F):
        seen["Z"], seen["F"] = Z, F
        return real(Z, F)

    monkeypatch.setattr(dynamics, "system_response", spy)
    g = golden("flex_spar")
    out = evaluator("spar")(**rows_of(g))
    Z, F = seen["Z"], seen["F"].transpose(-1, -2)
    kappa = torch.linalg.cond(Z)
    assert float(kappa.max()) <= KAPPA_Z
    x = torch.linalg.solve(Z, F[..., None])
    x1 = x + torch.linalg.solve(Z, F[..., None] - Z @ x)
    scale = float(x.abs().max())
    own = float((x1 - x).abs().max()) / scale
    gap = float(np.max(np.abs(out["Xi"].numpy() - g["on_Xi"]))) / scale
    assert gap <= 1e-2 * SOLVE_GATE, (gap, SOLVE_GATE)
    assert gap <= 10 * own, (gap, own)


def _geometry_sp():
    """(golden, per-design struct_params, the rows' design keys)."""
    g = golden("flex_geometry_semi_wind")
    sps = {s: tapi.flexible_struct_params(Model(design("semi_wind", *s)))
           for s in GEOMETRY_SCALES}
    keys = list(zip(g["d_scale"].tolist(), g["t_scale"].tolist()))
    return g, sps, keys


def test_flexible_geometry_matches_goldens():
    """The geometry axis: each row's struct_params from the host rebuild
    of its scaled tower, stacked per row, against the JAX goldens."""
    g, sps, keys = _geometry_sp()
    assert sorted(set(keys)) == sorted(GEOMETRY_SCALES)

    def per_row(trees):
        if isinstance(trees[0], dict):
            return {k: per_row([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    sp = per_row([sps[k] for k in keys])
    out = evaluator("semi_wind", geometry=True)(struct_params=sp,
                                                **rows_of(g))
    hold(out, g)
    # one design for every row takes the unstacked parameters
    one = evaluator("semi_wind", geometry=True)(
        struct_params=sps[keys[0]], **{k: v[:3] for k, v in rows_of(g).items()})
    for k in ("X0", "Xi", "status"):
        close(one[k].numpy(), out[k][:3].numpy(), tol=0.0, what=k)


def test_statics_gap_is_library_rounding():
    """X0 misses 1e-10 on the geometry design (1.1, 0.9) because the two
    libraries' LU round differently in the Newton steps: kappa(K) stays
    under KAPPA_K, the gap is far inside kappa(K) eps, and one solve of
    K at that pose (b = K X0) is off by a figure of the same order."""
    from raft_tpu_torch.models.statics_solve import single_ms_closures

    g, sps, keys = _geometry_sp()
    sel = np.asarray([k == (1.1, 0.9) for k in keys])
    rows = {k: v[sel] for k, v in rows_of(g).items()}
    sp = sps[(1.1, 0.9)]
    out = evaluator("semi_wind", geometry=True)(struct_params=sp, **rows)
    X0 = out["X0"]
    ms = dataclasses.replace(model("semi_wind").ms.to("cpu"),
                             **{k: torch.as_tensor(v)
                                for k, v in sp["ms"].items()})
    _, C = single_ms_closures(ms, X0.shape[1])(X0)
    K = torch.as_tensor(sp["K_h"] + sp["C_elast"]) + C
    assert float(torch.linalg.cond(K).max()) <= KAPPA_K
    x = torch.linalg.solve(K, (K @ X0[..., None]))[..., 0]
    scale = float(X0.abs().max())
    own = float((x - X0).abs().max()) / scale
    gap = float(np.max(np.abs(X0.numpy() - g["on_X0"][sel]))) / scale
    assert gap <= 1e-3 * X0_GATE
    assert gap <= 10 * own, (gap, own)


def test_struct_params_of_the_model_reproduce_the_model():
    """The model's own struct_params through the geometry axis give the
    evaluator's own outputs, bit for bit."""
    g = golden("flex_semi_wind")
    rows = {k: v[:2] for k, v in rows_of(g).items()}
    a = evaluator("semi_wind")(**rows)
    b = evaluator("semi_wind", geometry=True)(
        struct_params=tapi.flexible_struct_params(model("semi_wind")), **rows)
    for k in tapi.FLEX_OUT_KEYS:
        assert torch.equal(a[k], b[k]), k


def test_flexible_refusals(monkeypatch):
    """A rigid model, an array, struct_params without the geometry axis
    and no CUDA without device="cpu" each raise; an input that requires
    grad (refused until the flexible reverse mode was ported) gives a
    finite gradient."""
    from raft_tpu_torch.models.model import Model as M

    with open(os.path.join(FIX, "design_spar.json")) as f:
        rigid = M(json.load(f))
    with pytest.raises(ValueError, match="make_full_evaluator"):
        tapi.make_flexible_evaluator(rigid, device="cpu")
    ev = evaluator("spar")
    with pytest.raises(TypeError, match="geometry=True"):
        ev(Hs=2.0, Tp=8.0, struct_params={})
    Hs = torch.tensor([[2.0, 1.0]], dtype=torch.float64, requires_grad=True)
    out = ev(Hs=Hs, Tp=8.0)
    g, = torch.autograd.grad((out["Xi"][:, 0].abs() ** 2).sum(), Hs)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tapi.make_flexible_evaluator(model("spar"))


def test_flex_rows_chunk_alike(monkeypatch):
    """Chunks of 3 rows give the outputs of one chunk of all rows."""
    g = golden("flex_spar")
    rows = rows_of(g)
    whole = evaluator("spar")(**rows)
    monkeypatch.setattr(tapi, "FLEX_ROWS", 4)
    parts = evaluator("spar")(**rows)
    for k in tapi.FLEX_OUT_KEYS:
        assert torch.equal(whole[k], parts[k]), k


@pytest.mark.slow
def test_flex_fixtures_regenerate():
    """Every flexible fixture, rebuilt from the JAX package, equals the
    checked-in file (designs as dicts, goldens array for array)."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for name, fn in mk.FLEX_DESIGNS.items():
        assert fn() == design(name), name
        old = golden(f"flex_{name}")
        new = dict(mk.flex_rows(name))
        new.update({f"on_{k}": v for k, v in mk.golden_flex(name).items()})
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    new, old = mk.golden_flex_geometry(), golden("flex_geometry_semi_wind")
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)

"""Reverse-mode gradients of the port against JAX.

Fast tier:

* the solve's ``torch.autograd.Function``: ``gradcheck`` in float64 on
  the CPU and its backward against ``torch.linalg.solve``'s, both paths
  (the plain elimination and, above N = 12, LAPACK);
* each implicit backward against a forward-mode oracle (a directional
  derivative against a random cotangent): the catenary (loads attached
  at the root) against ``torch.func.jvp`` through the whole Newton loop,
  the statics (``_StaticsRoot``) against ``torch.func.jvp`` of one
  Newton step from the root (the catenary loop taped in forward mode),
  the drag fixed point (10 Neumann steps on one
  graph) against ``torch.func.jvp`` of the reference's forward rule (10
  Neumann steps of jvps);
* end to end against the JAX goldens: the metric sum |Xi[0]|^2 + sum
  X0^2 (``tests/test_design_sweep.py``'s) and its gradient with respect
  to every geometry key (``golden_grad_*.npz``: spar, semi, semi_wind,
  4 rows each) and to the six design-evaluator inputs
  (``golden_grad_design_*.npz``: the three demos), FUSED on and off,
  within 1e-9 x each key's max|g|; the adjoint solves per chunk;
* one central difference of the port's own forward (eps 1e-4, rel 2e-3,
  as ``tests/test_design_sweep.py``);
* an aero input that requires grad gives a finite gradient (the aero
  paths' goldens: ``tests/test_torch_grad_aero.py``); without an input
  that requires grad the evaluators run under ``no_grad``.

Slow tier: the regeneration of the gradient goldens through jax.grad.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models import dynamics
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.models.statics_solve import (make_tolerances,
                                                 single_ms_closures,
                                                 solve_equilibrium_general)
from raft_tpu_torch.ops import linsolve
from raft_tpu_torch.physics import mooring, morison
from raft_tpu_torch.structure import bucketing as tb

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
GRAD_SETS = {"spar": 2, "semi": 2, "semi_wind": 1}
DESIGN_KEYS = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
TOL = 1e-9

_MODELS = {}


def model(name):
    if name not in _MODELS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _MODELS[name] = Model(json.load(f))
    return _MODELS[name]


def metric(out):
    """sum |Xi[0]|^2 + sum X0^2 per row."""
    return (out["Xi"][:, 0].abs() ** 2).flatten(1).sum(-1) \
        + (out["X0"] ** 2).sum(-1)


def hold_grads(val, grads, g, pfx, tol=TOL, metric_tol=1e-12):
    """The metric within ``metric_tol`` and every gradient key finite
    and within ``tol`` x its max|g| of the golden (exactly where the
    golden is 0); returns each key's error over that scale."""
    a = val.detach().cpu().numpy()
    b = g[pfx + "metric"]
    assert np.max(np.abs(a - b)) <= metric_tol * np.max(np.abs(b)), \
        f"metric {a} != {b}"
    worst = {}
    for k, a in grads.items():
        a = a.detach().cpu().numpy()
        b = g[f"{pfx}g_{k}"]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.all(np.isfinite(a)), f"non-finite d/d{k}"
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol:g} x {scale:.3e}"
        worst[k] = err / scale if scale else 0.0
    return worst


class AdjointCount:
    """Counts the solve backward's adjoint solves (on the card each is
    one launch of the kernel's adjoint entry)."""

    def __init__(self, monkeypatch):
        self.n = 0
        plain = linsolve._adjoint

        def counted(*a):
            self.n += 1
            return plain(*a)

        monkeypatch.setattr(linsolve, "_adjoint", counted)


# ---------------------------------------------------------------- solve

def _systems(lead, N, seed):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=lead + (N, N)) + 1j * rng.normal(size=lead + (N, N))
    return torch.as_tensor(Z + 2 * N * np.eye(N))


@pytest.mark.parametrize("N", [1, 3, 6, 13])
def test_solve_gradcheck(N):
    """gradcheck (complex, float64) with Z broadcast against F."""
    Z = _systems((2, 1), N, N).requires_grad_()
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 3, N))
                        + 0.5j).requires_grad_()
    assert torch.autograd.gradcheck(linsolve.solve, (Z, F))


@pytest.mark.parametrize("N", [6, 13])
def test_solve_backward_matches_linalg(N):
    Z0 = _systems((3, 1, 5), N, 2)
    F0 = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 2, 5, N))
                         - 1j)
    grads = []
    for fn in (linsolve.solve,
               lambda z, f: torch.linalg.solve(z, f[..., None])[..., 0]):
        Z = Z0.clone().requires_grad_()
        F = F0.clone().requires_grad_()
        x = fn(Z, F)
        grads.append(torch.autograd.grad((x.abs() ** 3).sum(), (Z, F)))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert float(torch.max(torch.abs(a - b))) <= 1e-13 * float(
            torch.max(torch.abs(b)))


def test_pivot_moduli():
    """The elimination's pivots multiply to |det|, for Z and Z^H."""
    Z = _systems((4,), 6, 5)
    for A in (Z, Z.mH):
        p = linsolve.pivot_moduli(A)
        np.testing.assert_allclose(torch.prod(p, -1).numpy(),
                                   torch.abs(torch.linalg.det(A)).numpy(),
                                   rtol=1e-12)


# ------------------------------------------------------ implicit backwards

def _spar_lines(rows=2):
    ms = model("spar").ms
    X = torch.tensor([[3.0, -1.0, -0.4, 0.02, -0.03, 0.05],
                      [-6.0, 2.0, 0.3, -0.01, 0.04, -0.1]][:rows],
                     dtype=torch.float64)
    return mooring.line_args(ms, X), X


def test_catenary_implicit_matches_jacfwd_through_the_loop():
    """d(F, C)/d(L, EA scales) and dF/dX by the loads attached at the
    root, against forward mode (torch.func.jvp) through the 60-step
    Newton loop with its stiffness tangents, along a direction and
    against a random cotangent."""
    (fair0, anchor, L, w, EA, mask), X = _spar_lines()

    def loop(th):
        return mooring.loop_forces(fair0, anchor, L * th[0], w, EA * th[1],
                                   mask, X)[:2]

    th0 = torch.tensor([1.01, 0.9], dtype=torch.float64)
    v = torch.tensor([0.3, -0.7], dtype=torch.float64)
    (F_ref, C_ref), (dF, dC) = torch.func.jvp(loop, (th0,), (v,))
    rng = np.random.default_rng(11)
    uF, uC = (torch.as_tensor(rng.normal(size=t.shape)) for t in (F_ref,
                                                                 C_ref))
    th = th0.clone().requires_grad_()
    F, C = mooring.line_forces_and_stiffness(fair0, anchor, L * th[0], w,
                                             EA * th[1], mask, X)
    assert torch.equal(F.detach(), mooring.line_forces_and_stiffness(
        fair0, anchor, L * th0[0], w, EA * th0[1], mask, X)[0])
    gth = torch.autograd.grad((uF * F).sum() + (uC * C).sum(), th)[0]
    ref = float((uF * dF).sum() + (uC * dC).sum())
    assert abs(float(gth @ v) - ref) <= 1e-9 * abs(ref)
    Xg = X.clone().requires_grad_()
    F = mooring.line_forces_and_stiffness(fair0, anchor, L * th0[0], w,
                                          EA * th0[1], mask, Xg)[0]
    gX = torch.autograd.grad((uF * F).sum(), Xg)[0]
    ref = -torch.einsum("ra,rab->rb", uF, C_ref)
    assert float(torch.max(torch.abs(gX - ref))) <= 1e-9 * float(
        torch.max(torch.abs(ref)))


def test_statics_implicit_matches_unrolled_newton():
    """dX*/d(L scale, F_und scale) of the statics, converged tightly, by
    the implicit backward against torch.func.jvp of one full Newton step
    from the solution (forward mode through the catenary loop; at a root
    one step's derivative is the implicit one, so the step's matrix is
    held at its value)."""
    m = model("spar")
    fs = m.fowtList[0]
    st = m.statics()
    f64 = dict(dtype=torch.float64)
    K_h = torch.as_tensor(st["C_struc"] + st["C_hydro"], **f64)[None]
    F_und = torch.as_tensor(st["W_struc"] + st["W_hydro"]
                            + st["f0_additional"], **f64)[None]
    F_env = torch.tensor([[8e5, -2e5, 0.0, 0.0, 3e6, 0.0]], **f64)
    tols, caps, refs = (torch.tensor(v, **f64) for v in make_tolerances([fs]))
    ms = m.ms.to("cpu")

    def system(th):
        return mooring.MooringSystem(ms.r_anchor, ms.r_fair0, ms.L * th[0],
                                     ms.w, ms.EA, ms.depth)

    th = torch.tensor([1.01, 1.0005], **f64, requires_grad=True)
    X, _, _, _, _, C_moor = solve_equilibrium_general(
        K_h, F_und * th[1], F_env, single_ms_closures(system(th), 6),
        tols * 1e-8, caps * 1e3, refs)
    K = (K_h + C_moor).detach()

    def newton(t):
        F6, _ = mooring.catenary_line_forces(
            *mooring.line_args(system(t), X.detach())[:5], X.detach())
        f = F_und * t[1] - (K_h @ X.detach()[..., None])[..., 0] + F_env \
            + F6.sum(-2)
        return torch.linalg.solve(K, f[..., None])[..., 0]

    u = torch.as_tensor(np.random.default_rng(4).normal(size=(1, 6)))
    v = torch.tensor([0.6, -0.8], **f64)
    got = float(torch.autograd.grad((u * X).sum(), th)[0] @ v)
    dX = torch.func.jvp(newton, (th.detach(),), (v,))[1]
    ref = float((u * dX).sum())
    assert abs(got - ref) <= 1e-9 * abs(ref)


def test_fixed_point_backward_matches_forward_neumann():
    """d metric/d(Cd scale) through the drag fixed point: the backward (10
    Neumann steps of vjps on one graph) against the reference's forward
    rule (10 Neumann steps of jvps, torch.func.jvp, with
    torch.linalg.solve)."""
    p = tb.load_packed(os.path.join(FIX, "packed_spar.npz"))
    ev = tb.BucketEvaluator(p.sig, "cpu")
    d = tb.packed_from_numpy(tb.stack_packed([p.leaves] * 2), "cpu")
    R = 2
    X0 = torch.tensor([[2.0, 0.5, -0.3, 0.01, 0.03, -0.02],
                       [-1.0, 0.0, 0.2, 0.0, -0.02, 0.01]],
                      dtype=torch.float64)
    fsb = tb.site_of(d, ev.N)
    ss0 = tb.strips_of(d)
    from raft_tpu_torch.physics.statics import node_T, platform_kinematics

    r_nodes, R_ptfm, r_root = platform_kinematics(d["node_r0"], d["root"],
                                                  X0)
    Tn = node_T(r_nodes, r_root)
    r, q, p1, p2 = morison.strip_frames(ss0, R_ptfm, r_nodes)
    sub = (r[..., 2] < 0) & d["strip_mask"]
    hc = dict(Imat=d["Imat"], a_i=d["a_i"], A_hydro=d["A_hydro"], r=r, q=q,
              p1=p1, p2=p2, sub=sub, active=sub & d["active"])
    w = ev.w
    S = morison.wv.jonswap(w, torch.tensor([6.0, 4.0], dtype=torch.float64),
                           torch.tensor([11.0, 8.0], dtype=torch.float64))
    zeta = torch.sqrt(2.0 * S * ev.dw).to(torch.complex128)
    exc = morison.hydro_excitation(fsb, ss0, hc, zeta,
                                   torch.tensor([0.3, 1.1],
                                                dtype=torch.float64),
                                   w, d["k"], Tn, r_nodes)
    M_lin = (d["M_struc"] + d["A_hydro"])[..., None].expand(R, 6, 6, ev.nw)
    B_lin = torch.zeros_like(M_lin)
    C_lin = d["K_h"] + 1e5 * torch.eye(6, dtype=torch.float64)

    def strips(th):
        return tb.strips_of(dict(d, **{k: d[k] * th for k in (
            "Cd_q", "Cd_p1", "Cd_p2", "Cd_End")}))

    th = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    _, Xi, _, diag = dynamics.solve_dynamics_fowt(
        fsb, strips(th), hc, exc["u"], M_lin, B_lin, C_lin,
        exc["F_hydro_iner"], w, Tn, r_nodes, n_iter=ev.n_iter,
        Xi_start=ev.Xi_start)
    got = torch.autograd.grad((Xi.abs() ** 2).sum(), th)[0]

    Z0 = dynamics.impedance(w, M_lin, B_lin, C_lin).to(torch.complex128)

    def update(XiL, t):
        pre = morison.drag_lin_precompute(fsb, strips(t), hc, exc["u"], Tn,
                                          r_nodes, w)
        out = morison.drag_lin_iter(pre, XiL)
        Z = Z0 + (1j * w)[:, None, None] * out["B_hydro_drag"][:, None]
        F = exc["F_hydro_iner"] + out["F_hydro_drag"]
        return torch.linalg.solve(Z, F.transpose(-1, -2)[..., None])[
            ..., 0].transpose(-1, -2)

    XiL, t0 = diag["Xi_lin"], th.detach()
    one = torch.ones((), dtype=torch.float64)
    dth = torch.func.jvp(lambda t: update(XiL, t), (t0,), (one,))[1]
    x = dth
    for _ in range(dynamics.NEUMANN_STEPS):
        x = dth + torch.func.jvp(lambda v: update(v, t0), (XiL,), (x,))[1]
    ref = torch.func.jvp(lambda v, t: (update(v, t).abs() ** 2).sum(),
                         (XiL, t0), (x, one))[1]
    assert abs(float(got - ref)) <= 1e-10 * abs(float(ref))


# ---------------------------------------------------------- end to end

@pytest.mark.parametrize("name", sorted(GRAD_SETS))
def test_geometry_gradients_match_goldens(name, monkeypatch):
    """Every geometry key, FUSED on and off (one evaluation for two
    wave headings: the staged response either way), spar in chunks of
    two rows; 12 adjoint solves per chunk (10 Neumann steps, the
    pull-back to the parameters, and the final update's or the
    response's)."""
    g = dict(np.load(os.path.join(FIX, f"golden_grad_{name}.npz")))
    ev = tapi.make_full_evaluator(model(name), nWaves=GRAD_SETS[name],
                                  device="cpu", geometry=True)
    rows = {k: g[k] for k in tapi.ENV_KEYS + tapi.SEA_KEYS}
    chunks = 2 if name == "spar" else 1
    monkeypatch.setenv("RAFT_TPU_BUCKET_ROWS", str(len(g["Hs"]) // chunks))
    count = AdjointCount(monkeypatch)
    for fused in ("on", "off") if GRAD_SETS[name] == 1 else ("on",):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        geom = {k[5:]: torch.tensor(v, requires_grad=True)
                for k, v in g.items() if k.startswith("geom_")}
        val = metric(ev(geom=geom, **rows))
        count.n = 0
        grads = dict(zip(geom, torch.autograd.grad(val.sum(),
                                                   list(geom.values()))))
        assert count.n == chunks * (dynamics.NEUMANN_STEPS + 2)
        hold_grads(val, grads, g, f"{fused}_")
        if GRAD_SETS[name] > 1:
            hold_grads(val, grads, g, "off_")


@pytest.mark.parametrize("name", ["spar", "semi", "mhk"])
def test_design_gradients_match_goldens(name, monkeypatch):
    """Hs, Tp, beta, Cd_scale, Ca_scale and L_moor_scale, FUSED on and
    off.  The goldens' Hs and Tp gradients come from the reference with
    its spectrum floored where it underflows (its own are NaN there:
    tests/make_torch_port_fixtures.py, _floored_jonswap); the port's
    amplitudes have that derivative built in (ops/waves.py
    amplitudes)."""
    g = dict(np.load(os.path.join(FIX, f"golden_grad_design_{name}.npz")))
    ev = tapi.make_design_evaluator(model(name), device="cpu")
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        p = {k: torch.tensor(g[k], requires_grad=True) for k in DESIGN_KEYS}
        val = metric(ev(**p))
        grads = dict(zip(p, torch.autograd.grad(val.sum(), list(p.values()))))
        hold_grads(val, grads, g, f"{fused}_")


def test_gradient_matches_central_difference():
    """The port's gradient in L_moor_scale against a central difference
    of its own forward (eps 1e-4, rel 2e-3: the fixed point stops at its
    1% rule, so its forward is smooth only to that level)."""
    ev = tapi.make_design_evaluator(model("spar"), device="cpu")

    def f(L):
        return metric(ev(Hs=6.0, Tp=12.0, beta=0.3, L_moor_scale=L)).sum()

    L = torch.tensor([1.0], dtype=torch.float64, requires_grad=True)
    g = float(torch.autograd.grad(f(L), L)[0])
    eps = 1e-4
    fd = (float(f(1.0 + eps)) - float(f(1.0 - eps))) / (2 * eps)
    assert g == pytest.approx(fd, rel=2e-3)


def test_aero_inputs_refuse_gradients():
    """A wind speed that requires grad on a design with an active rotor
    (refused until the aero stage's backward was ported) gives a finite
    gradient, and under no_grad none; for the sea states gradients
    flow."""
    ev = tapi.make_full_evaluator(model("semi_wind"), device="cpu")
    U = torch.tensor([8.0], dtype=torch.float64, requires_grad=True)
    out = ev(wind_speed=U, Hs=4.0, Tp=9.0)
    g, = torch.autograd.grad(metric(out).sum(), U)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    with torch.no_grad():
        out = ev(wind_speed=U, Hs=4.0, Tp=9.0)
    assert not any(v.requires_grad for v in out.values())
    Hs = torch.tensor([4.0], dtype=torch.float64, requires_grad=True)
    out = ev(wind_speed=8.0, Hs=Hs, Tp=9.0)
    assert torch.isfinite(torch.autograd.grad(metric(out).sum(), Hs)[0]).all()


def test_no_grad_without_an_input_that_needs_it():
    ev = tapi.make_design_evaluator(model("spar"), device="cpu")
    out = ev(Hs=[6.0], Tp=[12.0], beta=[0.3])
    assert not any(v.requires_grad for v in out.values())


@pytest.mark.slow
def test_grad_fixtures_regenerate():
    """The gradient goldens, rebuilt through jax.grad (and checked
    against jax.jacfwd), equal the checked-in files."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for kind, names, build in (("grad", GRAD_SETS, mk.build_grad_golden),
                               ("grad_design", ("spar", "semi", "mhk"),
                                mk.build_grad_design_golden)):
        for name in names:
            new = build(name)
            old = dict(np.load(os.path.join(FIX, f"golden_{kind}_{name}.npz")))
            assert sorted(new) == sorted(old)
            for k in old:
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)

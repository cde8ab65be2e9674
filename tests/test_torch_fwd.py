"""Forward mode (``torch.func.jvp``, ``torch.func.jacfwd``) through the
port, against JAX.

Fast tier:

* the solve's ``torch.autograd.Function`` (:class:`~raft_tpu_torch.ops.
  linsolve._Solve`): ``gradcheck(check_forward_ad=True)`` in float64 and
  its jvp against ``torch.linalg.solve``'s own forward AD, N = 1, 3, 6,
  12 and 13; ``jacfwd`` equal to a loop of ``jvp``s bit for bit on the
  plain version, with one tangent solve for all of its directions (the
  vmap rule), whatever their number;
* each implicit rule's jvp against an oracle: the catenary loads
  attached at the root against ``torch.func.jvp`` through the whole
  Newton loop; the statics (``_StaticsRoot.jvp``) against the jvp of one
  Newton step from the root; the drag fixed point
  (``_FixedPointRoot.jvp``) against the reference's forward rule written
  out (10 Neumann steps of jvps with ``torch.linalg.solve``);
* the design evaluator end to end against ``golden_jvp_design_*.npz``
  (the three demos, the rows of ``golden_grad_design_*.npz``, two seeded
  directions over the six inputs), FUSED on and off: every float
  output's tangent within 1e-9 x that key's max|tangent|, every output
  under the transform (``status`` and ``n_iter_drag`` too) bit-equal to
  the plain call, forward and reverse mode agreeing (``u . (J v) =
  (J^T u) . v`` within 1e-10 of the sum of |u| |J v|, one ``jvp`` over
  inputs that require grad giving both);
* the fault this forward mode repairs: the spar design evaluator's
  tangents along ones per input (NaN on Hs, Tp, beta and L_moor_scale,
  2.5e-3 x max|g| off on Cd_scale, 6.7e-4 on Ca_scale before) within
  1e-9 x max|g| of ``golden_grad_design_spar.npz``.

Each float key's tangent is held along the golden's first direction;
FUSED off without the reverse half.  Every test runs on one intra-op
thread (``one_thread``).

The other evaluators' tangents: ``tests/test_torch_fwd_geometry.py``,
``test_torch_fwd_aero.py`` (with the external-QTF design),
``test_torch_fwd_bem.py``,
``test_torch_fwd_farm.py``, ``test_torch_fwd_flex.py``; ``jacfwd``
against every ``golden_grad_*`` file: ``test_torch_fwd_jacfwd.py``.
Slow tier: the goldens regenerated through ``jax.jvp``.
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
sys.path.insert(0, HERE)
import make_torch_port_fixtures as mk  # noqa: E402
from test_torch_grad import DESIGN_KEYS, metric  # noqa: E402
FIX = os.path.join(HERE, "fixtures", "torch_port")
#: the tangents' gate, x each key's max|tangent| (the gradients')
TOL = 1e-9
#: forward against reverse mode, x the sum of |u| |J v|
AGREE_TOL = 1e-10

_MODELS = {}


def model(name):
    if name not in _MODELS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _MODELS[name] = Model(json.load(f))
    return _MODELS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_jvp_{name}.npz")))


# ------------------------------------------------------------ helpers

def directions(x, d):
    """Direction ``d`` of the jvp goldens over the inputs ``x`` (name ->
    tensor), in x's key order (the writer's ``jvp_directions``)."""
    t = mk.jvp_directions({k: v.detach().cpu().numpy()
                           for k, v in x.items()}, d)
    return {k: torch.as_tensor(t[k], device=x[k].device) for k in x}


def _inexact(v):
    return v.is_floating_point() or v.is_complex()


def hold_tangents(tan, g, pfx, d, tol=TOL):
    """Every float key's tangent finite and within ``tol`` x the golden's
    max|tangent| (exactly where that is 0); every integer and bool
    key's zero.  Returns each key's error over that scale."""
    worst = {}
    for k, v in tan.items():
        a = v.detach().cpu().numpy()
        if not _inexact(v):
            assert not a.any(), f"{k}: a nonzero tangent of an integer key"
            continue
        b = g[f"{pfx}jvp{d}_{k}"]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.all(np.isfinite(a)), f"non-finite tangent of {k}"
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol:g} x {scale:.3e}"
        worst[k] = err / scale if scale else 0.0
    return worst


def hold_primal(prim, plain, g, pfx, tol=0.0):
    """Every output under the transform bit-equal to the plain call's
    (with ``tol`` > 0, a float or a gate per key, each float key within
    its gate x its max; the integer and bool keys still equal); status,
    n_iter_drag and drag_converged equal to the golden's.  Returns the
    largest float difference over its key's max."""
    assert sorted(prim) == sorted(plain)
    worst = 0.0
    for k, v in plain.items():
        a = prim[k].detach()
        kt = tol.get(k, 0.0) if isinstance(tol, dict) else tol
        if kt and _inexact(v):
            scale = float(torch.max(torch.abs(v)))
            err = float(torch.max(torch.abs(a - v)))
            assert err <= kt * scale, f"{k} moved under the transform: " \
                f"{err:.3e} > {kt:g} x {scale:.3e}"
            worst = max(worst, err / scale if scale else 0.0)
        else:
            assert torch.equal(a, v), f"{k} moved under the transform"
    for k in ("status", "n_iter_drag", "drag_converged"):
        if k in plain and pfx + k in g:
            np.testing.assert_array_equal(plain[k].cpu().numpy(),
                                          g[pfx + k], err_msg=k)
    return worst


def agree(x, t, prim, tan, seed=5):
    """Forward and reverse mode agree: with random cotangents u of every
    float output, ``u . (J t)`` from the tangents ``tan`` against ``(J^T
    u) . t`` by autograd through ``prim`` (outputs of inputs ``x`` that
    require grad), within AGREE_TOL x the sum of |u| |J t|."""
    rng = np.random.default_rng(seed)
    keys = [k for k in prim if _inexact(prim[k])]
    us = {}
    for k in keys:
        u = rng.normal(size=prim[k].shape)
        if prim[k].is_complex():
            u = u + 1j * rng.normal(size=prim[k].shape)
        us[k] = torch.as_tensor(u)
    L = sum(torch.sum(torch.real(us[k].conj() * prim[k])) for k in keys)
    gr = torch.autograd.grad(L, list(x.values()), allow_unused=True,
                             materialize_grads=True)
    rev = sum(float(torch.sum(gk * t[k])) for k, gk in zip(x, gr))
    tan = {k: tan[k].detach() for k in keys}
    fwd = sum(float(torch.sum(torch.real(us[k].conj() * tan[k])))
              for k in keys)
    scale = sum(float(torch.sum(torch.abs(us[k]) * torch.abs(tan[k])))
                for k in keys)
    assert abs(fwd - rev) <= AGREE_TOL * scale, (fwd, rev, scale)


def check_tangents(fn, x, g, pfx, tol=TOL, reverse=True):
    """One evaluator configuration against its jvp golden: the plain call
    ``fn(x)``, then ``torch.func.jvp`` along the golden's direction 0
    (with ``reverse``, over ``x`` requiring grad, forward and reverse
    mode agreeing): every output bit-equal to the plain call's, the
    tangents held.  Returns the worst error over the golden's scale per
    key.  (Both directions at once, as ``jacfwd`` batches them:
    ``chip_smoke.py``'s fwd phase and ``tests/test_torch_fwd_jacfwd.py``.)"""
    with torch.no_grad():
        plain = fn(x)
    for d in range(2):
        for k, v in directions(x, d).items():
            if f"{pfx}dir{d}_{k}" in g:
                np.testing.assert_array_equal(v.cpu().numpy(),
                                              g[f"{pfx}dir{d}_{k}"])
    t = directions(x, 0)
    xr = {k: v.clone().requires_grad_(reverse) for k, v in x.items()}
    prim, tan = torch.func.jvp(fn, (xr,), (t,))
    hold_primal(prim, plain, g, pfx)
    worst = hold_tangents(tan, g, pfx, 0, tol)
    if reverse:
        agree(xr, t, prim, tan)
    return worst


@pytest.fixture(autouse=True)
def one_thread():
    """Each test of forward mode on one intra-op thread: under the
    driver's parallel workers, torch's default of one thread per core
    in every worker oversubscribes the cores (the batched tangents make
    the ops large enough to fan out); alone, one thread costs these
    tests about 10%."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_jacfwd(fn, x, metric_fn=metric):
    """Each row's gradient of ``metric_fn(fn(x))`` by ``torch.func.jacfwd``
    of a perturbation shared by every row (rows are independent): the
    evaluator once, one direction per element of a row's inputs."""
    def f(delta):
        return metric_fn(fn({k: x[k] + delta[k] for k in x}))

    return torch.func.jacfwd(f)({k: torch.zeros_like(v[0])
                                 for k, v in x.items()})


def hold_jacfwd(J, g, pfx, tol=TOL):
    """``jacfwd``'s gradients within ``tol`` x each key's max|g| of the
    gradient golden ``g`` (its ``<pfx>g_<key>``)."""
    for k, a in J.items():
        b = g[f"{pfx}g_{k}"]
        a = a.detach().cpu().numpy()
        assert a.shape == b.shape and np.all(np.isfinite(a)), k
        assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b)), k


# ---------------------------------------------------------------- solve

def _systems(lead, N, seed):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=lead + (N, N)) + 1j * rng.normal(size=lead + (N, N))
    return torch.as_tensor(Z + 2 * N * np.eye(N))


@pytest.mark.parametrize("N", [1, 3, 6, 12, 13])
def test_solve_forward_ad(N):
    """gradcheck with forward AD (complex, float64, Z broadcast against
    F; not at N = 12, where its numerical Jacobian takes half a minute:
    the plain version is one elimination for every N), and the jvp
    against torch.linalg.solve's own forward AD."""
    Z = _systems((2, 1), N, N)
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 3, N))
                        + 0.5j)
    if N != 12:
        assert torch.autograd.gradcheck(
            linsolve.solve, (Z.clone().requires_grad_(),
                             F.clone().requires_grad_()),
            check_forward_ad=True)
    dZ = 0.1 * _systems((2, 1), N, N + 1)
    dF = torch.as_tensor(np.random.default_rng(2).normal(size=F.shape)
                         - 0.3j)
    x, dx = torch.func.jvp(linsolve.solve, (Z, F), (dZ, dF))
    ref, dref = torch.func.jvp(
        lambda z, f: torch.linalg.solve(z, f[..., None])[..., 0], (Z, F),
        (dZ, dF))
    assert torch.equal(x, linsolve.solve(Z, F))
    assert float(torch.max(torch.abs(dx - dref))) <= 1e-13 * float(
        torch.max(torch.abs(dref)))


@pytest.mark.parametrize("N", [6, 12, 13])
def test_solve_jacfwd_is_one_tangent_solve(N, monkeypatch):
    """jacfwd equals a loop of jvps bit for bit on the plain version, and
    its directions cost one tangent solve, however many there are: the
    vmap rule folds them into the batch of systems (on the card, one
    launch)."""
    Z = _systems((2, 1), N, N)
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 3, N))
                        + 0.5j)
    calls = []
    plain = linsolve._forward

    def counted(*a, **k):
        calls.append(a[0].shape[-1])
        return plain(*a, **k)

    monkeypatch.setattr(linsolve, "_forward", counted)
    for k in (3, 7):
        s0 = torch.linspace(0.9, 1.1, k, dtype=torch.float64)

        def f(s):
            return torch.view_as_real(linsolve.solve(
                Z * s[0], F * s[1:].sum() + s[-1]))

        calls.clear()
        J = torch.func.jacfwd(f)(s0)
        assert len(calls) == 2, calls           # the primal and the tangent
        for i in range(k):
            e = torch.zeros(k, dtype=torch.float64)
            e[i] = 1.0
            assert torch.equal(torch.func.jvp(f, (s0,), (e,))[1], J[..., i])


def test_kernel_dispatch_gets_plain_tensors(monkeypatch):
    """Inside torch.func's transforms every tensor is a wrapper without
    storage, whose data pointers the card's kernel cannot take: every
    solve of an evaluator under jvp (over inputs that require grad, then
    its backward) and jacfwd reaches the kernel's dispatch (``_forward``,
    ``_adjoint``) with plain tensors, through ``_Solve``."""
    from raft_tpu_torch.utils import ad

    seen = []
    fwd, adj = linsolve._forward, linsolve._adjoint

    def plain_fwd(Z, F, *a, **k):
        seen.append(ad.transformed(Z, F))
        return fwd(Z, F, *a, **k)

    def plain_adj(Z, planes, G, path):
        seen.append(ad.transformed(Z, G))
        return adj(Z, planes, G, path)

    monkeypatch.setattr(linsolve, "_forward", plain_fwd)
    monkeypatch.setattr(linsolve, "_adjoint", plain_adj)
    g = dict(np.load(os.path.join(FIX, "golden_grad_design_spar.npz")))
    ev = tapi.make_design_evaluator(model("spar"), device="cpu")
    x = {k: torch.tensor(g[k], requires_grad=True) for k in DESIGN_KEYS}
    val, _ = torch.func.jvp(lambda x: metric(ev(**x)), (x,),
                            (directions(x, 0),))
    torch.autograd.grad(val.sum(), list(x.values()))
    row_jacfwd(lambda x: ev(**x), {k: v.detach() for k, v in x.items()})
    assert seen and not any(seen)


# ------------------------------------------------------ implicit rules

def _spar_lines():
    ms = model("spar").ms
    X = torch.tensor([[3.0, -1.0, -0.4, 0.02, -0.03, 0.05],
                      [-6.0, 2.0, 0.3, -0.01, 0.04, -0.1]],
                     dtype=torch.float64)
    return mooring.line_args(ms, X), X


def test_catenary_jvp_matches_the_loop():
    """d(F, C) along (L, EA scales) and along the pose, by the loads
    attached at the root, against torch.func.jvp through the 60-step
    Newton loop with its stiffness tangents; the values bit-equal to
    the plain call."""
    (fair0, anchor, L, w, EA, mask), X = _spar_lines()
    th0 = torch.tensor([1.01, 0.9], dtype=torch.float64)
    v = torch.tensor([0.3, -0.7], dtype=torch.float64)
    dX = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 6))
                         * [1, 1, 0.1, 0.01, 0.01, 0.01])
    for fn, th, tv, dXv in (
            (lambda th, X: (L * th[0], EA * th[1], X), th0, v,
             torch.zeros_like(X)),
            (lambda th, X: (L * th[0], EA * th[1], X), th0,
             torch.zeros_like(v), dX)):
        def implicit(th, X):
            Ls, EAs, Xs = fn(th, X)
            return mooring.line_forces_and_stiffness(fair0, anchor, Ls, w,
                                                     EAs, mask, Xs)

        def loop(th, X):
            Ls, EAs, Xs = fn(th, X)
            return mooring.loop_forces(fair0, anchor, Ls, w, EAs, mask,
                                       Xs)[:2]

        (F, C), (dF, dC) = torch.func.jvp(implicit, (th, X), (tv, dXv))
        (F0, C0), (rF, rC) = torch.func.jvp(loop, (th, X), (tv, dXv))
        plain = implicit(th, X)
        assert torch.equal(F, plain[0]) and torch.equal(C, plain[1])
        for a, b in ((dF, rF), (dC, rC)):
            assert float(torch.max(torch.abs(a - b))) <= 1e-9 * float(
                torch.max(torch.abs(b)))


def _spar_statics():
    m = model("spar")
    fs = m.fowtList[0]
    st = m.statics()
    f64 = dict(dtype=torch.float64)
    K_h = torch.as_tensor(st["C_struc"] + st["C_hydro"], **f64)[None]
    F_und = torch.as_tensor(st["W_struc"] + st["W_hydro"]
                            + st["f0_additional"], **f64)[None]
    F_env = torch.tensor([[8e5, -2e5, 0.0, 0.0, 3e6, 0.0]], **f64)
    tols, caps, refs = (torch.tensor(v, **f64) for v in make_tolerances([fs]))
    return K_h, F_und, F_env, tols, caps, refs, m.ms.to("cpu")


def test_statics_jvp_matches_one_newton_step():
    """dX* along (L scale, F_und scale), converged tightly, by
    _StaticsRoot's jvp against torch.func.jvp of one full Newton step
    from the solution (forward mode through the catenary loop; at a root
    one step's derivative is the implicit one, so the step's matrix is
    held at its value); the pose bit-equal to the plain call."""
    K_h, F_und, F_env, tols, caps, refs, ms = _spar_statics()

    def system(th):
        return mooring.MooringSystem(ms.r_anchor, ms.r_fair0, ms.L * th[0],
                                     ms.w, ms.EA, ms.depth)

    def statics(th):
        return solve_equilibrium_general(
            K_h, F_und * th[1], F_env, single_ms_closures(system(th), 6),
            tols * 1e-8, caps * 1e3, refs)

    th = torch.tensor([1.01, 1.0005], dtype=torch.float64)
    v = torch.tensor([0.6, -0.8], dtype=torch.float64)
    (X, C_moor), (dX, _) = torch.func.jvp(
        lambda t: (lambda o: (o[0], o[5]))(statics(t)), (th,), (v,))
    Xp, _, _, _, _, Cp = statics(th)
    assert torch.equal(X, Xp) and torch.equal(C_moor, Cp)
    K = K_h + Cp

    def newton(t):
        F6, _ = mooring.catenary_line_forces(
            *mooring.line_args(system(t), Xp)[:5], Xp)
        f = F_und * t[1] - (K_h @ Xp[..., None])[..., 0] + F_env \
            + F6.sum(-2)
        return torch.linalg.solve(K, f[..., None])[..., 0]

    ref = torch.func.jvp(newton, (th,), (v,))[1]
    assert float(torch.max(torch.abs(dX - ref))) <= 1e-9 * float(
        torch.max(torch.abs(ref)))


def test_fixed_point_jvp_matches_reference_neumann():
    """dXi along the Cd scale through the drag fixed point: the jvp (10
    Neumann steps, one tangent solve each) against the reference's
    forward rule written out (10 Neumann steps of jvps with
    torch.linalg.solve); the values bit-equal to the plain call."""
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

    def xi(th):
        _, Xi, _, diag = dynamics.solve_dynamics_fowt(
            fsb, strips(th), hc, exc["u"], M_lin, B_lin, C_lin,
            exc["F_hydro_iner"], w, Tn, r_nodes, n_iter=ev.n_iter,
            Xi_start=ev.Xi_start)
        return Xi, diag["Xi_lin"], diag["n_iter_drag"]

    t0 = torch.tensor(1.3, dtype=torch.float64)
    one = torch.ones((), dtype=torch.float64)
    (Xi, XiL, n_it), (dXi, _, _) = torch.func.jvp(xi, (t0,), (one,))
    plain = xi(t0)
    assert all(torch.equal(a, b) for a, b in zip((Xi, XiL, n_it), plain))

    Z0 = dynamics.impedance(w, M_lin, B_lin, C_lin).to(torch.complex128)

    def update(XiL, t):
        pre = morison.drag_lin_precompute(fsb, strips(t), hc, exc["u"], Tn,
                                          r_nodes, w)
        out = morison.drag_lin_iter(pre, XiL)
        Z = Z0 + (1j * w)[:, None, None] * out["B_hydro_drag"][:, None]
        F = exc["F_hydro_iner"] + out["F_hydro_drag"]
        return torch.linalg.solve(Z, F.transpose(-1, -2)[..., None])[
            ..., 0].transpose(-1, -2)

    y = torch.func.jvp(lambda t: update(XiL, t), (t0,), (one,))[1]
    x = y
    for _ in range(dynamics.NEUMANN_STEPS):
        x = y + torch.func.jvp(lambda v: update(v, t0), (XiL,), (x,))[1]
    ref = torch.func.jvp(update, (XiL, t0), (x, one))[1]
    assert float(torch.max(torch.abs(dXi - ref))) <= 1e-10 * float(
        torch.max(torch.abs(ref)))


# ---------------------------------------------------------- end to end

@pytest.mark.parametrize("name", ["spar", "semi", "mhk"])
def test_design_tangents_match_goldens(name, monkeypatch):
    """The six inputs along the goldens' two directions, FUSED on and
    off (module docstring)."""
    g = golden(f"design_{name}")
    ev = tapi.make_design_evaluator(model(name), device="cpu")
    x = {k: torch.tensor(g[k]) for k in DESIGN_KEYS}
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        check_tangents(lambda x: ev(**x), x, g, f"{fused}_",
                       reverse=fused == "on")


def test_spar_design_forward_mode_fault_repaired():
    """The fault this forward mode repairs (ROADMAP §C): the spar design
    evaluator's metric along a tangent of ones in each of its six
    inputs, on golden_grad_design_spar.npz's rows, FUSED on: the six
    directions at once, torch.func.jacfwd of a perturbation shared by
    the rows (its column k is the jvp along ones in input k).  Before:
    NaN on Hs, Tp, beta and L_moor_scale (the loops' tangents), 2.5e-3 x
    max|g| off on Cd_scale and 6.7e-4 on Ca_scale (the drag fixed point
    differentiated trip by trip to its 1% rule).  Now within 1e-9."""
    g = dict(np.load(os.path.join(FIX, "golden_grad_design_spar.npz")))
    ev = tapi.make_design_evaluator(model("spar"), device="cpu")
    p = {k: torch.tensor(g[k]) for k in DESIGN_KEYS}
    hold_jacfwd(row_jacfwd(lambda x: ev(**x), p), g, "on_")


@pytest.mark.slow
def test_jvp_fixtures_regenerate():
    """Every jvp golden, rebuilt through jax.jvp (each direction's metric
    tangent checked against jax.grad), equals the checked-in file."""
    for part in mk.JVP_PARTS:
        builders = dict(
            design=mk.build_jvp_design_golden,
            geometry=mk.build_jvp_geometry_golden,
            aero=mk.build_jvp_aero_golden)
        kind, _, name = part.partition("_")
        if kind in builders:
            new, fname = builders[kind](name), part
        else:
            new, fname = {
                "bem": (mk.build_jvp_bem_golden, "bem_semi_wind_coarse"),
                "bem_full": (lambda: mk.build_jvp_bem_golden("semi_wind"),
                             "bem_semi_wind"),
                "farm": (mk.build_jvp_farm_golden, "farm_semi_wind"),
                "flex": (mk.build_jvp_flex_golden, "flex_semi_wind"),
                "qtf": (mk.build_jvp_qtf_golden, "qtf_semi_wind"),
            }[part]
            new = new()
        old = golden(fname)
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)

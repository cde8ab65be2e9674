"""Mean-offset (static equilibrium) Newton solve, batched over rows
(counterpart of ``raft_tpu/models/statics_solve.py``:
``make_tolerances``, ``single_ms_closures``, ``solve_equilibrium`` and
``solve_equilibrium_general``).

The reference's vmapped ``lax.while_loop`` keeps running while any row
is active and freezes each finished row's carry; here that is a Python
loop with a per-row ``active`` mask.  Each row stops at its own
``done``, the final sub-tolerance step is discarded, and the applied
steps that saturated the per-DOF cap are counted per row.

The elastic stiffness ``C_elast`` enters as in the reference (zero for
a rigid body).  One difference of form: the mooring enters as a single
closure ``mooring_fn(X) -> (F_moor, C_moor)`` returning the force and
the stiffness ``-dF/dX`` at the same pose, since one forward-mode pass
yields both (the reference takes two closures).

Both modes take the implicit rule of the reference's
``lax.custom_root``: the Newton loop runs on detached values (no graph,
no tangent), and the pose attaches through :class:`_StaticsRoot` to one
differentiable evaluation of the net force f at X*.  Its jvp is the
reference's ``tangent_solve``, ``dX = K^-1 df`` with ``K = K_h +
C_elast + C_moor(X*)`` (the Jacobian of the net force is ``-K``); its
backward the transpose, ``lam = K^-T X_bar`` handed to f.  The
mooring's derivatives come from its implicit form at the converged
catenary loads (:class:`MooringClosure`).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.physics import mooring
from raft_tpu_torch.utils import ad, config, health


def make_tolerances(fowtList):
    """Per-DOF tolerances, step caps and reference positions, as the
    reference's (0.05 m / 0.005 rad; 30 m / 5 m / 0.1 rad caps):
    three lists of floats."""
    tols, caps, refs = [], [], []
    for fs in fowtList:
        for dof in fs.reducedDOF:
            tols.append(0.05 if dof[1] < 3 else 0.005)
            caps.append(30.0 if dof[1] < 2 else 5.0 if dof[1] == 2 else 0.1)
            refs.append(
                fs.x_ref if dof[1] == 0 else fs.y_ref if dof[1] == 1 else 0.0
            )
    return tols, caps, refs


class MooringClosure:
    """``mooring_fn(X) -> (F, C)`` of a catenary system whose line
    arguments ``args(X)`` gives (r_fair0, r_anchor, L, w, EA, mask), on
    the first six of nDOF DOFs; :meth:`with_root` and :meth:`at_root` are
    what the implicit backward of the statics needs."""

    def __init__(self, args, nDOF=6):
        self.args = args
        self.nDOF = nDOF

    def _pad(self, F, C):
        p = self.nDOF - 6
        if p:
            F = torch.nn.functional.pad(F, (0, p))
            C = torch.nn.functional.pad(C, (0, p, 0, p))
        return F, C

    def __call__(self, X):
        return self._pad(*mooring.line_forces_and_stiffness(
            *self.args(X[:, :6]), X[:, :6]))

    def with_root(self, X):
        """(F, C, converged loads) at X, forward values only (no graph,
        no tangent)."""
        with torch.no_grad():
            F, C, root = mooring.line_forces_and_stiffness(
                *ad.detached(*self.args(X[:, :6]), X[:, :6]), root=True)
        return (*self._pad(F, C), root)

    def at_root(self, X, root):
        """(F, C) at X from the converged loads ``root`` of that pose,
        differentiable (:func:`~raft_tpu_torch.physics.mooring.
        line_forces_at_root`)."""
        return self._pad(*mooring.line_forces_at_root(
            *self.args(X[:, :6]), X[:, :6], *root))

    def differentiated(self, X):
        """True when a line argument is being differentiated
        (:func:`raft_tpu_torch.utils.ad.differentiated`)."""
        return ad.differentiated(*self.args(X[:, :6]))


def single_ms_closures(ms, nDOF):
    """``mooring_fn(X) -> (F, C)`` of one FOWT's own catenary system
    (``ms`` None: zero force and stiffness) on the first six DOFs of
    X (R, nDOF)."""
    if ms is None:
        def mooring_fn(X):
            return (torch.zeros_like(X),
                    torch.zeros(X.shape + (nDOF,), dtype=X.dtype,
                                device=X.device))
        return mooring_fn
    return MooringClosure(lambda X: mooring.line_args(ms, X), nDOF)


class _StaticsRoot(torch.autograd.Function):
    """X* (R, n) attached to the net force f (R, n) evaluated at X*
    (its value ~0), K (R, n, n) the equilibrium stiffness at X*: the
    jvp carries f's tangent to ``dX = K^-1 df`` (the reference's
    ``tangent_solve``), the backward returns ``lam = K^-T X_bar`` as
    f's cotangent.  Both are plain torch ops, so torch.func generates
    the vmap rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(X, f, K):
        return X.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])
        ctx.save_for_forward(inputs[2])

    @staticmethod
    def jvp(ctx, dX, df, dK):
        K, = ctx.saved_tensors
        if df is None:
            return torch.zeros(K.shape[:-1], dtype=K.dtype, device=K.device)
        return torch.linalg.solve(K, df[..., None])[..., 0]

    @staticmethod
    def backward(ctx, X_bar):
        K, = ctx.saved_tensors
        lam = torch.linalg.solve(K.transpose(-1, -2), X_bar[..., None])
        return None, lam[..., 0], None


def solve_equilibrium_general(
    K_hydrostatic,
    F_undisplaced,
    F_env,
    mooring_fn,
    tol_vec,
    step_cap,
    X_ref,
    X0=None,
    max_iter=30,
    C_elast=None,
):
    """Damped Newton equilibrium with the reference's stopping rule.

    K_hydrostatic : (R, n, n); F_undisplaced, F_env : (R, n);
    tol_vec, step_cap, X_ref : (n,) or (R, n);
    mooring_fn : X (R, n) -> (F (R, n), C (R, n, n));
    C_elast : (n, n) or (R, n, n) elastic stiffness acting on X - X_ref,
    or None (no term).

    Returns ``(X, F_resid, n_iter, converged, status, C_moor)``: the
    pose, the net force at it, the per-row Newton count (int32), the
    stopping-rule verdict, the int32 health word (STATICS_MAX_ITER,
    STATICS_STEP_CAPPED) and the mooring stiffness at the returned pose.
    The mooring is evaluated once per Newton iteration: where every row
    stopped, the last iteration's evaluation was at the returned pose
    and serves it (one more only where a row hit the iteration cap).
    """
    R, n = F_undisplaced.shape
    dev = F_undisplaced.device
    X_ref = torch.as_tensor(X_ref, dtype=F_undisplaced.dtype, device=dev)
    X = X_ref.expand(R, n).detach().clone() if X0 is None \
        else X0.detach().clone()
    max_iter_eff = max_iter * max(int(config.get("ITER_SCALE")), 1)
    implicit = hasattr(mooring_fn, "at_root")

    def net_force(X, F_moor, K_hydrostatic, F_undisplaced, F_env, C_elast,
                  X_ref):
        # the hydrostatic and elastic stiffness act alike on X - X_ref,
        # each applied on its own (the reference's order of the sum)
        dx = (X - X_ref)[..., None]
        F = F_undisplaced - (K_hydrostatic @ dx)[..., 0] + F_env + F_moor
        if C_elast is not None:
            F = F - (C_elast @ dx)[..., 0]
        return F

    params = (K_hydrostatic, F_undisplaced, F_env, C_elast, X_ref)
    # the Newton loop runs on detached values: no graph, no tangent
    loop_params = ad.detached(*params)
    K_lin = loop_params[0] if C_elast is None \
        else loop_params[0] + loop_params[3]

    def mooring_eval(X):
        """(F, C, the converged state or None) at X, forward values."""
        if implicit:
            return mooring_fn.with_root(X)
        return (*mooring_fn(X), None)

    it = torch.zeros(R, dtype=torch.int32, device=dev)
    capped = torch.zeros(R, dtype=torch.int32, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    last = None
    with torch.no_grad():
        for _ in range(max_iter_eff):
            ev = mooring_eval(X)
            F_moor, C_moor = ev[:2]
            F = net_force(X, F_moor, *loop_params)
            K = K_lin + C_moor
            dX_raw = torch.linalg.solve(K, F[..., None])[..., 0]
            dX = torch.clamp(dX_raw, -step_cap, step_cap)
            step_done = torch.all(torch.abs(dX) < tol_vec, dim=-1)
            hit = torch.any(torch.abs(dX_raw) > step_cap, dim=-1)
            # the final sub-tolerance step is discarded (the reference's
            # dsolve2 semantics)
            X = torch.where((active & ~step_done)[:, None], X + dX, X)
            capped = capped + (active & ~step_done & hit).to(torch.int32)
            it = it + active.to(torch.int32)
            done = torch.where(active, step_done, done)
            active = active & ~step_done
            if not bool(active.any()):
                # no row moved in this iteration: its evaluation was at
                # the returned pose
                last = ev
                break
        if last is None:
            last = mooring_eval(X)
    status = health.set_bit(torch.zeros(R, dtype=torch.int32, device=dev),
                            health.STATICS_MAX_ITER, (~done).to(torch.int32))
    status = health.set_bit(status, health.STATICS_STEP_CAPPED,
                            (capped > 0).to(torch.int32))

    F_moor, C_moor, root = last
    moor_diff = implicit and mooring_fn.differentiated(X)
    if not (ad.differentiated(*params) or moor_diff):
        with torch.no_grad():
            F_resid = net_force(X, F_moor, *loop_params)
        return X, F_resid, it, done, status, C_moor

    # the implicit rule: f(X*, theta) differentiable in theta at the
    # detached X*, then X* attached to it, then the mooring stiffness at
    # the attached pose (so its pose derivative counts)
    F_att = F_moor
    if moor_diff:
        F_r, _ = mooring_fn.at_root(X, root)
        F_att = F_moor + (F_r - F_r.detach())
    f = net_force(X, F_att, *params)
    X_att = _StaticsRoot.apply(X, f, (K_lin + C_moor).detach())
    if implicit:
        _, C_r = mooring_fn.at_root(X_att, root)
        C_moor = C_moor + (C_r - C_r.detach())
    return X_att, f.detach(), it, done, status, C_moor


def solve_equilibrium(fs, ms, K_hydrostatic, F_undisplaced, F_env,
                      X0=None, max_iter=30, C_elast=None):
    """Single-FOWT wrapper: the reference's tolerances and caps for
    ``fs`` and the closures of its mooring system ``ms`` (whose ``L``
    may carry a row axis).  Same arguments and returns as
    :func:`solve_equilibrium_general`, batched over rows."""
    tols, caps, refs = make_tolerances([fs])
    kw = dict(dtype=F_undisplaced.dtype, device=F_undisplaced.device)
    return solve_equilibrium_general(
        K_hydrostatic, F_undisplaced, F_env,
        single_ms_closures(ms, fs.nDOF), torch.tensor(tols, **kw),
        torch.tensor(caps, **kw), torch.tensor(refs, **kw), X0=X0,
        max_iter=max_iter, C_elast=C_elast)

"""Frequency-domain dynamics solve, batched over rows (counterpart of
``raft_tpu/models/dynamics.py``: ``impedance``, ``solve_dynamics_fowt``
and ``system_response``).

The drag-linearised fixed point of the reference is a vmapped
``lax.while_loop`` (or masked fixed-trip scan blocks) that runs while
any row is active and freezes every finished row.  Here it is a Python
loop over trips with a per-row ``done`` mask: a finished row keeps its
linearisation point exactly, ``n_iter_drag`` counts each row's own
trips, and the all-rows-done test, which needs the host, runs once
every ``RAFT_TPU_SCAN_CHUNK`` trips.

Both modes take the implicit rule of the reference's ``lax.custom_root``
at the fixed point: the trip loop runs on detached values (no graph, no
tangent), one differentiable ``update(XiLast)`` is evaluated at the
detached fixed point, and :class:`_FixedPointRoot` attaches XiLast to
it.  Forward mode (``torch.func.jvp``, ``jacfwd``) is the reference's
``tangent_solve``: with ``y`` the tangent of that update (the inputs'
part, XiLast held), exactly 10 Neumann steps ``x <- y + J x`` (not to
convergence: the reference takes 10), ``J v`` the update's derivative
in Xi at the root: a ``torch.func.jvp`` of the drag linearisation and
one tangent solve with the root's Z (a launch of the kernel's forward
entry on the card, on the root solve's planes).  Reverse mode is its
transpose: 10 steps of ``lam <- X_bar + J^T lam``, each one adjoint
solve with the root's Z (the adjoint kernel on the card) and the
linearisation's vjp, then ``lam`` handed to the update, so ``theta_bar
= vjp_theta(update)(lam)``.  The final ``update`` at the fixed point
stays differentiable directly.
"""

from __future__ import annotations

import contextlib

import torch

from raft_tpu_torch.ops import linsolve
from raft_tpu_torch.physics import morison
from raft_tpu_torch.utils import ad, config, health
from raft_tpu_torch.utils.dtypes import compute_dtypes


def impedance(w, M, B, C):
    """Z (R, nw, n, n) from M, B (R, n, n, nw) and C (R, n, n)."""
    Mw = M.movedim(-1, -3)
    Bw = B.movedim(-1, -3)
    w3 = w[:, None, None]
    return -(w3 ** 2) * Mw + 1j * w3 * Bw + C[..., None, :, :]


def fused_response_enabled():
    """True when the response is taken from the fixed point's final
    solve (``RAFT_TPU_FUSED=on``, the default)."""
    return config.get("FUSED") == "on"


#: the drag fixed point's relative-change stopping tolerance (the
#: reference's)
TOL = 0.01
#: Neumann steps of the fixed point's jvp and backward (the reference's
#: tangent_solve takes 10)
NEUMANN_STEPS = 10
#: the context entered around the fixed point's trips (a factory called
#: with no argument): a no-op, which the op recorder of
#: :mod:`raft_tpu_torch.analysis.contracts` replaces to tell the trips'
#: ops from the rest of an entry's
TRIP_SCOPE = contextlib.nullcontext


class FixedPointState:
    """The fixed point's root for :class:`_FixedPointRoot`: the
    linearisation ``lin(Xi, *params) -> (Z, F, Bmat)`` (pure torch ops,
    F (R, nw, n) as the solve takes it) and the root solve's kept planes
    (:class:`~raft_tpu_torch.ops.linsolve.Keep`); bound by the Function
    to the root Xi*, the linearisation's inputs ``params``, the update's
    Z and solve output x (R, nw, n) there, as the Function receives them
    (unwrapped by torch.func, so the kernel can take their data), all
    detached.  A plain object, which torch.func passes through as it
    is."""

    def __init__(self, lin, keep, Xi=None, params=(), Z=None, x=None):
        self.lin, self.keep = lin, keep
        self.Xi, self.params, self.Z, self.x = Xi, params, Z, x

    def bound(self, Xi, params, Z, x):
        return FixedPointState(self.lin, self.keep, Xi, params, Z, x)

    def _lin(self, Xi):
        return self.lin(Xi, *self.params)[:2]

    def jvp_xi(self, v):
        """``J v``, the update's derivative in Xi at the root along v (R,
        n, nw): the linearisation's tangent (dZ, dF), then one tangent
        solve ``Z^-1 (dF - dZ x)`` with the root's Z and planes."""
        dZ, dF = torch.func.jvp(self._lin, (self.Xi,), (v,))[1]
        rhs = dF - (dZ @ self.x[..., None])[..., 0]
        dx = linsolve.solve(self.Z, rhs, keep=linsolve.Keep(self.keep.planes))
        return dx.transpose(-1, -2)

    def vjp_xi(self):
        """``lam -> J^T lam`` in torch's complex convention (lam (R, n,
        nw)): each call one adjoint solve with the root's Z and planes
        (:func:`~raft_tpu_torch.ops.linsolve.solve_vjp`), then the
        linearisation's vjp."""
        _, pull = torch.func.vjp(self._lin, self.Xi)

        def vjp(lam):
            gZ, gF = linsolve.solve_vjp(self.Z, self.x,
                                        lam.transpose(-1, -2),
                                        self.keep.planes)
            return pull((gZ, gF))[0]

        return vjp


class _FixedPointRoot(torch.autograd.Function):
    """The fixed point XiLast attached to ``Xi_u = update(XiLast)``, the
    one differentiable update at XiLast's detached value (with Z_u, its
    impedance, and ``params``, the linearisation's inputs, detached).
    The jvp is the reference's Neumann ``tangent_solve`` from Xi_u's
    tangent y: ``x <- y + J x``; the backward its transpose, ``lam <-
    X_bar + J^T lam``, handed to Xi_u (whose graph pulls it back to the
    inputs); both take J at the root from ``state``
    (:class:`FixedPointState`), NEUMANN_STEPS steps each."""

    @staticmethod
    def forward(XiLast, Xi_u, Z_u, state, *params):
        return XiLast.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        XiLast, Xi_u, Z_u, state = inputs[:4]
        ctx.n_params = len(inputs) - 4
        ctx.state = state.bound(XiLast.detach(),
                                tuple(p.detach() for p in inputs[4:]),
                                Z_u.detach(),
                                Xi_u.detach().transpose(-1, -2))

    @staticmethod
    def jvp(ctx, dXiLast, y, dZ_u, _, *dparams):
        x = y
        for _ in range(NEUMANN_STEPS):
            x = y + ctx.state.jvp_xi(x)
        return x

    @staticmethod
    def vmap(info, in_dims, *args):
        """torch.func calls this only where a primal input is batched
        (``jacfwd`` batches the tangents, which the jvp takes): the
        fixed point of a vmapped evaluator, which the state of one root
        cannot carry."""
        raise NotImplementedError(
            "torch.func.vmap over the drag fixed point's own inputs: call "
            "the evaluator on rows (they are its batch dimension)")

    @staticmethod
    def backward(ctx, X_bar):
        vjp = ctx.state.vjp_xi()
        lam = X_bar
        for _ in range(NEUMANN_STEPS):
            lam = X_bar + vjp(lam)
        return (None, lam, None, None) + (None,) * ctx.n_params


def solve_dynamics_fowt(fs, ss, hc, u0, M_lin, B_lin, C_lin, F_lin, w, Tn,
                        r_nodes, n_iter=15, Xi_start=0.1, n_iter_extra=0,
                        timer=None, Z_extra=None):
    """Iterative drag-linearised impedance solve for a batch of rows.

    M_lin, B_lin : (R, n, n, nw); C_lin : (R, n, n); F_lin : (R, n, nw)
    complex; u0 : (R, S, 3, nw) strip wave velocities; w : (nw,).  The
    compute dtypes follow ``RAFT_TPU_DTYPE``, else the inputs.
    ``Z_extra`` (R, nw, n, n) complex, or None, is added to the base
    impedance after its cast, as the reference adds it: the
    frequency-dependent lumped-mass mooring impedance of ``moorMod`` 2,
    which then stands in for the quasi-static mooring stiffness in
    C_lin.

    Returns (Z (R, nw, n, n), Xi (R, n, nw), Bmat (R, S, 3, 3), diag)
    with diag holding drag_resid, drag_converged, n_iter_drag (int32),
    cond_Z and the int32 status word, each per row, the final
    linearisation point Xi_lin (R, n, nw) and ``trips``, the number of
    fixed-point trips run (one solve each, before the final one).
    ``timer``, when given, is called with a stage name at the end of
    the fixed point.
    """
    R, nDOF, nw = F_lin.shape
    rdt, cdt = compute_dtypes(M_lin, F_lin, w)
    dev = F_lin.device
    w = w.to(rdt)
    M_lin, B_lin, C_lin = M_lin.to(rdt), B_lin.to(rdt), C_lin.to(rdt)
    F_lin = F_lin.to(cdt)
    u0 = u0.to(cdt)

    pre = morison.drag_lin_precompute(fs, ss, hc, u0, Tn, r_nodes, w,
                                      dtype=(rdt, cdt))
    Z0 = impedance(w, M_lin, B_lin, C_lin).to(cdt)
    if Z_extra is not None:
        Z0 = Z0 + Z_extra.to(cdt)
    iw = (1j * w).to(cdt)
    pre_keys = tuple(k for k, v in pre.items() if isinstance(v, torch.Tensor))
    params = (Z0, F_lin) + tuple(pre[k] for k in pre_keys)

    def lin(XiLast, Z0, F_lin, *pre_t):
        out = morison.drag_lin_iter(dict(pre, **dict(zip(pre_keys, pre_t))),
                                    XiLast)
        Z = Z0 + iw[:, None, None] * out["B_hydro_drag"][:, None, :, :]
        F = F_lin + out["F_hydro_drag"]
        return Z, F.transpose(-1, -2), out["Bmat"]

    def update(XiLast, params, keep=None):
        Z, F, Bmat = lin(XiLast, *params)
        Xi = linsolve.solve(Z, F, keep=keep)
        return Xi.transpose(-1, -2), Z, Bmat

    iter_scale = max(int(config.get("ITER_SCALE")), 1)
    cap = n_iter * iter_scale + 1 + max(int(n_iter_extra), 0)
    chunk = min(max(1, config.get("SCAN_CHUNK")), cap)

    XiLast = torch.full((R, nDOF, nw), Xi_start, dtype=cdt, device=dev)
    done_prev = torch.zeros(R, dtype=torch.bool, device=dev)
    n_real = torch.zeros(R, dtype=torch.int32, device=dev)
    it = 0
    # the trips run on detached values: no graph, no tangent
    loop_params = ad.detached(*params)
    with torch.no_grad(), TRIP_SCOPE():
        while it < cap:
            for _ in range(min(chunk, cap - it)):
                Xi, _, _ = update(XiLast, loop_params)
                tolCheck = torch.abs(Xi - XiLast) / (torch.abs(Xi) + TOL)
                done = torch.all(tolCheck < TOL, dim=(1, 2))
                last = it + 1 >= cap
                # a finished row keeps its point; a row stopped by the cap
                # keeps the point of its last linearisation (no relaxation)
                keep = done_prev | done | last
                XiLast = torch.where(keep[:, None, None], XiLast,
                                     0.2 * XiLast + 0.8 * Xi)
                n_real = n_real + (~done_prev).to(torch.int32)
                done_prev = done_prev | done
                it += 1
            # the stop test: one host sync per SCAN_CHUNK trips
            if bool(done_prev.all()):  # raft-lint: disable=host-coercion (stop test)
                break
    if timer is not None:
        timer("fixed_point")

    if ad.differentiated(*params):
        keep = linsolve.Keep()
        Xi_u, Z_u, _ = update(XiLast, params, keep)
        XiLast = _FixedPointRoot.apply(XiLast, Xi_u, Z_u,
                                       FixedPointState(lin, keep),
                                       *loop_params)
    Xi, Z, Bmat = update(XiLast, params)
    # reductions over the trailing dims, never through flatten: a
    # flatten copies or views by the layout of the solve's output, which
    # differs between the kernel and its plain version
    tolCheck = torch.amax(torch.abs(Xi - XiLast) / (torch.abs(Xi) + TOL),
                          dim=(1, 2))
    drag_converged = tolCheck < TOL
    finite = torch.all(torch.isfinite(torch.view_as_real(Xi)),
                       dim=(1, 2, 3))
    status = torch.zeros(R, dtype=torch.int32, device=dev)
    status = health.set_bit(status, health.DRAG_CAP_HIT,
                            (~drag_converged).to(torch.int32))
    status = health.set_bit(status, health.NONFINITE_INTERMEDIATE,
                            (~finite).to(torch.int32))
    if config.get("COND_CHECK"):
        cond_Z = torch.amax(linsolve.cond_estimate(Z.detach()), dim=-1)
        status = health.set_bit(
            status, health.ILL_CONDITIONED_Z,
            (cond_Z > config.get("COND_THRESHOLD")).to(torch.int32))
    else:
        cond_Z = torch.zeros(R, dtype=rdt, device=dev)
    return Z, Xi, Bmat, dict(drag_resid=tolCheck,
                             drag_converged=drag_converged,
                             n_iter_drag=n_real, cond_Z=cond_Z,
                             status=status, Xi_lin=XiLast.detach(),
                             trips=it)


def system_response(Z_sys, F_waves):
    """Response to each excitation: Z_sys (..., nw, n, n) against
    F_waves (..., n, nw) -> Xi (..., n, nw), one batched solve."""
    Xi = linsolve.solve(Z_sys, F_waves.transpose(-1, -2))
    return Xi.transpose(-1, -2)

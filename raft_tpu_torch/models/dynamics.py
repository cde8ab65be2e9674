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

Reverse mode is the implicit backward of the reference's
``lax.custom_root`` at the fixed point, the transpose of its Neumann
``tangent_solve``: the trip loop runs without a graph, the graph of one
``update(XiLast)`` is built, and :class:`_FixedPointRoot` turns a
cotangent X_bar of the fixed point into ``lam`` by exactly 10 steps of
``lam <- X_bar + vjp_Xi(update)(lam)`` on that one graph (not to
convergence: the reference takes 10), then hands ``lam`` to the graph,
so ``theta_bar = vjp_theta(update)(lam)``.  Each step's vjp passes the
solve's backward, the adjoint kernel on the card.  The final
``update`` at the fixed point stays differentiable directly.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import linsolve
from raft_tpu_torch.physics import morison
from raft_tpu_torch.utils import config, health
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
#: Neumann steps of the fixed point's backward (the reference's
#: tangent_solve takes 10)
NEUMANN_STEPS = 10


class _FixedPointRoot(torch.autograd.Function):
    """The fixed point XiLast attached to ``Xi_u = update(Xl)``, the one
    graph of the update at ``Xl`` (a leaf of XiLast's value)."""

    @staticmethod
    def forward(ctx, XiLast, Xi_u, Xl):
        ctx.graph = (Xi_u, Xl)
        return XiLast.clone()

    @staticmethod
    def backward(ctx, X_bar):
        Xi_u, Xl = ctx.graph
        lam = X_bar
        for _ in range(NEUMANN_STEPS):
            lam = X_bar + torch.autograd.grad(Xi_u, Xl, lam,
                                              retain_graph=True)[0]
        return None, lam, None


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

    def update(XiLast):
        out = morison.drag_lin_iter(pre, XiLast)
        Z = Z0 + iw[:, None, None] * out["B_hydro_drag"][:, None, :, :]
        F = F_lin + out["F_hydro_drag"]
        Xi = linsolve.solve(Z, F.transpose(-1, -2))
        return Xi.transpose(-1, -2), Z, out["Bmat"]

    iter_scale = max(int(config.get("ITER_SCALE")), 1)
    cap = n_iter * iter_scale + 1 + max(int(n_iter_extra), 0)
    chunk = min(max(1, config.get("SCAN_CHUNK")), cap)

    XiLast = torch.full((R, nDOF, nw), Xi_start, dtype=cdt, device=dev)
    done_prev = torch.zeros(R, dtype=torch.bool, device=dev)
    n_real = torch.zeros(R, dtype=torch.int32, device=dev)
    it = 0
    with torch.no_grad():
        while it < cap:
            for _ in range(min(chunk, cap - it)):
                Xi, _, _ = update(XiLast)
                tolCheck = torch.abs(Xi - XiLast) / (torch.abs(Xi) + TOL)
                done = torch.all((tolCheck < TOL).flatten(1), dim=1)
                last = it + 1 >= cap
                # a finished row keeps its point; a row stopped by the cap
                # keeps the point of its last linearisation (no relaxation)
                keep = done_prev | done | last
                XiLast = torch.where(keep[:, None, None], XiLast,
                                     0.2 * XiLast + 0.8 * Xi)
                n_real = n_real + (~done_prev).to(torch.int32)
                done_prev = done_prev | done
                it += 1
            if bool(done_prev.all()):
                break
    if timer is not None:
        timer("fixed_point")

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Z0, F_lin, *pre.values())
            if isinstance(t, torch.Tensor)):
        Xl = XiLast.detach().requires_grad_()
        Xi_u, _, _ = update(Xl)
        XiLast = _FixedPointRoot.apply(XiLast, Xi_u, Xl)
    Xi, Z, Bmat = update(XiLast)
    tolCheck = torch.amax((torch.abs(Xi - XiLast)
                           / (torch.abs(Xi) + TOL)).flatten(1), dim=1)
    tolCheck = tolCheck.detach()
    drag_converged = tolCheck < TOL
    finite = torch.all(torch.isfinite(torch.view_as_real(Xi)).flatten(1),
                       dim=1)
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

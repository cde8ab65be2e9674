"""Quasi-static catenary mooring (torch counterpart of the main-path
subset of ``raft_tpu/physics/mooring.py``): the inline-schema builder,
the catenary solve and the body force and stiffness.

Every function is elementwise over any batch of lines (rows x lines on
the bucket path), so one call solves every line of every row.  The
reference's guards are kept exactly: ``_profile`` clamps ``HF``, and a
Newton step that is not finite is rejected.

The bucket's mooring stiffness is the reference's ``-jax.jacfwd`` of
the line force: forward-mode AD *through* the 60-step catenary Newton
loop, not an implicit derivative.  Two functions compute it through the
same loop:

* :func:`stiffness_jacfwd`, the reference's form: ``-torch.func.jacfwd``
  of the masked force, vmapped over rows;
* :func:`line_forces_and_stiffness`, the bucket path's: the same six
  tangents carried by hand as :class:`Dual` numbers, one plain op per
  tangent op, without ``torch.func``'s per-op dispatch through its
  transform layers (``chip_smoke.py`` times both on the card and holds
  one against the other).

Two parts of the loop carry no tangent and run on primal values only in
the :class:`Dual` form: the backtracking search, whose output is a step
length from {1, 1/2, ..., 1/16}, and the finiteness test.  The Newton
Jacobian of the profile is written out analytically in both.

Reverse mode does not tape the Newton loop.  :func:`line_forces_at_root`
takes the converged fairlead loads (HF, VF) and attaches them to the
pose and to L, w, EA by the implicit rule at the root, with the 2 x 2
profile Jacobian; the force and stiffness written from them have the
forward's values (to rounding) and exact first derivatives there.
:func:`line_forces_and_stiffness` returns the forward's values with
those derivatives whenever an input requires grad.  The reference tapes
its loop, so the two gradients agree to the catenary's convergence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops.dual import Dual
from raft_tpu_torch.ops.dual import abs_ as _abs
from raft_tpu_torch.ops.dual import asinh as _asinh
from raft_tpu_torch.ops.dual import clamp_min as _clamp_min
from raft_tpu_torch.ops.dual import maximum as _maximum
from raft_tpu_torch.ops.dual import sqrt as _sqrt
from raft_tpu_torch.ops.dual import tanh as _tanh
from raft_tpu_torch.ops.dual import value as _v
from raft_tpu_torch.ops.dual import where as _where
from raft_tpu_torch.structure.schema import coerce


@dataclass(frozen=True)
class MooringSystem:
    """One body's quasi-static catenary mooring: numpy arrays from
    :func:`build_mooring`, or tensors on the evaluating device (``L``
    may then carry a leading row axis, one line-length set per row)."""

    r_anchor: object        # (nL, 3) fixed anchor coordinates
    r_fair0: object         # (nL, 3) fairlead coordinates at zero pose
    L: object               # (nL,) or (R, nL) unstretched lengths
    w: object               # (nL,) submerged weight per length [N/m]
    EA: object              # (nL,) axial stiffness [N]
    depth: float
    moorMod: int = 0

    @property
    def n_lines(self):
        return self.r_anchor.shape[0]

    def to(self, device, dtype=torch.float64):
        """The same system with every line array a tensor on ``device``."""
        kw = dict(dtype=dtype, device=device)
        return MooringSystem(
            **{k: torch.as_tensor(np.asarray(getattr(self, k)), **kw)
               for k in ("r_anchor", "r_fair0", "L", "w", "EA")},
            depth=self.depth, moorMod=self.moorMod)


def build_mooring(mooring, rho_water=1025.0, g=9.81, x_ref=0.0, y_ref=0.0,
                  heading_adjust=0.0):
    """Parse the design's inline ``mooring`` section (points / lines /
    line_types) into a :class:`MooringSystem` (counterpart of
    ``raft_tpu/physics/mooring.py:65-133``).

    Submerged weight per length w = (m' - rho pi/4 d^2) g with d the
    volume-equivalent diameter (MoorPy convention).  ``x_ref/y_ref`` and
    ``heading_adjust`` move the anchors to the FOWT's array position.
    Line dynamics (``moorMod`` 1 or 2) are not ported and raise."""
    moorMod = int(coerce(mooring, "moorMod", default=0, dtype=int))
    if moorMod != 0:
        raise NotImplementedError(
            f"moorMod {moorMod}: mooring line dynamics are not ported "
            "(ROADMAP A10); only the quasi-static catenary (moorMod 0) is")
    depth = float(coerce(mooring, "water_depth", default=600.0))
    types = {lt["name"]: lt for lt in mooring["line_types"]}
    points = {p["name"]: p for p in mooring["points"]}

    r_anchor, r_fair, L, w, EA = [], [], [], [], []
    for line in mooring["lines"]:
        pA = points[line["endA"]]
        pB = points[line["endB"]]
        # orient so end A is the fixed anchor
        if pA["type"] == "fixed":
            anchor, fair = pA, pB
        else:
            anchor, fair = pB, pA
        lt = types[line["type"]]
        d = float(lt["diameter"])
        m_lin = float(lt["mass_density"])
        r_anchor.append(np.array(anchor["location"], dtype=float))
        r_fair.append(np.array(fair["location"], dtype=float))
        L.append(float(line["length"]))
        w.append((m_lin - rho_water * np.pi / 4 * d**2) * g)
        EA.append(float(lt["stiffness"]))

    r_anchor = np.array(r_anchor)
    r_fair = np.array(r_fair)
    if heading_adjust != 0.0:
        c, s = np.cos(np.deg2rad(heading_adjust)), np.sin(np.deg2rad(heading_adjust))
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        r_anchor = r_anchor @ Rz.T
        r_fair = r_fair @ Rz.T
    r_anchor = r_anchor + np.array([x_ref, y_ref, 0.0])
    # fairleads stay body-local (the body pose carries x_ref/y_ref)
    return MooringSystem(r_anchor=np.array(r_anchor), r_fair0=np.array(r_fair),
                         L=np.array(L), w=np.array(w), EA=np.array(EA),
                         depth=depth, moorMod=moorMod)


def _profile(HF, VF, L, w, EA):
    """Horizontal/vertical fairlead-anchor spans (XF, ZF) of an elastic
    catenary with fairlead loads (HF, VF) over a flat frictionless
    seabed (anchor lines: grounded when VF < w L)."""
    HF = _clamp_min(HF, 1e-8)
    t1 = VF / HF
    s1 = _sqrt(1.0 + t1 * t1)
    asinh1 = _asinh(t1)

    LB = L - VF / w
    XF_g = LB + (HF / w) * asinh1 + HF * L / EA
    ZF_g = (HF / w) * (s1 - 1.0) + VF * VF / (2.0 * EA * w)

    VA = VF - w * L
    t2 = VA / HF
    s2 = _sqrt(1.0 + t2 * t2)
    asinh2 = _asinh(t2)
    XF_s = (HF / w) * (asinh1 - asinh2) + HF * L / EA
    ZF_s = (HF / w) * (s1 - s2) + (VF * L - 0.5 * w * L * L) / EA

    grounded = _v(VF) < w * L
    return _where(grounded, XF_g, XF_s), _where(grounded, ZF_g, ZF_s)


def _profile_jacobian(HF, VF, L, w, EA):
    """d(XF, ZF)/d(HF, VF) of :func:`_profile`, written out (the
    reference takes it by forward-mode AD): (dX/dHF, dX/dVF, dZ/dHF,
    dZ/dVF)."""
    m = _v(HF) > 1e-8                      # the HF clamp passes d/dHF
    h = _clamp_min(HF, 1e-8)
    t1 = VF / h
    s1 = _sqrt(1.0 + t1 * t1)
    a1 = _asinh(t1)
    VA = VF - w * L
    t2 = VA / h
    s2 = _sqrt(1.0 + t2 * t2)
    a2 = _asinh(t2)
    r1 = t1 / s1
    r2 = t2 / s2
    xh_g = a1 / w - r1 / w + L / EA
    xv_g = (1.0 / s1 - 1.0) / w
    zh_g = (s1 - 1.0) / w - t1 * r1 / w
    zv_g = r1 / w + VF / (EA * w)
    xh_s = (a1 - a2) / w - (r1 - r2) / w + L / EA
    xv_s = (1.0 / s1 - 1.0 / s2) / w
    zh_s = (s1 - s2) / w - (t1 * r1 - t2 * r2) / w
    zv_s = (r1 - r2) / w + L / EA
    grounded = _v(VF) < w * L
    zero = torch.zeros_like(_v(HF))
    return (_where(m, _where(grounded, xh_g, xh_s), zero),
            _where(grounded, xv_g, xv_s),
            _where(m, _where(grounded, zh_g, zh_s), zero),
            _where(grounded, zv_g, zv_s))


def solve_catenary(XF, ZF, L, w, EA, n_iter=60):
    """(HF, VF, HA, VA) such that the catenary spans (XF, ZF).

    Damped Newton from the MoorPy-style seed, ``n_iter`` fixed steps,
    each backtracked by up to 4 halvings until the residual norm does
    not grow; non-finite steps are rejected.  All arguments broadcast;
    ``XF``/``ZF`` may be :class:`Dual` (the tangents then run through
    every step).
    """
    XF = _clamp_min(XF, 1e-6)
    lr = _sqrt(XF * XF + ZF * ZF)
    taut = L <= _v(lr)
    arg = _clamp_min(3.0 * ((L * L - ZF * ZF) / (XF * XF) - 1.0), 1e-12)
    lam = _sqrt(arg)
    HF_slack = _clamp_min(_abs(0.5 * w * XF / lam), 1e-3)
    VF_slack = 0.5 * w * (ZF / _tanh(lam) + L)
    T0 = _maximum(EA * (lr - L) / L, w * L)
    HF_taut = T0 * XF / lr
    VF_taut = T0 * ZF / lr + 0.5 * w * L
    HF = _where(taut, HF_taut, HF_slack)
    VF = _where(taut, VF_taut, VF_slack)
    XFv, ZFv = _v(XF), _v(ZF)

    for _ in range(n_iter):
        x, z = _profile(HF, VF, L, w, EA)
        r0, r1 = x - XF, z - ZF
        j00, j01, j10, j11 = _profile_jacobian(HF, VF, L, w, EA)
        det = j00 * j11 - j01 * j10
        det = _where(torch.abs(_v(det)) < 1e-30, 1e-30, det)
        dH = -(r0 * j11 - r1 * j01) / det
        dV = -(j00 * r1 - j10 * r0) / det

        # backtracking on primal values: the step length it picks is a
        # constant (zero tangent)
        Hv, Vv, dHv, dVv = _v(HF), _v(VF), _v(dH), _v(dV)
        r0v, r1v = _v(r0), _v(r1)
        rn0 = torch.sqrt(r0v * r0v + r1v * r1v)
        alpha = torch.ones_like(Hv)
        for _ in range(4):
            x2, z2 = _profile(torch.clamp(Hv + alpha * dHv, min=1e-6),
                              Vv + alpha * dVv, L, w, EA)
            x2, z2 = x2 - XFv, z2 - ZFv
            worse = torch.sqrt(x2 * x2 + z2 * z2) > rn0
            alpha = torch.where(worse, 0.5 * alpha, alpha)
        HF2 = _clamp_min(HF + alpha * dH, 1e-6)
        VF2 = VF + alpha * dV
        ok = torch.isfinite(_v(HF2)) & torch.isfinite(_v(VF2))
        HF = _where(ok, HF2, HF)
        VF = _where(ok, VF2, VF)
    grounded = _v(VF) < w * L
    VA = _where(grounded, torch.zeros_like(_v(VF)), VF - w * L)
    return HF, VF, HF, VA


def _fairlead_geometry(r_fair0, r_anchor, r6):
    """Fairlead positions and the catenary spans at pose ``r6``:
    (XF, ZF, u_h (..., nL, 2), lever arm r_fair - r6[:3] (..., nL, 3))."""
    R = tf.rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    r_fair = r6[..., None, :3] + r_fair0 @ R.transpose(-1, -2)
    dvec = r_fair - r_anchor
    XF = torch.sqrt(dvec[..., 0] ** 2 + dvec[..., 1] ** 2)
    u_h = dvec[..., :2] / torch.clamp(XF, min=1e-8)[..., None]
    return XF, dvec[..., 2], u_h, r_fair - r6[..., None, :3]


def catenary_line_forces(r_fair0, r_anchor, L, w, EA, r6):
    """Per-line 6-DOF fairlead forces about the body origin at pose
    ``r6``, plus per-line tension components.

    r_fair0, r_anchor : (..., nL, 3); L, w, EA : (..., nL);
    r6 : (..., 6).  Returns (F6 (..., nL, 6), dict(HF, VF, HA, VA)).
    """
    XF, ZF, u_h, lever = _fairlead_geometry(r_fair0, r_anchor, r6)
    HF, VF, HA, VA = solve_catenary(XF, ZF, L, w, EA)
    F_fair = torch.cat([-HF[..., None] * u_h, -VF[..., None]], dim=-1)
    F6 = tf.translate_force_3to6(F_fair, lever)
    return F6, dict(HF=HF, VF=VF, HA=HA, VA=VA)


def _force_comps(HF, VF, ux, uy, lx, ly, lz, mask):
    """Masked 6-DOF force and ``C = -dF/dX`` from the per-line loads and
    fairlead geometry as :class:`Dual` numbers whose tangents run along
    the 6 pose directions: (F (R, 6), C (R, 6, 6))."""
    fx, fy, fz = -HF * ux, -HF * uy, -VF
    # translate_force_3to6: [F, lever x F], written per component
    comps = (fx, fy, fz, ly * fz - lz * fy, lz * fx - lx * fz,
             lx * fy - ly * fx)
    F = torch.stack([torch.sum(torch.where(mask, c.v, 0.0), dim=-1)
                     for c in comps], dim=-1)
    dF = torch.stack([torch.sum(torch.where(mask, c.t, 0.0), dim=-1)
                      for c in comps], dim=-1)          # (6 dirs, R, 6)
    return F, -dF.permute(1, 2, 0)


def _geometry_duals(r_fair0, r_anchor, X):
    """The fairlead geometry at poses X (R, 6) as :class:`Dual` numbers
    with tangents along the 6 pose directions (forward mode through the
    geometry: ``torch.func.jacfwd`` with respect to a perturbation shared
    by all rows, exact because rows do not interact)."""
    def geometry(delta):
        out = _fairlead_geometry(r_fair0, r_anchor, X + delta)
        return out, out

    jac, (XF, ZF, u_h, lever) = torch.func.jacfwd(geometry, has_aux=True)(
        torch.zeros(6, dtype=X.dtype, device=X.device))
    return tuple(Dual(v, t.movedim(-1, 0)) for v, t in (
        (XF, jac[0]), (ZF, jac[1]),
        (u_h[..., 0], jac[2][..., 0, :]), (u_h[..., 1], jac[2][..., 1, :]),
        (lever[..., 0], jac[3][..., 0, :]),
        (lever[..., 1], jac[3][..., 1, :]),
        (lever[..., 2], jac[3][..., 2, :])))


def loop_forces(r_fair0, r_anchor, L, w, EA, mask, X):
    """(F, C, HF, VF) by forward mode through the geometry and the whole
    catenary Newton loop: :func:`line_forces_and_stiffness`' values (a
    forward-mode transform of this function differentiates through the
    loop, as the reference does)."""
    XF, ZF, ux, uy, lx, ly, lz = _geometry_duals(r_fair0, r_anchor, X)
    HF, VF, _, _ = solve_catenary(XF, ZF, L, w, EA)
    F, C = _force_comps(HF, VF, ux, uy, lx, ly, lz, mask)
    return F, C, HF.v, VF.v


def line_forces_and_stiffness(r_fair0, r_anchor, L, w, EA, mask, X,
                              root=False):
    """Masked mooring force and stiffness of a batch of rows.

    r_fair0, r_anchor : (R, nL, 3); L, w, EA : (R, nL); mask : (R, nL)
    bool; X : (R, 6).  Returns (F (R, 6), C (R, 6, 6)) with
    ``C = -dF/dX``: forward mode through the fairlead geometry and then,
    as :class:`Dual` tangents, through the whole catenary Newton loop.
    With ``root`` it also returns the converged loads (HF, VF) (R, nL).

    When grad is enabled and an input requires it, F and C keep these
    values and take their derivatives from :func:`line_forces_at_root`
    at the converged loads (the Newton loop is not taped).
    """
    with torch.no_grad():
        F, C, HF, VF = loop_forces(r_fair0, r_anchor, L, w, EA, mask, X)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r_fair0, r_anchor, L, w, EA, X)):
        F_r, C_r = line_forces_at_root(r_fair0, r_anchor, L, w, EA, mask, X,
                                       HF, VF)
        F = F + (F_r - F_r.detach())
        C = C + (C_r - C_r.detach())
    return (F, C, (HF, VF)) if root else (F, C)


def line_forces_at_root(r_fair0, r_anchor, L, w, EA, mask, X, HF, VF):
    """(F (R, 6), C (R, 6, 6)) written from the converged fairlead loads
    HF, VF (R, nL) of the pose X, differentiable in X and in the line
    properties by the implicit rule.

    With r(H, V) = profile(H, V; L, w, EA) - (XF, ZF) and J its 2 x 2
    Jacobian in (H, V) at the root, the loads are attached as
    ``H* + (c - stop_grad(c))`` with ``c = -J^-1 r`` and J held
    constant: their value is H*, their derivative ``-J^-1 dr``, the
    implicit derivative.  The pose tangents of (H, V) are
    ``J^-1 d(XF, ZF)/dX`` with J written from the attached loads, so the
    stiffness is differentiable too (its derivative is the second
    derivative of the force at the root)."""
    XF, ZF, ux, uy, lx, ly, lz = _geometry_duals(r_fair0, r_anchor, X)
    Hs, Vs = HF.detach(), VF.detach()
    x, z = _profile(Hs, Vs, L, w, EA)
    r0, r1 = x - XF.v, z - ZF.v
    with torch.no_grad():
        j00, j01, j10, j11 = _profile_jacobian(Hs, Vs, L, w, EA)
        det = j00 * j11 - j01 * j10
    cH = -(r0 * j11 - r1 * j01) / det
    cV = -(j00 * r1 - j10 * r0) / det
    H = Hs + (cH - cH.detach())
    V = Vs + (cV - cV.detach())
    j00, j01, j10, j11 = _profile_jacobian(H, V, L, w, EA)
    det = j00 * j11 - j01 * j10
    tH = (j11 * XF.t - j01 * ZF.t) / det
    tV = (j00 * ZF.t - j10 * XF.t) / det
    return _force_comps(Dual(H, tH), Dual(V, tV), ux, uy, lx, ly, lz, mask)


def stiffness_jacfwd(r_fair0, r_anchor, L, w, EA, mask, X):
    """:func:`line_forces_and_stiffness` in the reference's form: the
    masked line-force sum of one row and ``C = -torch.func.jacfwd`` of
    it through the catenary Newton loop, vmapped over rows.  Same
    arguments and returns."""
    def force(fair0, anchor, L, w, EA, mask, x):
        F6, _ = catenary_line_forces(fair0, anchor, L, w, EA, x)
        F = torch.sum(torch.where(mask[:, None], F6, 0.0), dim=0)
        return F, F

    dF, F = torch.func.vmap(torch.func.jacfwd(force, argnums=6,
                                              has_aux=True))(
        r_fair0, r_anchor, L, w, EA, mask, X)
    return F, -dF


def line_args(ms, X):
    """(r_fair0, r_anchor, L, w, EA, mask) of every line of ``ms`` as
    (R, nL, ...) tensors for poses X (R, 6); the arrays of ``ms`` may
    carry a leading row axis."""
    R = X.shape[0]
    kw = dict(dtype=X.dtype, device=X.device)

    def rows(a, tail):
        t = torch.as_tensor(a, **kw)
        return t if t.dim() > tail else t.expand((R,) + t.shape)

    L = rows(ms.L, 1)
    mask = torch.ones(L.shape, dtype=torch.bool, device=X.device)
    return (rows(ms.r_fair0, 2), rows(ms.r_anchor, 2), L, rows(ms.w, 1),
            rows(ms.EA, 1), mask)


def mooring_force_and_stiffness(ms, X):
    """(F (R, 6), C (R, 6, 6)) of every line of ``ms`` at poses X (R, 6),
    through :func:`line_forces_and_stiffness` with every line counted."""
    return line_forces_and_stiffness(*line_args(ms, X), X)


def mooring_force(ms, r6):
    """Net 6-DOF line force on the body at poses r6 (R, 6) about the body
    origin -> (R, 6)."""
    return mooring_force_and_stiffness(ms, r6)[0]


def mooring_stiffness(ms, r6):
    """Coupled mooring stiffness ``C = -dF/dr6`` at poses r6 (R, 6) ->
    (R, 6, 6): forward mode through the catenary Newton loop."""
    return mooring_force_and_stiffness(ms, r6)[1]
